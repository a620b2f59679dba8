"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

from collections import Counter

LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
