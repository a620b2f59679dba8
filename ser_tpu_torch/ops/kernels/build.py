"""Build ``ser_tpu_torch/csrc/*.cu`` with nvcc, and the host C sources
(``ser_tpu_torch/native/*.c``) with cc, for loading with ctypes.

Each source compiles on first use into a shared library with a plain C
interface, under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``). The library's name carries a hash of the source and the
flags, so an edited source is rebuilt; it is written under a temporary name
and moved into place with ``os.replace``, so processes building at once
never load a partial file. There is no fallback: without nvcc, or cc, or
when the compiler fails, this raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CC_FLAGS = ("-O3", "-shared", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _hashed(src: Path, flags) -> Path:
    """The library of ``src`` built with ``flags``, named by their hash."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _tmp(so: Path) -> Path:
    return so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")


def library_path(name: str) -> Path:
    return _hashed(CSRC / f"{name}.cu", NVCC_FLAGS)


def build_c(src: Path) -> Path:
    """The shared library of the host C source ``src``, compiled with ``cc
    -O3 -shared -fPIC`` if it is not built yet. A missing or failing
    compiler raises ``RuntimeError`` naming the command."""
    so = _hashed(src, CC_FLAGS)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp(so)
    cmd = ["cc", *CC_FLAGS, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)} could not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def build(names: list[str]) -> dict[str, str]:
    """Compile every source in ``names`` that is not built yet, one nvcc
    process each, all started together. Returns nvcc's output per source
    (register and shared-memory use from ``-Xptxas -v``), kept beside each
    library for a source built before."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, logs = {}, {}
    for name in names:
        so = library_path(name)
        if so.exists():
            log = so.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = _tmp(so)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    for name, (proc, tmp, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
