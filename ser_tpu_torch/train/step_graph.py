"""The train step as CUDA graphs: one whole optimizer step (forward, masked
loss, backward and Adam) captured once per key and replayed for every later
step of that key, so the host launches one graph a step in place of the
step's ~12 k kernels one at a time.

- ``engages``: whether a trainer's steps run as graphs. Only on the card, in
  one process, in f32, without the NaN checks, the InfoNCE term or a zoo
  encoder op, and for a model that declares that its train forward makes no
  host sync (``train_graph_safe``). Every other case runs the eager step.
- ``graph_key``: ``(L, B, P, input width, dropout rates)``. The rates are
  every ``Dropout.p`` and every float ``dropout_rate`` and ``attn_dropout``
  of the model's modules: a graph captured at one rate is never replayed
  at another.
- ``StepGraphs``: a trainer's graphs, at most ``MAX_GRAPHS`` (the least
  recently used one dropped), one memory pool for all of them (replays are
  serial on one stream) and the static inputs, allocated for the largest
  shape seen, of which each graph reads a leading view. At the first sight
  of a key the step runs eagerly on the capture stream (the capture's
  warm-up, and a real step), then is captured. A replay draws fresh dropout
  masks and a fresh rank-1 seed from the trainer's generator, registered
  with every graph, so saving and restoring the generator's state still
  restores the stream. The caller drops the graphs (``clear``) whenever
  what they captured is replaced: the optimizer or its state, or the
  generator's state.

No kernel runs while capturing, so the kernel counters' rise across a
capture is taken back and added at each replay (``ops.kernels.LAUNCHES``).
"""

from __future__ import annotations

import math
from collections import Counter, OrderedDict

import torch

from ser_tpu_torch.ops.kernels import LAUNCHES
from ser_tpu_torch.ops.layers import Dropout
from ser_tpu_torch.utils import profiling

MAX_GRAPHS = 8  # the loader buckets L, so a run meets a few shapes


def engages(device: torch.device, processes: int, compute_dtype: torch.dtype,
            infonce: float, encoder_attention: str, model: torch.nn.Module) -> bool:
    """Whether a train step runs as a CUDA graph. A zoo encoder op is not
    vouched for, whatever the model declares."""
    return (device.type == "cuda" and processes == 1 and compute_dtype is torch.float32
            and infonce == 0 and encoder_attention == "mha"
            and not profiling.nan_checks_enabled()
            and bool(getattr(model, "train_graph_safe", False)))


def dropout_rates(model: torch.nn.Module) -> tuple:
    """Every rate a train step of ``model`` drops at, in module order."""
    rates = []
    for m in model.modules():
        if isinstance(m, Dropout):
            rates.append(m.p)
        for attr in ("dropout_rate", "attn_dropout"):
            value = getattr(m, attr, None)
            if isinstance(value, float):
                rates.append(value)
    return tuple(rates)


def graph_key(x_shape, parties: int, model: torch.nn.Module) -> tuple:
    """``(L, B, P, input width, dropout rates)`` of a step on x ``[L, B,
    width]`` over ``parties``."""
    L, B, width = x_shape
    return (L, B, parties, width, dropout_rates(model))


class StepGraph:
    """One captured step: the graph, its static loss, the parameters and
    the gradients its backward writes (None for a dead parameter), and the
    kernel launches it holds."""

    def __init__(self, graph, loss, params, grads, launches: Counter):
        self.graph, self.loss = graph, loss
        self.params, self.grads = params, grads
        self.launches = launches

    def replay(self) -> torch.Tensor:
        """One replay on the static inputs; ``.grad`` then holds its
        gradients. Returns a clone of its loss, so each step's is its own."""
        with profiling.annotate("ser#graph.replay"):
            self.graph.replay()
        LAUNCHES.update(self.launches)
        for p, g in zip(self.params, self.grads):
            p.grad = g
        return self.loss.clone()


class StepGraphs:
    """A trainer's step graphs on ``device``, drawing their dropouts from
    ``generator``. The capture stream and the memory pool are made at the
    first capture, and a new pool after ``clear``."""

    def __init__(self, device: torch.device, generator: torch.Generator):
        self.device, self.generator = device, generator
        self.graphs: OrderedDict[tuple, StepGraph] = OrderedDict()
        self.buffers: dict[str, torch.Tensor] = {}  # name -> flat static input
        self.stream = self.pool = None

    def clear(self) -> None:
        """Drop every graph. Their pool is left to the allocator, which frees
        it once nothing holds its memory; the next capture takes a new one,
        since the allocator refuses a pool that no graph holds."""
        self.graphs.clear()
        self.pool = None

    def inputs(self, like: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Static inputs of the shapes and dtypes of ``like``'s tensors:
        leading views of one flat buffer a name, which grows (dropping the
        graphs that read the old one) where a shape needs more."""
        views = {}
        for name, t in like.items():
            n = math.prod(t.shape)
            buf = self.buffers.get(name)
            if buf is None or buf.numel() < n or buf.dtype != t.dtype:
                self.clear()
                buf = self.buffers[name] = torch.empty(n, dtype=t.dtype, device=self.device)
            views[name] = buf[:n].view(t.shape)
        return views

    def step(self, key: tuple, params: list, run) -> torch.Tensor:
        """The step ``run()`` (which returns its loss) on the static inputs:
        a replay of ``key``'s graph, or at the key's first sight ``run()``
        eagerly on the capture stream, then its capture."""
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            return graph.replay()
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            loss = run()
        grads = [p.grad for p in params]
        self.graphs[key] = self._capture(run, params)
        if len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        for p, g in zip(params, grads):  # the eager step's, not the capture's
            p.grad = g
        main.wait_stream(self.stream)
        loss.record_stream(main)
        return loss

    def _capture(self, run, params) -> StepGraph:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = Counter(LAUNCHES)
        # capture_begin and capture_end themselves: torch.cuda.graph would
        # also synchronise and empty the allocator's cache at each capture,
        # which the next steps pay for in fresh allocations
        with profiling.annotate("ser#graph.capture"), torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                loss = run()
            finally:
                graph.capture_end()
        launches = LAUNCHES - before
        LAUNCHES.subtract(launches)
        return StepGraph(graph, loss, params, [p.grad for p in params], launches)
