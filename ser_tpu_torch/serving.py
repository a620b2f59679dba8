"""The port's eval forward as a server object, and its serving artifacts.

``Predictor`` is the counterpart of the eval forward behind the JAX
package's ``predict.py`` (``ModelTrainer.eval_network``): it owns one model
on its device in eval mode and answers padded requests, either as model
inputs (``predict``) or as a collated batch (``predict_batch``), which may
carry raw waveforms for the on-device audio front end.

``export_model`` / ``save_model`` and ``ServingModel`` are the counterparts
of ``ser_tpu/serving.py``'s. A JAX artifact carries one ``jax.export``
program a shape bucket, which torch cannot run, so the port's artifact
carries the weights and the shapes and ``ServingModel`` rebuilds the model
from the port's registry. The file is ``SERT`` + ``<I`` header length +
the JSON header + ``<Q`` length + the weights section, the JAX ``SER2``
layout without its program sections. The header has the JAX header's keys
in its vocabulary (``logp_layout`` ``"bl"`` or ``"tb"``, ``inputs``
``"marn1"`` or ``"trimodal"``); ``platforms`` is always ``["cuda",
"cpu"]``, where the artifact runs. A zoo ``--encoder_attention`` kind is
recorded as ``encoder_attention``; a header without the field (the JAX
package's, or one of the reference MHA's) is ``"mha"``, and a loaded header
must name the kind its weights' names hold. The weights
section is JAX's v3 one:
the model's parameters under their JAX names (``compat.from_jax.
to_jax_params``), sorted by name, raw bytes in ``params.leaves``' order,
f32, bf16 (rounded to nearest even) or int8 (weights-only, per output
channel, in the JAX layout: a leaf ``<name>/q`` int8 and ``<name>/s`` f32).
For the same weights it is the JAX artifact's section byte for byte.
``ServingModel.load`` also reads the JAX package's ``SER2`` v3 artifacts
(their weights section; the programs are skipped); their header has no
kind, which the weights' names under ``slf_attn/op/`` determine. bf16 and int8
artifacts compute under bf16 autocast with f32 in and out: the weights are
the artifact's bf16 values (int8 dequantized once at load, as ``q.bf16 *
s.bf16``), and the hand-written kernels run in f32 on them.

On the card each shape bucket is served from a CUDA graph of its forward,
captured at the bucket's first request; a capture that fails raises. On
the CPU the forward runs eagerly.
"""

from __future__ import annotations

import json
import math
import struct
from collections import Counter

import numpy as np
import torch

from ser_tpu_torch.compat.from_jax import from_jax_params, to_jax_params
from ser_tpu_torch.data.frontend import make_frontend
from ser_tpu_torch.device import resolve_device
from ser_tpu_torch.models.registry import (TRIMODAL_TEXT, _trimodal_inputs, build_model,
                                           get_model_spec)
from ser_tpu_torch.ops.encoder_attention import encoder_attention_of
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.ops.kernels import LAUNCHES
from ser_tpu_torch.utils import profiling

MAGIC = b"SERT"
_JAX_MAGIC, _JAX_MAGIC_V1 = b"SER2", b"SER1"
DTYPES = ("f32", "bf16", "int8")
PLATFORMS = ("cuda", "cpu")
GRAPH_WARMUP = 2  # eager forwards of a bucket before its capture
_LEAF_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_LEAF_NAMES = {v: k for k, v in _LEAF_DTYPES.items()}


class Predictor:
    """A model on one device, answering padded requests.

    ``state_dict`` holds reference-layout weights (for example from
    ``compat.from_jax.from_jax_params``); without it the weights are the
    torch-default init drawn from ``seed``. ``device`` defaults to ``cuda``
    and raises where CUDA is missing, unless it is ``"cpu"``.
    ``audio_frontend`` (None or ``"mfcc"``) computes the audio slot from the
    ``wav`` field of a batch given to ``predict_batch``.
    ``encoder_attention`` is the encoders' self-attention kind
    (``--encoder_attention``; ``"mha"`` or a zoo op), which must be the one
    that ``state_dict`` was made with.
    """

    def __init__(self, model_name: str = "MARN1_onlysp", state_dict=None,
                 seed: int = 0, device=None, audio_frontend: str | None = None,
                 n_classes: int = 6, encoder_attention: str = "mha"):
        self.device = resolve_device(device)
        self.spec = get_model_spec(model_name)
        self.encoder_attention = encoder_attention
        model = build_model(model_name, generator(seed), n_classes, encoder_attention)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        # eval mode here; a trainer that shares the model switches it
        self.model = model.to(self.device).eval()
        self.frontend = make_frontend(audio_frontend)
        self.n_requests = 0

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _answer(self, x, qmask, umask):
        with profiling.annotate("ser#forward"):
            out = self.model(x, qmask, umask)
        logp = self.spec.extract_logp(out)
        labels = self.spec.grid(logp.argmax(-1), *umask.shape)
        self.n_requests += 1
        return logp, labels

    def predict(self, x, qmask, umask):
        """One padded request: x ``[L, B, D]`` as the model's ``make_inputs``
        gives it (1124 wide for IEMOCAP and 1324 for MELD, 712 for the
        trimodal models on IEMOCAP), qmask ``[L, B, P]`` (for MARN1_onlysp
        P = 2 or 9, a party count the recurrence kernel was compiled for),
        umask ``[B, L]``. Returns ``(logp [B*L, C], labels [B, L])`` on the
        predictor's device: logp's rows in the model's order
        (``ModelSpec.logp_layout``; time-major for MARN_AT and MARN_ATV),
        log-probabilities or, for the models that emit them,
        probabilities."""
        with profiling.annotate("ser#request"), torch.inference_mode():
            return self._answer(*(self._tensor(a) for a in (x, qmask, umask)))

    def batch_inputs(self, batch, dtype=torch.float32):
        """``(x, qmask, umask)`` on the device from one collated batch
        (``data.collate``), numpy arrays. With an audio front end and a
        ``wav`` field, the waveforms (and ``wav_len``) are copied to the
        device and the front end computes ``acouf`` there; otherwise the
        batch's ``acouf`` is used. The text views are averaged on the host,
        so one of them is copied, not four (with the visual features for the
        trimodal models). The caller picks the grad mode.

        ``dtype`` bf16 is the JAX bf16 step's cast batch: every float array
        rounded to bf16, the waveforms too before the front end, which
        computes in f32 and returns f32 features, so x, the text features
        joined with them, is f32 there, as the JAX package's concatenation
        promotes it."""
        with profiling.annotate("ser#inputs"):
            return self.device_inputs(batch, dtype)

    def device_inputs(self, batch, dtype=torch.float32):
        """``batch_inputs`` outside its span, for a caller that holds
        ``ser#inputs`` itself."""
        textf = self._tensor(self.spec.text_features(batch)).to(dtype)
        if self.frontend is not None and "wav" in batch:
            wav_len = batch.get("wav_len")
            acouf = self.frontend(
                self._tensor(batch["wav"]).to(dtype).float(),
                None if wav_len is None else self._tensor(wav_len, torch.int32))
        else:
            acouf = self._tensor(batch["acouf"]).to(dtype)
        return (self.spec.join_inputs(textf, acouf),
                self._tensor(batch["qmask"]).to(dtype),
                self._tensor(batch["umask"]).to(dtype))

    def predict_batch(self, batch):
        """One collated batch, as ``batch_inputs`` reads it. Returns what
        ``predict`` returns."""
        with profiling.annotate("ser#request"), torch.inference_mode():
            return self._answer(*self.batch_inputs(batch))


def _as_buckets(L, B):
    """Normalize (L, B) — each an int or a sequence — into sorted (L, B)
    bucket tuples, smallest padded area first (the selection order)."""
    Ls = [int(L)] if isinstance(L, int) else [int(x) for x in L]
    Bs = [int(B)] if isinstance(B, int) else [int(x) for x in B]
    return sorted({(l, b) for l in Ls for b in Bs},
                  key=lambda lb: (lb[0] * lb[1], lb[1], lb[0]))


def _quantize_int8(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Weights-only int8 of flat JAX-layout leaves: every float32 leaf with
    ndim >= 2 becomes ``<name>/q`` int8 and ``<name>/s`` float32 per-out-
    channel scales (symmetric, max-abs over all but the last axis / 127);
    1-d leaves stay f32. The JAX package's ``_quantize_int8``, step for
    step, so the bytes are its bytes."""
    out = {}
    for name, arr in flat.items():
        if arr.dtype != np.float32 or arr.ndim < 2:
            out[name] = arr
            continue
        red = tuple(range(arr.ndim - 1))
        s = np.max(np.abs(arr), axis=red, keepdims=True) / 127.0
        s = np.maximum(s, 1e-12).astype(np.float32)
        out[f"{name}/q"] = np.clip(np.round(arr / s), -127, 127).astype(np.int8)
        out[f"{name}/s"] = s
    return out


def _dequantize_int8(leaves: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``_quantize_int8``'s inverse as the JAX package's
    ``_dequantize_int8(params, bfloat16)`` computes it: ``q.bf16 * s.bf16``
    for each int8 pair, every other f32 leaf rounded to bf16."""
    out = {}
    for name, t in leaves.items():
        head, _, part = name.rpartition("/")
        pair = part in ("q", "s") and {f"{head}/q", f"{head}/s"} <= leaves.keys()
        if pair and leaves[f"{head}/q"].dtype == torch.int8:
            if part == "q":
                out[head] = t.to(torch.bfloat16) * leaves[f"{head}/s"].to(torch.bfloat16)
        else:
            out[name] = t.to(torch.bfloat16) if t.dtype == torch.float32 else t
    return out


def _weights_section(state_dict, dtype: str):
    """``(params.leaves, raw bytes)`` of a port state dict at ``dtype``."""
    flat = to_jax_params(state_dict)
    if dtype == "int8":
        flat = _quantize_int8(flat)
    leaves = {k: torch.from_numpy(v) for k, v in flat.items()}
    if dtype == "bf16":
        leaves = {k: v.to(torch.bfloat16) for k, v in leaves.items()}
    items = sorted(leaves.items())
    meta = [[k, list(v.shape), _LEAF_NAMES[v.dtype]] for k, v in items]
    raw = b"".join(v.contiguous().view(torch.uint8).numpy().tobytes() for _, v in items)
    return meta, raw


def _read_leaves(meta, data: bytearray, off: int, size: int) -> dict[str, torch.Tensor]:
    """The weights section's leaves, by name, from ``data[off:off + size]``."""
    leaves, start = {}, off
    for name, shape, dtype in meta:
        dt = _LEAF_DTYPES[dtype]
        n = int(np.prod(shape)) if shape else 1
        leaves[name] = torch.frombuffer(data, dtype=dt, count=n, offset=off).reshape(shape)
        off += n * dt.itemsize
    if off - start != size:
        raise ValueError(f"the weights section holds {size} bytes, its leaves {off - start}")
    return leaves


def export_model(model_name, state_dict, L, B, *, n_classes=6, dataset="IEMOCAP",
                 platforms=PLATFORMS, dtype="f32") -> bytes:
    """The serving artifact of a port state dict as ``bytes``.

    ``L``/``B`` may each be an int or a sequence; the cross product is the
    artifact's shape buckets, smallest padded area first. ``dtype`` is
    ``"f32"``, ``"bf16"`` (the weights rounded to bf16, the forward under
    bf16 autocast) or ``"int8"`` (weights-only int8 storage, dequantized to
    bf16 once at load). ``platforms`` is accepted for the JAX signature and
    CLI; the artifact holds no program, so it runs on the card and the CPU
    whatever it says, and the header records ``PLATFORMS``. A zoo
    ``--encoder_attention`` kind, read from ``state_dict``'s keys, is
    recorded as ``encoder_attention``."""
    del platforms
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be 'f32', 'bf16' or 'int8', got {dtype!r}")
    kind = encoder_attention_of(state_dict)
    spec = get_model_spec(model_name)
    buckets = _as_buckets(L, B)
    meta, raw = _weights_section(state_dict, dtype)
    header = {
        "model": model_name,
        "n_classes": n_classes,
        "dataset": dataset,
        # the largest admittable shape, as the JAX header gives it
        "L": max(l for l, _ in buckets),
        "B": max(b for _, b in buckets),
        "buckets": [list(lb) for lb in buckets],
        "platforms": list(PLATFORMS),
        "dtype": dtype,
        "params": {"leaves": meta},
        "logp_layout": spec.logp_layout,
        "inputs": "trimodal" if spec.make_inputs is _trimodal_inputs else "marn1",
    }
    if kind != "mha":  # an MHA header keeps the JAX header's keys
        header["encoder_attention"] = kind
    header = json.dumps(header).encode()
    return b"".join([MAGIC, struct.pack("<I", len(header)), header,
                     struct.pack("<Q", len(raw)), raw])


def save_model(path, *args, **kwargs):
    data = export_model(*args, **kwargs)
    with open(path, "wb") as f:
        f.write(data)


class BucketGraph:
    """One shape bucket's forward captured as a CUDA graph into static
    inputs ``x [L, B, D]``, ``qmask [L, B, P]`` and ``umask [B, L]``.

    ``forward`` is warmed up (``GRAPH_WARMUP`` eager calls on the zero inputs,
    their kernels counted) on a side stream, then captured. No kernel runs
    while capturing, so the kernel counters' rise across the capture is
    taken back and added at each replay. A failed capture raises
    ``RuntimeError`` naming ``what``. A request of [l <= L, b <= B] is
    written into pinned host buffers (``host_inputs``), copied into the
    static inputs' leading corner with zeros around it (the padding) and
    replayed (``run``)."""

    def __init__(self, forward, shapes, device, what):
        self.inputs = tuple(torch.zeros(s, dtype=torch.float32, device=device) for s in shapes)
        self.host = tuple(torch.empty(s, dtype=torch.float32).pin_memory() for s in shapes)
        try:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.no_grad(), torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP):
                    forward(*self.inputs)
            torch.cuda.current_stream(device).wait_stream(side)
            before = Counter(LAUNCHES)
            self.graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(self.graph):
                self.out = forward(*self.inputs)
        except Exception as e:
            raise RuntimeError(f"{what}: CUDA graph capture failed: {e}") from e
        self.launches = LAUNCHES - before
        LAUNCHES.subtract(self.launches)

    def host_inputs(self, l, b):
        """Contiguous views ``(x [l, b, D], qmask [l, b, P], umask [b, l])``
        of the pinned host buffers, for a request's inputs."""
        x, qmask, _ = self.host
        return tuple(t.view(-1)[:math.prod(shape)].view(shape) for t, shape in zip(
            self.host, ((l, b, x.shape[2]), (l, b, qmask.shape[2]), (b, l))))

    def run(self, l, b) -> torch.Tensor:
        """The forward of the [l, b] request in ``host_inputs``: copied to
        the card (waiting for the copy, so the buffers can be written
        again), padded, replayed; the output ``[B*L, C]`` cloned."""
        for dev, src in zip(self.inputs, self.host_inputs(l, b)):
            if dev.shape[:2] != src.shape[:2]:
                dev.zero_()
            dev[:src.shape[0], :src.shape[1]].copy_(src)
        self.replay()
        return self.out.clone()

    def replay(self) -> None:
        """One replay on the current inputs; its kernel launches counted."""
        self.graph.replay()
        LAUNCHES.update(self.launches)

    def __call__(self, x, qmask, umask) -> torch.Tensor:
        """``run`` on host inputs (CPU tensors or numpy arrays) of
        [l <= L, b <= B]."""
        l, b = x.shape[:2]
        for dst, src in zip(self.host_inputs(l, b), (x, qmask, umask)):
            dst.copy_(torch.as_tensor(src))
        return self.run(l, b)


def _pad(bucket, x, qmask, umask):
    """Host inputs of [l, b] padded with zeros to ``bucket``'s [L, B], f32
    CPU tensors."""
    L, B = bucket
    out = []
    for a, shape in ((x, (L, B, x.shape[2])), (qmask, (L, B, qmask.shape[2])), (umask, (B, L))):
        a = torch.as_tensor(a, dtype=torch.float32)
        padded = a.new_zeros(shape)
        padded[:a.shape[0], :a.shape[1]] = a
        out.append(padded)
    return tuple(out)


class ServingModel:
    """A serving artifact's model on one device, answering padded batches.

    ``self.buckets`` is the admitted shape list ``[(L, B), ...]`` sorted
    smallest padded area first; ``predict`` picks the first bucket that
    admits the query and records it in ``self.last_bucket``. ``device``
    defaults to ``cuda`` and raises where CUDA is missing, unless it is
    ``"cpu"``. On the card a bucket's forward is a ``BucketGraph``
    (``graphs``, by bucket and input widths), made at its first request.
    The encoders' kind is the one ``state_dict``'s names hold; the header
    gets it as ``encoder_attention`` (a JAX header has no such field). A
    header that names another kind than its weights raises ``ValueError``."""

    def __init__(self, header, state_dict, device=None):
        kind = encoder_attention_of(state_dict)
        if header.get("encoder_attention", kind) != kind:
            raise ValueError(f"the header's encoder_attention "
                             f"{header['encoder_attention']!r} is not its weights' {kind!r}")
        self.header = {**header, "encoder_attention": kind}
        self.buckets = [tuple(lb) for lb in header["buckets"]]
        self.dtype = header.get("dtype", "f32")
        self.last_bucket = None
        self.predictor = Predictor(header["model"], state_dict=state_dict,
                                   device=device, n_classes=header["n_classes"],
                                   encoder_attention=self.header["encoder_attention"])
        self.model, self.spec = self.predictor.model, self.predictor.spec
        self.device = self.predictor.device
        self.graphs: dict[tuple, BucketGraph] = {}

    @classmethod
    def load(cls, path, device=None):
        """Read a ``SERT`` artifact, or a JAX ``SER2`` v3 one (its weights
        section; its programs are skipped). A ``SER1`` or ``SER2`` v2 file,
        whose weights lie inside its StableHLO programs, raises
        ``ValueError``, as does any other file."""
        with open(path, "rb") as f:
            data = bytearray(f.read())
        magic = bytes(data[:4])
        if magic not in (MAGIC, _JAX_MAGIC, _JAX_MAGIC_V1):
            raise ValueError(f"{path}: not a ser_tpu serving artifact")
        (hlen,) = struct.unpack_from("<I", data, 4)
        header = json.loads(data[8:8 + hlen].decode())
        if magic == _JAX_MAGIC_V1 or "params" not in header:
            raise ValueError(
                f"{path}: a {magic.decode()} artifact without a weights section: its "
                "weights are baked into a StableHLO program, which the port cannot "
                "read; export the checkpoint again")
        off = 8 + hlen
        (plen,) = struct.unpack_from("<Q", data, off)
        leaves = _read_leaves(header["params"]["leaves"], data, off + 8, plen)
        off += 8 + plen
        if magic == _JAX_MAGIC:  # skip the programs, one a bucket
            for _ in header["buckets"]:
                off += 8 + struct.unpack_from("<Q", data, off)[0]
        if off != len(data):
            raise ValueError(f"{path}: {len(data) - off} bytes after the last section")
        if any(t.dtype == torch.int8 for t in leaves.values()):
            leaves = _dequantize_int8(leaves)
        state = from_jax_params({k: v.float().numpy() for k, v in leaves.items()})
        return cls(header, state, device)

    def _input_layout(self, batch):
        """``(text dims, the other parts of x)`` by the header's ``inputs``
        convention: x = [mean of r1..r4 | acouf] (``"marn1"``) or [the
        mean's first 100 dims | acouf | visuf] (``"trimodal"``)."""
        if self.header["inputs"] == "trimodal":
            return TRIMODAL_TEXT, (batch["acouf"], batch["visuf"])
        return np.shape(batch["r1"])[-1], (batch["acouf"],)

    def _make_inputs(self, batch, out=None):
        """``(x, qmask, umask)``, f32 CPU tensors, from a field dict of numpy
        arrays (the JAX ``ServingModel._make_inputs``), written into ``out``
        (tensors of those shapes, e.g. ``BucketGraph.host_inputs``) when
        given. The text mean is summed in the JAX order, ((r1 + r2) + r3) +
        r4, then / 4, over the dims x keeps, by torch's threaded CPU ops
        (the same f32 operations as numpy's, several times faster)."""
        n_text, parts = self._input_layout(batch)
        if out is None:
            l, b = np.shape(batch["qmask"])[:2]
            width = n_text + sum(np.shape(a)[-1] for a in parts)
            out = (torch.empty((l, b, width)), torch.empty(np.shape(batch["qmask"])),
                   torch.empty(np.shape(batch["umask"])))
        x, qmask, umask = out
        r1, r2, r3, r4 = (torch.as_tensor(batch[k])[..., :n_text] for k in ("r1", "r2", "r3", "r4"))
        text = x[..., :n_text]
        torch.add(r1, r2, out=text)
        text.add_(r3).add_(r4).div_(4)
        off = n_text
        for a in parts:
            x[..., off:off + np.shape(a)[-1]] = torch.as_tensor(a)
            off += np.shape(a)[-1]
        qmask.copy_(torch.as_tensor(batch["qmask"]))
        umask.copy_(torch.as_tensor(batch["umask"]))
        return out

    def _forward(self, x, qmask, umask) -> torch.Tensor:
        """``[B*L, C]`` f32 rows; bf16 and int8 artifacts under bf16
        autocast (no cast cache, so a graph holds no cast made at capture)."""
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype != "f32", cache_enabled=False):
            return self.spec.extract_logp(self.model(x, qmask, umask)).float()

    def graph(self, bucket, width, parties) -> BucketGraph:
        """The bucket's graph for inputs ``width`` wide over ``parties``
        parties, captured at the first call."""
        key = (*bucket, width, parties)
        if key not in self.graphs:
            L, B = bucket
            self.graphs[key] = BucketGraph(
                self._forward, ((L, B, width), (L, B, parties), (B, L)), self.device,
                f"{self.header['model']} bucket [{L}, {B}]")
        return self.graphs[key]

    def bucket_forward(self, bucket, x, qmask, umask) -> torch.Tensor:
        """The forward of host inputs (CPU tensors or numpy arrays) of
        [l <= L, b <= B] padded to ``bucket``: ``[B*L, C]`` rows on the
        device, from the bucket's graph on the card, eager on the CPU."""
        if self.device.type == "cuda":
            return self.graph(bucket, x.shape[-1], qmask.shape[-1])(x, qmask, umask)
        with torch.no_grad():
            return self._forward(*_pad(bucket, x, qmask, umask))

    def padded_inputs(self, batch, bucket):
        """``(x, qmask, umask)`` of ``batch`` padded with zeros to ``bucket``'s
        [L, B], as the model sees them."""
        return _pad(bucket, *self._make_inputs(batch))

    def predict(self, batch):
        """batch: the standard field dict at any [l <= L, b <= B]; returns
        ``{"logp": [b, l, C] f32, "preds": [b, l]}`` as numpy, padding
        removed: the model on the batch padded with zeros to the smallest
        admitting bucket (the JAX ``ServingModel.predict``'s contract)."""
        b, l = np.shape(batch["umask"])
        admitting = [lb for lb in self.buckets if l <= lb[0] and b <= lb[1]]
        if not admitting:
            raise ValueError(f"batch [{l}, {b}] exceeds the exported shape "
                             f"[{self.header['L']}, {self.header['B']}]")
        L, B = admitting[0]  # buckets sorted smallest padded area first
        self.last_bucket = (L, B)
        if self.device.type == "cuda":  # the inputs built in the graph's pinned buffers
            n_text, parts = self._input_layout(batch)
            graph = self.graph((L, B), n_text + sum(np.shape(a)[-1] for a in parts),
                               np.shape(batch["qmask"])[-1])
            self._make_inputs(batch, out=graph.host_inputs(l, b))
            logp = graph.run(l, b)
        else:
            logp = self.bucket_forward((L, B), *self._make_inputs(batch))
        logp = logp.cpu().numpy()
        C = logp.shape[-1]
        if self.header.get("logp_layout") == "tb":  # time-major rows
            logp = np.transpose(logp.reshape(L, B, C), (1, 0, 2))
        else:
            logp = logp.reshape(B, L, C)
        logp = logp[:b, :l]
        return {"logp": logp, "preds": logp.argmax(-1)}
