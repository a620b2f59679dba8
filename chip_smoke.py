#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ser_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
 1. the card's name and power limit, torch and CUDA versions; TF32 off;
 2. build every kernel from ``ser_tpu_torch/csrc`` with nvcc, one process
    per source, all started together; registers and spills of every kernel
    (the recurrence's P = 2 and P = 9 instantiations must not spill), for
    the recurrence its cluster size, the clusters the card holds at once
    and the shared memory a CTA by (parties, tile height), and for the MFCC
    kernel its shared memory a block and the blocks an SM holds, for the
    rank-1 kernel its block, the backward's shared memory and the blocks
    and warps an SM holds of each way;
 3. the recurrence kernel against its plain PyTorch version on the card at
    T = 110 for B on both sides of every tile height, at T = 1 and with a
    fully padded row, every launch synchronised, and twice on one input for
    bit-equal outputs;
 3c. the recurrence kernel at P = 9 (MELD) the same way: B = 1, 16, 80, a
    fully padded row and an all-zero qmask mid-sequence, then the MELD
    request shapes: the test split of ``generate_meld_pickles(n_test=280)``
    (MELD's published test-split dialogue count) collated at batch 80,
    [32, 80] after bucketing, through a 7-class model's
    ``recurrence_inputs``;
 3b. the MFCC kernel against its plain version at the IEMOCAP eval wav
    shape, at ``bench.py``'s [1606, 4000], at 1 s utterances (several tiles
    a row, a ragged last tile), at rows that start off 16-byte alignment, at
    one frame, at hop 200, on a 440 Hz tone and at all-zero rows (equal to
    the plain version's bit for bit), every shape twice for bit-equal
    outputs;
 4. the feature path: a ``Predictor`` with seeded full-width MARN1_onlysp
    weights answers three requests (the IEMOCAP eval shape, one dialogue,
    the reference train shape [110, 80]); each must launch the recurrence
    kernel once and match the same model on the CPU, which runs the plain
    path;
 4b. the raw-audio path: ``Predictor(audio_frontend="mfcc")`` answers a
    collated request with waveforms at the IEMOCAP eval shape [82, 31],
    4000 samples bucketed to 4096; it must launch the MFCC kernel and the
    recurrence kernel once each and match the CPU;
 4c. the entry point: ``python -m ser_tpu_torch.predict --synthetic
    --audio_frontend mfcc`` with a seeded checkpoint on the card, against a
    ``--device cpu`` run on the same pickles;
 4d. the MELD entry point: ``ser_tpu_torch.predict.main`` with ``--dataset
    MELD --n_classes 7`` and ``3`` in this process, on the card (the
    recurrence kernel's launches counted) and on the CPU, on those pickles;
 5. CUDA-event timings: the recurrence kernel, its plain version, its
    chain floor (T rounds of its cluster exchanges with no work between
    them) and a whole feature request at the IEMOCAP eval shape; the P = 9
    kernel at the MELD request shape [32, 80] with its plain version, bound
    and chain floor (the exchanges; the party select and scatter on the
    chain printed apart, estimated from an instruction count), in turns
    with the P = 2 kernel (P = 2, 9, 9, 2); the
    recurrence over B; the MFCC kernel at the eval wav shape a wrapper call
    and as device time (launches replayed from a CUDA graph), on one input
    and on three inputs taken in turn (125 MB, more than the L2 holds), its
    bytes floor (its grid, loads and stores with no arithmetic) both ways,
    its plain version, the function's bound and the operation time of the
    kernel's own algorithm; front-end
    utterances/s at ``bench.py``'s shape; a whole wav request;
 6. ``torch.profiler`` breakdowns of a feature request and of a wav request
    by kernel and copy;
 7a. the rank-1 attention kernel (forward and backward) against autograd
    through its plain version at [2, B, 128] for B = 80, 31, 1, 97, 256,
    with p = 0 and 0.2 on one seed: every output within its stated
    tolerance, two runs bit-equal, the kept fraction of its own mask over
    2.6 M draws within 1 - p +- 0.002 and equal to the plain mask's count;
 7b. how far one f32 step's gradients lie from an f64 step on the CPU at
    [64, 16], at the reference's init and with its constant-initialised
    parameters made random; then one train step at the reference train
    shape [110, 80] on the card against the same step on the CPU (same
    seeded weights, the constant-initialised ones made random; dropout
    off): the loss, every gradient, the dead set and the Adam update; T
    forward and T backward launches of the rank-1 kernel;
 7c. the train path: ``ModelTrainer`` trains 2 epochs at batch 80 on the
    ``--synthetic`` pickles (rank-1 kernel in every step, recurrence kernel
    in every eval batch), one train step with the MFCC front end, then
    ``python -m ser_tpu_torch.train --synthetic --epoch 2`` and ``python -m
    ser_tpu_torch.predict`` on its epoch-2 checkpoint;
 7d. exact resume on MELD: ``ser_tpu_torch.train.__main__.main`` with
    ``--dataset MELD --n_classes 7 --save_state`` for 2 epochs, then
    ``--resume latest --epoch 3``, and 3 epochs without a stop; the state
    loaded back into a trainer and saved again equals the saved one bit for
    bit; the largest difference between the resumed and the unstopped
    run's state; the kernels' launches of the unstopped run;
 8. train timings: the rank-1 kernel a wrapper call and in device time
    (CUDA graph), its CUDA launches a forward and backward pair (profiler),
    its wrapper's host time split into checks, allocation, the ctypes call
    and autograd, its plain version, its bound and its own instruction
    floors, and ``F.scaled_dot_product_attention`` on the same function
    (its library yardstick, forward and forward plus backward); a whole
    train step at [110, 80] (CUDA events, median of 5) and its peak device
    memory, with the kernel and with the plain version swapped in; the
    recurrence's forward and backward inside a step; a ``torch.profiler``
    profile of a train step; the launches the optimizer's restore of
    all-zero-gradient parameters adds to Adam's step; a MELD train step at
    [32, 80], P = 9 (median of 5, peak memory, rank-1 launches);
 9. the six MARN1 variants that run the rank-1 attention (sp, cf, azs, sps,
    nsps, no_en), seeded full-width weights: (a) one IEMOCAP feature request
    at [82, 31] on the card against the CPU, exactly T launches of the
    rank-1 kernel and no other kernel of the port, then ms a request (CUDA
    events, median of 10) and a profile (kernel launches a request, device
    idle share, the rank-1 kernel's share of busy time); (b) train steps at
    [110, 80]: 2T rank-1 launches a step (2T - 1 for nsps and no_en), ms a
    step (median of 3), peak memory, a profile, the recurrence's forward and
    backward inside a step between two readings of the step;
    one step card against CPU (dropout off, the constant-initialised
    parameters made random on both sides) at [110, 80] for sp and [32, 16]
    for the others: loss, gradients, dead set, Adam update; (c) sp and nsps
    on a MELD request [32, 80], P = 9, card against CPU; (d) ``python -m
    ser_tpu_torch.train --model MARN1_nsps --synthetic --epoch 2`` on the
    card and ``python -m ser_tpu_torch.predict --model MARN1_nsps`` on its
    epoch-2 checkpoint, which must report ``score.txt``'s Acc and F1 (both
    CLIs in this process);
10. mf, la and newz, which run no kernel of the port (their loops are eager
    ops; the audio slot the MFCC kernel fills is one they never read),
    seeded full-width weights: (a) an IEMOCAP feature request at [82, 31]
    card against CPU (rtol 1e-3, atol 1e-4; on a miss, both sides against
    f64 on the CPU), every kernel counter of the port 0, ms a request
    (median of 10), kernel launches and device idle share (profile of 3);
    (b) train steps at [110, 80]: no port kernel, ms a step (median of 3),
    peak memory, kernel launches and idle share (profile of one step), the
    loop's forward and backward between two readings of the step; one step
    card against CPU at [32, 16] (dropout off, constants made random): loss,
    gradients, dead set, Adam update; (c) mf and newz on the MELD request
    [32, 80], P = 9, card against CPU; (d) newz streamed: a 110-utterance
    dialogue (IEMOCAP's longest) through ``NewZStream`` (max_len 128) on the
    card, held against ``MARN1NewZ(causal_encoder=True)``'s batch forward on
    the card and the stream on the CPU (rtol 1e-4, atol 1e-5), ms a new
    utterance (median, p90), kernel launches an append, the drift from the
    bidirectional forward; (e) ``python -m ser_tpu_torch.serve stream
    --device cuda``, and the newz train CLI for 2 epochs with the predict
    CLI on its checkpoint (all three in this process);
11. DialogueRNN, BiLSTM, MARN, MARN_AT and MARN_ATV, seeded full-width
    weights, no kernel of the port on a feature request or a train step
    (their loops are eager ops; BiLSTM and MARN run cuDNN's LSTM): (a) an
    IEMOCAP feature request at [82, 31] card against CPU on the valid rows
    (rtol 1e-3, atol 1e-4; on a miss, both against f64 on the CPU), every
    kernel counter 0, ms a request (median of 10), launches and idle
    (profile of 3); (b) train steps at [110, 80]: ms a step (median of 3),
    peak memory, launches and idle (profile of one step), for DialogueRNN,
    MARN_AT and MARN_ATV the loop's share; one step card against CPU at
    [32, 16] (dropout off, constants made random): loss, gradients, dead
    set, Adam update; (c) BiLSTM, MARN_AT and MARN_ATV on the MELD request
    [32, 80], P = 9, and ``BiModel`` alone at P = 9 on a 712-wide input,
    card against CPU; (d) ``python -m ser_tpu_torch.predict --model
    DialogueRNN --synthetic --audio_frontend mfcc`` on the card in this
    process (the MFCC kernel once a batch, nothing else) against ``--device
    cpu`` on the same pickles; (e) the train CLI for 2 epochs and the
    predict CLI on its checkpoint for DialogueRNN and MARN_ATV (time-major
    rows), which must report ``score.txt``'s Acc and F1.
12. the serving artifacts (``serving.save_model``, ``ServingModel``, ``python
    -m ser_tpu_torch.serve export|run|bench``), each bucket's forward a CUDA
    graph captured at its first request: (a) onlysp f32 at full width (seeded
    weights, the reference's constant-initialised parameters made random, as a
    trained model has none) exported at ``serve.py export``'s default buckets
    (L = 110, B = 1, 8, 32, 80) and asked [74, 1], [82, 8], [82, 31] and
    [110, 80]: each request picks the expected bucket, its first request
    launches the recurrence kernel for the two warm-ups and one replay, each
    later one once; the replay within 1e-5 of the eager ``Predictor`` on the
    same padded batch, two replays bit-equal, the card against the CPU
    artifact at rtol 1e-3, atol 1e-4; each bucket's replay, served request,
    eager request and eager forward at the padded shape timed (CUDA events),
    and a profile of the eval request served and eager; (b) the same weights
    in bf16 (log-probs within 0.5 of the f32 artifact's, 0.1 on average) and
    int8 (argmax agreement on valid rows at least 0.9, drift under 1.0; the
    file under 0.45 of the f32 one), the recurrence kernel once a request;
    (c) every other registry model's f32 artifact (L = 82, 110, B = 1, 32)
    asked the eval request [82, 31]: the kernels the eager forward launches
    on the padded batch (82 rank-1 launches for the six variants, none for
    the rest), the replay within 1e-5 of the eager forward, the card against
    the CPU (the valid rows for phase 11's models) at rtol 1e-3, atol 1e-4;
    (d) the CLIs in this process: ``export`` from an ``.npz`` and from a
    reference torch state dict under ``module.model.`` keys (the same
    artifact byte for byte), ``run --synthetic`` on the card against ``run
    --device cpu`` on the same pickles (utterances equal, predictions agreeing
    on 99.9% of valid rows), ``bench`` (finite rows for every bucket), and a
    7-class MELD artifact through ``run`` on the card (the P = 9 kernel)
    against the CPU.
13. MARN1_onlysp under the five zoo kinds of ``--encoder_attention``
    (external, self, simplified_self, mobilevit_v2, muse), ``--infonce`` and
    ``--debug_nans``, seeded full-width weights: (a) the IEMOCAP eval request
    [82, 31] under each kind on the card against the CPU (rtol 1e-3, atol
    1e-4), the op's weights drawn large (``enlarge_zoo_ops``) so that it moves
    the log-probs by more than 2e-2, the recurrence kernel once, ms a request
    (median of 10) beside mha's; (b) one step under each kind card against CPU at [32, 16]
    (dropout off, constants made random): loss, gradients, the dead set
    (onlysp's 38 unused parameters), Adam update, 2T rank-1 launches; the
    [110, 80] step of mha, external and muse timed (median of 3) with its
    peak memory and 220 rank-1 launches; (c) ``--infonce 0.1`` at [110, 80]:
    from one generator state the step's loss less the plain step's equals
    0.1·``info_nce`` of that forward's features, 220 rank-1 launches, its
    step time and peak beside the plain step's, a step card against CPU at
    [32, 16] with weight 1e4 (at 0.1 the term's gradients lie below the
    contract's tolerance); (d) ``python -m ser_tpu_torch.train --synthetic
    --epoch 2 --batch_size 16 --encoder_attention external --infonce 0.1``
    and ``predict --encoder_attention external`` on its checkpoint
    (``score.txt``'s Acc and F1), the train CLI under ``--debug_nans`` for
    one step (16 dialogues), ``serve export --encoder_attention muse`` and
    ``serve run`` on the card against the CPU, a bucket graph's replay
    against its eager forward, and a NaN in one valid row's ``acouf``
    raising ``FloatingPointError`` in the first step under ``--debug_nans``
    (all in this process).
14. ``--compute_dtype bf16`` and ``--dp``: (a) the bf16 form of the rank-1
    kernel (registers and spills of both forms) against its plain bf16 form
    at [2, B, 128] for B = 80, 31, 1 and p = 0 and 0.2, forward and
    backward: z, dx1, dx2 within 2^-7 of the plain value plus 1e-5, dwq and
    dwk plus 1e-5 of their largest entry; every output equal to the f32
    kernel's on the widened inputs rounded once to bf16; two runs bit-equal;
    its mask the f32 kernel's row by row; the device time of a forward and
    backward pair beside the f32 kernel's (CUDA graphs, in turns), its
    wrapper time, the plain bf16 form's and ``F.scaled_dot_product_attention``
    in bf16; (b) MARN1_onlysp's bf16 step at [110, 80]: 220 launches of the
    bf16 kernel and no other kernel of the port, master parameters,
    gradients and Adam state f32, ms a step (median of 5) and peak memory in
    turns with the f32 step, and one profiled step of each (kernel launches,
    device busy and idle); one bf16 step of each of the six variants at
    [32, 16] (2T or 2T - 1 bf16 launches) and of DialogueRNN and BiLSTM (no
    port kernel); (c) the bf16-against-f32 gradient distance of onlysp at
    [9, 3] on the card and on the CPU, at the reference's init and with its
    constant-initialised parameters made random (the card's at most 1.5 x
    the CPU's + 0.02 there); (d) ``python -m ser_tpu_torch.train --synthetic
    --epoch 2 --batch_size 16 --compute_dtype bf16`` in this process;
    (e) ``--dp`` as one NCCL rank: a step with dropout bit-equal to the plain
    step from the same state; then two processes sharing the card over gloo
    (this script with ``--dp_worker``), a dropout-off step at [32, 16]
    against the one-process step at the train-step contract (loss,
    gradients, the 38 dead, Adam's update), parameters bit-equal across the
    processes; then ``python -m ser_tpu_torch.train --dp --synthetic --epoch
    1 --batch_size 16`` in both processes: one ``score.txt`` block and line,
    one ``res.csv``, the rank-1 and recurrence kernels launched in each.
15. ``--tp`` (MARN1_onlysp, full width and depth), in processes sharing the
    card over gloo (this script with ``--tp_worker``): two processes at
    tp 2: (a) one [110, 80] step with dropout on, its loss and gathered
    parameters bit-equal to the one-process step run here (held to the
    train-step contract instead where two one-process steps on the card
    differ), (d) each process's parameter and Adam-state bytes the rule's
    (``parallel.shard_dims``), (c) eval of the synthetic test split at
    batch 80 on the gathered weights (constants made random) with the
    one-process Acc and F1 exactly, the recurrence kernel launched and held
    against its plain version at the eval's shape, (e) ``python -m
    ser_tpu_torch.train --tp 2 --synthetic --epoch 1 --batch_size 16``: one
    ``score.txt`` block and line; then four processes at dp 2 x tp 2:
    (b) a dropout-off step at [32, 16] against the one-process step at the
    train-step contract (loss, gradients, the 38 dead, Adam's update) and
    bit-equal to phase 14's two-process ``--dp`` step; the [110, 80] step
    of both layouts timed (median of 3 a process) with each process's peak
    memory and the rank-1 kernel's 220 launches a step.
16. the DialogueRNN suite's extras (``models/dialogue_rnn_extras.py``),
    the C collate, FLOP counts and ``analysis``: (a) the six extras at full
    width on seeded weights carried through the JAX package's names
    (DialogueRNNModel and AVECModel at the registry DialogueRNN's widths
    [110, 80], 'simple' and no listener state, DialogueRNNModel's eval also
    with ``att2`` off and with 'general2' and listener state;
    DailyDialogueModel [32, 80] of 32 words; E2EModel and BiE2EModel three
    turns of [32, 80]; a 20,000-token vocabulary): an eval card against CPU
    (rtol 1e-3, atol 1e-4 on valid rows) and every kernel counter 0; one
    step card against CPU with dropout off at the train-step contract, the
    card replaying the CPU's ReLU decisions (``PinnedRelu``, at most 1e-5 of
    them flipped); one step with dropout on, each rate's kept fraction
    within 6 standard deviations of 1 - p; (b) ms a request (median of 10)
    and a step (median of 3), kernel launches, idle, peak memory of each
    and its rise above what was held before the step;
    (c) every loader batch of the synthetic IEMOCAP and MELD pickles through
    the C collate bit-equal to the numpy version, and the host ms of a
    [110, 80] batch both ways; (d) ``count_flops`` of onlysp's eval forward
    [82, 31] and train step [110, 80] on the plain path on the CPU, and
    ``efficiency`` against phases 5's request and 8's step; (e)
    ``analysis.analyze_res`` on phase 4c's ``res.csv`` gives the predict
    CLI's accuracy and F1.
17. the train CLI's ``--eval`` score header, ``ModelTrainer``'s ``h.csv``, the
    two user scripts and the attention zoo's other 20 classes: (a) ``python
    -m ser_tpu_torch.train --eval True`` on a seeded onlysp checkpoint in this
    process on the card and on the CPU: ``score.txt`` byte-equal to
    ``train.py``'s header, the recurrence kernel launched; ``ModelTrainer(
    legacy_h_csv_path=)``'s eval of the same split on both: ``h.csv`` holds
    ``res.csv``'s rows as ``trues,preds,masks``, its labels and masks equal
    and its predictions agreeing on 99.9% of valid rows; (b) ``python -m
    ser_tpu_torch.scripts.compare_artifacts`` on phase 12's f32, bf16 and
    int8 onlysp artifacts (the bf16 drift under 0.5, the int8 agreement at
    least 0.9), its figures those of ``ServingModel`` on the same batch
    computed here, the recurrence kernel launched at each artifact's first
    request (two warm-ups and a replay); (c) ``python -m
    ser_tpu_torch.scripts.convergence_bf16 --models MARN1_onlysp --seeds 1
    --epochs 1``: the JAX script's document keys, the rank-1 kernel 2T times
    a step of the f32 run and its bf16 form 2T times a step of the bf16 run,
    the recurrence kernel once a test batch of each eval; (d) each of the 20
    classes at the JAX class's default widths, batch 50 (NCHW [50, 512, 7,
    7]; sequences [50, 49, 512], UFO and EMSA with 8 heads of 64), weights
    redrawn from a seed: a forward, and a forward with the backward of a
    fixed weighted sum, on the card against the CPU (rtol 1e-3, atol 1e-4;
    the gradients of the input and of every parameter at the train-step
    contract), the card replaying the CPU's ReLU decisions (``PinnedRelu``),
    every kernel counter 0; ms a forward and a forward with its backward
    (median of 10).
18. the attention zoo's last 15 classes (``ops/attention_zoo_vision.py``,
    ``ops/attention_zoo_transformers.py``) at the JAX classes' default
    widths, weights redrawn from a seed: the blocks at batch 50 (NCHW [50,
    512, 7, 7]; ViP NHWC [50, 8, 8, 512], Outlook NHWC [50, 28, 28, 512],
    Halo [50, 512, 8, 8] with block 2 and halo 1, MobileViT [50, 3, 49,
    49]), GFNet, CoAtNet, CrossFormer, MOATransformer and DAT on [32, 3,
    224, 224] images: (a) a forward, and a forward with the backward of a
    fixed weighted sum, on the card against the CPU (rtol 1e-3, atol 1e-4;
    the gradients of the input and of every parameter at the train-step
    contract; GFNet's unused ``embedding`` without one on both), at batch 2
    for MobileViT and the backbones; the card's gradients on its own kinks
    reported, then checked replaying the CPU's (``PinnedKinks``: ReLU
    signs, max-pool choices, the cells of DAT's bilinear samples), the
    flipped decisions counted; (b) every kernel counter 0; (c) ms a forward
    and a forward with its backward (median of 10) at the timed batch, and
    the peak memory of each.
19. the bench CLIs in this process, ``main()`` with ``sys.argv`` set and
    the output caught: (a) ``python -m ser_tpu_torch.bench`` in full: its
    line has the JAX ``bench.py``'s keys, ``backend`` ``cuda``, the card's
    name and power limit in ``device`` and finite, positive numbers; the
    recurrence kernel launched once a timed eval pass, the rank-1 kernel 220
    times a timed [110, 80] train step, the MFCC kernel once a timed
    front-end pass, and no other kernel; then the median ms of the train
    step's host-to-device copy; (b) ``python -m ser_tpu_torch.bench_zoo
    --models MARN1_onlysp DialogueRNN --iters 2 --save``: the saved
    document's keys, the recurrence kernel once an onlysp pass and nothing
    for DialogueRNN; (c) ``--check`` of that file (threshold 0.25: the round
    trip, not the host's spread, under which two readings of one process
    have differed by 1.45x); (d) ``--train --models MARN1_onlysp
    --iters 2`` in f32 and in ``--dtype bf16``: 220 launches of the rank-1
    kernel, or of its bf16 form, a step; (e) ``--check
    baselines/zoo_r04.json`` refused (backend ``tpu``) before any model
    runs.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import csv
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_PEAK = 67e12   # H100 SXM f32 FLOP/s outside the tensor cores (data sheet)
HBM_RATE = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
# H100 SXM special-function rate: 16 results a clock an SM for ex2 and the
# other transcendentals at compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput), 132 SMs, 1.98 GHz boost clock
# (data sheet)
SFU_RATE = 16 * 132 * 1.98e9
# H100 SXM integer rate: 64 32-bit add, multiply, shift, logic or compare
# results a clock an SM at compute capability 9.0 (CUDA C++ Programming
# Guide), and the issue rate: 4 warp instructions a clock an SM (one a
# scheduler)
INT_RATE = 64 * 132 * 1.98e9
ISSUE_RATE = 4 * 32 * 132 * 1.98e9  # thread instructions a second
# the rank-1 kernel's own instructions a pair, (all, integer), from its
# source: forward the hash (xor k, two multiplies, two shift-xors, the
# compare: 8) and 5 float (the FFMA, ex2, den, select and FFMA of num);
# backward pass 1 the hash, the ballot, 7 float and the store of e (17),
# pass 2 the load of e, a quarter each of the vector loads of four rows'
# keep words and three row scalars, the bit test, the select and 3 FFMAs
# (8, 2 integer)
RANK1_PAIR_OPS = {"fwd": (13, 8), "bwd": (25, 10)}
# rank-1 kernel vs its plain version: 128-term f32 sums in another order;
# dwq and dwk sum B * 128 terms, so their absolute part scales with their
# largest entry
RANK1_RTOL, RANK1_ATOL = 1e-4, 1e-5
# a train step card vs CPU, dropout off: the loss at rtol 1e-5; a gradient
# within 1e-3 of its tensor's largest |entry| plus 1e-6 of the step's
# largest (tests/test_torch_train_step.py's contract against the JAX
# package); Adam's first step moves a parameter by lr * sign(g), so the
# updates agree within 2.05 lr
TRAIN_LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-3, 1e-6
TRAIN_L, TRAIN_B, TRAIN_LR = 110, 80, 1e-3
# the parameters the reference declares and never uses: outside the graph,
# .grad stays None and Adam skips them
DEAD = re.compile(r"^marn_cell_[fb]\.(crossatt_l2a\.Wv|crossatt_a2l\.|lstm_q0\.|"
                  r"lstm_q1\.|lstm_s\.)|^encoder_[la]\.pos_ffn\.fc\.|^linear\.")
# kernel vs plain: the spectrum by an FFT against dense DFT products (other
# roundings of the window and the sums), then 64-term sums of logs up to 13.8
MFCC_RTOL, MFCC_ATOL = 1e-5, 2e-4
WAV_T, WAV_BUCKET_T = 4000, 4096  # bench.py's utterance, collate's bucket
PREDICT_SEED = 111  # the predict CLI's default --seed, which --synthetic uses
MELD_TEST = 280  # MELD's published test split, in dialogues
MELD_TRAIN = 200  # train dialogues of phase 7d's pickles: 2 batches of 80 an epoch
VARIANTS = ("MARN1_sp", "MARN1_cf", "MARN1_azs", "MARN1_sps", "MARN1_nsps", "MARN1_no_en")
# the recurrence kernel's party select and scatter on a step's serial chain,
# an estimate that no run measures: instructions a party, counted in its
# source: the r/z thread 8 (the qmask load, 1 - m, a multiply and an FFMA;
# the next qmask's load, a compare, two selects), then the pair thread 11
# (the load, 1 - m, two multiplies and two FFMAs; the load, a compare, three
# selects); a warp issues one a clock at the data sheet's boost clock
PARTY_CHAIN_INSTR = 8 + 11
SM_CLOCK = 1.98e9  # H100 SXM boost clock (data sheet)
# phase 9's models and the size of each one's dead set: the parameters it
# declares and never uses (the S projections of a 3-term LSTHM, lstm_s or
# gru_l, l2a's Wv and the a2l rank-1 vectors, the encoders' pos_ffn.fc, the
# model's own unused modules; tests/test_torch_variants_train.py holds the
# names against the JAX package's all-zero gradients)
VARIANT_DEAD = {"MARN1_sp": 34, "MARN1_cf": 25, "MARN1_azs": 18, "MARN1_sps": 20,
                "MARN1_nsps": 22, "MARN1_no_en": 34}
VARIANT_CHECK_SHAPE = (32, 16)  # phase 9's card-against-CPU step, [110, 80] for sp
# nsps and no_en leave z out of a step's output, so the last step's z reaches
# no loss and autograd runs no backward of the rank-1 kernel for it: 2T - 1
# launches a train step where the others take 2T
Z_NOT_IN_OUTPUT = ("MARN1_nsps", "MARN1_no_en")
# phase 10's models, which run no kernel of the port, and their dead sets
# (tests/test_torch_marn_rest_train.py holds the names against the JAX
# package's all-zero gradients)
REST = ("MARN1_mf", "MARN1_la", "MARN1_newz")
REST_DEAD = {"MARN1_mf": 10, "MARN1_la": 78, "MARN1_newz": 26}
# the streamed dialogue: IEMOCAP's longest (110 utterances, the reference
# train shape's L) in a history of serve.py stream's default capacity
STREAM_L, STREAM_MAX_LEN = 110, 128
# phase 11's models, which run no kernel of the port on a feature request or
# a train step, and their dead sets (tests/test_torch_rest_models_train.py
# holds the names against the JAX package's all-zero gradients)
BASELINES = ("DialogueRNN", "BiLSTM", "MARN", "MARN_AT", "MARN_ATV")
BASELINE_DEAD = {"DialogueRNN": 0, "BiLSTM": 4, "MARN": 50, "MARN_AT": 4, "MARN_ATV": 6}


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_graph_ms(torch, fn, calls=21, replays=7):
    """Milliseconds of device time a call of ``fn``: ``calls`` calls captured
    into one CUDA graph, the graph replayed between two CUDA events, the
    median over ``replays``. No host work lies between the launches, so the
    reading does not follow the host as a timed wrapper call does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(torch, graph.replay, warmup=2, iters=replays) / calls


def cuda_ms(torch, fn, warmup=3, iters=20):
    """Median milliseconds of ``fn`` between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_summary(log):
    """One line a kernel from ``nvcc -Xptxas -v``: name, registers, spills."""
    lines = []
    for name, body in re.findall(
            r"Compiling entry function '(\w+)'(.*?)(?=ptxas info\s*: Compiling|\Z)",
            log, re.S):
        short = re.search(r"\d+([a-z_]+kernel(?:I(?:L[ib]\d+E)+)?)", name)
        # the storage type of a kernel templated over it (the rank-1 kernel)
        form = (" (bf16)" if "__nv_bfloat16" in name
                else " (f32)" if re.search(r"kernelIfE", name) else "")
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        lines.append(f"{short.group(1) if short else name}{form}: "
                     f"{regs.group(1) if regs else '?'} registers, spill stores "
                     f"{spill.group(1) if spill else '?'} B, loads "
                     f"{spill.group(2) if spill else '?'} B")
    return lines


def recurrence_inputs(np, torch, T, B, seed, dev, padded_row=None, P=2):
    """Seeded kernel inputs at full width (H = 128) for P parties, scaled
    like the recurrence's real inputs, with a padded tail (all-zero qmask)
    on the later half of the rows; row ``padded_row`` is padded at every
    step."""
    H = 128
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        (0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
    lengths = rng.integers(max(1, T // 2), T + 1, size=B)
    sp = rng.integers(0, P, size=(T, 2, B))
    qm = np.zeros((T, 2, B, P), np.float32)
    qm[np.arange(T)[:, None, None], np.arange(2)[None, :, None],
       np.arange(B)[None, None, :], sp] = 1
    qm *= (np.arange(T)[:, None] < lengths[None, :])[:, None, :, None]
    if padded_row is not None:
        qm[:, :, padded_row] = 0
    seqs = (f(T, 2, B, 4 * H), f(T, 2, B, 4 * H), f(T, 2, B, 3 * H),
            torch.from_numpy(qm).to(dev))
    consts = (f(2, 3 * H, 4 * H), f(2, 4 * H), f(2, 3 * H, 4 * H),
              f(2, 4 * H), f(2, H, 3 * H), f(2, 3 * H), f(2, H), f(2, H))
    return seqs, consts


def recurrence_bound(seqs, consts, out):
    """Least time for the recurrence: each input read once, the output
    written once; per (step, direction, row) the GRU h-side product
    2*H*3H, both LSTHM products 2*2*3H*4H, the attention 5*H*H (multiply,
    subtract, exp, multiply-add, add), the s dot 2*H, and the P-party work
    the function needs: the scatter of the P party memories of H units, 3
    flops each (1 - m, a multiply, an FFMA, ``ops/masking.py::
    scatter_parties``), and P - 1 compares to select a row's party (the
    product of the selected memory with gWhh is the GRU's, counted above)."""
    T, _, B, P = seqs[3].shape
    H = 128
    party = 3 * P * H + P - 1
    flops = T * 2 * B * (2 * H * 3 * H + 4 * 3 * H * 4 * H + 5 * H * H + 2 * H + party)
    nbytes = sum(t.numel() * t.element_size() for t in (*seqs, *consts, out))
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mfcc_bound(x, consts, out, cfg):
    """Least time for the MFCC function, whatever the algorithm: the
    waveform, the mel filterbank and the DCT matrix read once, the
    coefficients written once (an FFT reads no DFT matrix); pre-emphasis 2
    flops a sample, and per frame the window win, a real FFT of n_fft
    2.5*n_fft*log2(n_fft) (FFTW's count), the power 3*nbins, 2 per nonzero
    of the filterbank, log(. + eps) 2*n_mels and a fast DCT
    2.5*n_mels*log2(n_mels). Returns ``(ms, bound_by, own_ms)`` with
    ``own_ms`` the operations time of the kernel's own algorithm: a
    256-point complex FFT in passes of radix 8, 8 and 4 (56 flops a radix-8
    butterfly, 16 a radix-4, 6 a twiddle product: 32*56*2 + 64*16 +
    2*32*7*6), the split and power of 128 bin pairs at 20 flops and bin
    128 at 5, the filterbank's nonzeros, and the DCT as a dense product."""
    N, T = x.shape
    frames = N * cfg.n_frames(T)
    nbins = cfg.n_fft // 2 + 1
    mel, dct = consts[2], consts[3]
    per_frame = (cfg.win_length + 2.5 * cfg.n_fft * math.log2(cfg.n_fft)
                 + 3 * nbins + 2 * int((mel != 0).sum()) + 2 * cfg.n_mels
                 + 2.5 * cfg.n_mels * math.log2(cfg.n_mels))
    own = (cfg.win_length + 2 * 32 * 56 + 64 * 16 + 2 * 32 * 7 * 6
           + 20 * (cfg.n_fft // 4) + 5 + 2 * int((mel != 0).sum())
           + 2 * cfg.n_mels + 2 * cfg.n_mels * cfg.n_mfcc)
    flops = 2 * N * T + frames * per_frame
    nbytes = sum(t.numel() * t.element_size() for t in (x, mel, dct, out))
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    own_ms = (2 * N * T + frames * own) / F32_PEAK * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            own_ms)


def wav_request(np, batch, seed):
    """``batch`` as ``data.collate`` pads it with raw audio: WAV_T seeded
    samples for every real utterance, zeros in every padded slot, the
    sample axis bucketed to WAV_BUCKET_T, ``wav_len`` per dialogue."""
    L, B = batch["qmask"].shape[:2]
    rng = np.random.default_rng(seed)
    wav = np.zeros((L, B, WAV_BUCKET_T), np.float32)
    wav[:, :, :WAV_T] = (0.5 * rng.standard_normal((L, B, WAV_T))).astype(
        np.float32) * batch["umask"].T[:, :, None]
    return dict(batch, wav=wav, wav_len=np.full(B, WAV_T, np.int32))


def read_res_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return ([int(r["preds"]) for r in rows], [int(r["labels"]) for r in rows],
            [float(r["masks"]) for r in rows])


def device_profile(torch, fn, n):
    """Device events of ``n`` calls of ``fn`` under ``torch.profiler``:
    ``(wall ms, busy ms, events)`` with events the kernels and copies, one
    a name (``key``, ``count``, ``self_device_time_total`` in us, as
    ``key_averages`` gives them). They are summed from the tracer's own
    records: ``key_averages`` first builds every host op's tree, which costs
    seconds for a train step's 20-27 k launches."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels and copies: not host ops, and not the optimizer's annotation
    # of the device span its own kernels fill
    events = {}
    for r in prof.profiler.kineto_results.events():
        name = r.name()
        if (r.device_type() != torch.autograd.DeviceType.CUDA
                or name.startswith(("Activity Buffer", "Optimizer."))):
            continue
        e = events.setdefault(name, SimpleNamespace(key=name, count=0,
                                                    self_device_time_total=0.0))
        e.count += 1
        e.self_device_time_total += r.duration_ns() / 1e3
    events = list(events.values())
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    return wall_ms, busy_ms, events


def traced_launches(torch, fn, n, pad=20):
    """CUDA kernels a call of ``fn`` under ``torch.profiler``: ``n`` calls
    between two marker kernels, with ``pad`` calls before and after (over a
    short window the tracer has been seen to lose kernel records at the start
    and end, PERF.md §7). Returns ``(kernels a call, {name: count})``, or
    None when the trace lost a marker."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for calls in (pad, 0, n, 0, pad):
            for _ in range(calls):
                fn()
            if not calls:
                marker.add_(1)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "Memcpy" not in e.name and "Memset" not in e.name),
                     key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(kernels) if "elementwise" in e.name]
    if len(marks) != 2:
        return None
    names = {}
    for e in kernels[marks[0] + 1:marks[1]]:
        names[e.name[:40]] = names.get(e.name[:40], 0) + 1
    return sum(names.values()) / n, names


def rank1_inputs(torch, B, dev, seed):
    """Seeded rank-1 attention inputs at D = 128, scaled like the train
    recurrence's cell states: x1, x2, wq, wk and an output gradient."""
    g = torch.Generator().manual_seed(seed)
    n = lambda *s, sc=1.0, at=0.0: (at + sc * torch.randn(*s, generator=g)).to(dev)
    return (n(2, B, 128, sc=2.0), n(2, B, 128, sc=0.5), n(2, 128, sc=0.1, at=1.0),
            n(2, 128, sc=0.3, at=1.0), n(2, B, 128))


def rank1_fwd_bwd(torch, fn, ins, g, seed, step, p):
    """``(z, dx1, dx2, dwq, dwk)`` of ``fn`` by autograd, synchronised."""
    xs = [x.clone().requires_grad_() for x in ins]
    z = fn(*xs, seed, step, p)
    torch.cuda.synchronize()
    grads = torch.autograd.grad(z, xs, g)
    torch.cuda.synchronize()
    return (z.detach(), *grads)


def rank1_sdpa_qkv(torch, x1, x2, wq, wk):
    """The rank-1 attention as scaled-dot-product attention: a logit is
    ``alpha[b, i] * wk[k]``, a dot product of head dimension 1, zero-padded
    to 8 (which changes neither the logits nor column 0 of the output);
    ``q = alpha``, ``k = wk`` over b, ``v = x2``, each [2, B, D, 8]."""
    F = torch.nn.functional
    alpha = x1 * (x2 * wq[:, None, :]).sum(-1, keepdim=True) * (x1.shape[-1] ** -0.5)
    pad = lambda t: F.pad(t[..., None], (0, 7))
    return pad(alpha), pad(wk[:, None, :].expand_as(x2).contiguous()), pad(x2)


def rank1_sdpa_call(torch, q, k, v, p):
    """z [2, B, D] from ``rank1_sdpa_qkv``'s tensors: softmax over the keys,
    dropout p on its output, times v, at scale 1."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, dropout_p=p, scale=1.0)[..., 0]


def rank1_sdpa(torch, x1, x2, wq, wk, p):
    """The rank-1 attention through ``F.scaled_dot_product_attention``: the
    kernel's library yardstick, timed here and called nowhere in the port.
    With p > 0 it draws its own mask, so it agrees only in distribution."""
    return rank1_sdpa_call(torch, *rank1_sdpa_qkv(torch, x1, x2, wq, wk), p)


def rank1_bound(B, D=128, itemsize=4):
    """Least time for one step's rank-1 attention at [2, B, D]: ``{part:
    (ms, bound_by)}`` for the forward, the backward and both. The work that
    depends on (b, i, k): forward one exp and 4 flops a pair (product,
    shift, the two sums); backward one exp again (the function keeps no
    [B, D, D] state between the two) and 12 flops (logit 2, A2, A3, B1, B2,
    B3 as products and sums). Bytes: x1, x2, wq, wk in, z out; backward
    also g in, dx1, dx2, dwq, dwk out, ``itemsize`` bytes an element (2 in
    bf16). Each of exps at SFU_RATE, flops at F32_PEAK (the function's sums
    are f32 in both forms), bytes at HBM_RATE; the largest is the bound."""
    pairs, row, vec = 2 * B * D * D, 2 * B * D * itemsize, 2 * D * itemsize
    work = {"fwd": (pairs, 4 * pairs, 3 * row + 2 * vec),
            "bwd": (pairs, 12 * pairs, 5 * row + 4 * vec)}
    work["both"] = tuple(a + b for a, b in zip(work["fwd"], work["bwd"]))
    out = {}
    for part, (exps, flops, nbytes) in work.items():
        times = {"operations (exp)": exps / SFU_RATE * 1e3,
                 "operations": flops / F32_PEAK * 1e3, "bytes": nbytes / HBM_RATE * 1e3}
        by, ms = max(times.items(), key=lambda kv: kv[1])
        out[part] = (ms, "bytes" if by == "bytes" else "operations", by)
    return out


def rank1_floor(B, D=128):
    """The rank-1 kernel's own floor at [2, B, D]: ``{part: (ms, by)}``,
    the larger of its instructions a pair (RANK1_PAIR_OPS) at the issue
    rate and its integer operations at the integer rate, forward and
    backward, and their sum for both."""
    pairs = 2 * B * D * D
    out = {}
    for part, (ops, int_ops) in RANK1_PAIR_OPS.items():
        times = {"issue": pairs * ops / ISSUE_RATE * 1e3,
                 "integer pipe": pairs * int_ops / INT_RATE * 1e3}
        by, ms = max(times.items(), key=lambda kv: kv[1])
        out[part] = (ms, by)
    out["both"] = (out["fwd"][0] + out["bwd"][0],
                   f"{out['fwd'][1]} forward, {out['bwd'][1]} backward")
    return out


def no_dropout(model, Dropout):
    """Every dropout rate of the port's model set to 0."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model.dropout_rate = model.attn_dropout = 0.0


def randomize_constants(torch, models, seed, prefix=""):
    """Seeded random values, the same on every model, for the parameters
    (whose names start with ``prefix``) that the reference initialises to a
    constant: the sequence attentions' W (ones), the rank-1 wq, wk (ones),
    LayerNorm (ones, zeros) and the fusion scalars (ones). A trained model
    has no such constants, and with the sequence attentions' ones the
    gradients of an f32 step carry percents of rounding noise
    (``init_conditioning``). A matrix gets N(0, 1/fan_in), a vector or a
    scalar its constant plus 0.1 N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    new = {}
    for name, p in models[0].named_parameters():
        if not name.startswith(prefix) or (p.numel() > 1 and p.detach().std().item() > 0):
            continue
        base = p.detach().cpu()
        new[name] = (torch.randn(p.shape, generator=g) / p.shape[0] ** 0.5
                     if p.ndim == 2 and p.shape[0] > 1
                     else base + 0.1 * torch.randn(p.shape, generator=g))
    with torch.no_grad():
        for model in models:
            params = dict(model.named_parameters())
            for name, value in new.items():
                params[name].copy_(value.to(params[name].device))
    return sorted(new)


def init_conditioning(torch, L=64, B=16):
    """How far one f32 train step's gradients lie from the same step in f64,
    on the CPU at [L, B] (7b's batch seed and lengths), dropout off:
    ``{init: worst max|g32 - g64| / max|g64| over the tensors}`` at the
    reference's init, with only the sequence attentions' W made random, and
    with every constant-initialised parameter made random. A tensor whose
    f64 gradient is below 1e-6 of the step's largest (zero but for
    rounding) is left out."""
    import copy

    from ser_tpu_torch.data.synthetic import synthetic_batch
    from ser_tpu_torch.models.registry import build_model, get_model_spec
    from ser_tpu_torch.ops.init import generator
    from ser_tpu_torch.ops.layers import Dropout
    from ser_tpu_torch.train.losses import masked_loss

    batch = synthetic_batch(L=L, B=B, seed=1, min_len=20)
    inputs = get_model_spec("MARN1_onlysp").make_inputs(batch)
    labels = torch.as_tensor(batch["label"]).reshape(-1)
    out = {}
    for init, prefix in (("reference", None), ("sequence attentions random", "crossatt_"),
                         ("constants random", "")):
        base = build_model("MARN1_onlysp", generator(0))
        if prefix is not None:
            randomize_constants(torch, [base], seed=1, prefix=prefix)
        grads = {}
        for dtype in (torch.float32, torch.float64):
            model = copy.deepcopy(base).to(dtype).train()
            no_dropout(model, Dropout)
            x, qmask, umask = (torch.as_tensor(a).to(dtype) for a in inputs)
            logp = model(x, qmask, umask, generator=torch.Generator())[0]
            masked_loss(logp, labels, umask).backward()
            grads[dtype] = {n: p.grad.double() for n, p in model.named_parameters()
                            if p.grad is not None}
        g32, g64 = grads[torch.float32], grads[torch.float64]
        top = max(g.abs().max().item() for g in g64.values())
        out[init] = max(((g32[n] - g).abs().max() / g.abs().max()).item()
                        for n, g in g64.items() if g.abs().max().item() > 1e-6 * top)
    return out


def grad_check(torch, cpu_model, card_model):
    """``(worst fraction of the tolerance, names with .grad None on the CPU,
    the same on the card)``."""
    cpu = dict(cpu_model.named_parameters())
    card = dict(card_model.named_parameters())
    top = max(p.grad.abs().max().item() for p in cpu.values() if p.grad is not None)
    worst = 0.0
    for name, p in cpu.items():
        if p.grad is None or card[name].grad is None:
            continue
        tol = GRAD_RTOL * p.grad.abs().max().item() + GRAD_FLOOR * top
        worst = max(worst, (card[name].grad.cpu() - p.grad).abs().max().item() / tol)
    return (worst, {n for n, p in cpu.items() if p.grad is None},
            {n for n, p in card.items() if p.grad is None})


class PinnedRelu:
    """A stand-in for ``torch.relu`` for a card-against-CPU train check: it
    records each call's decisions (x > 0) in order, then, after
    ``replay()``, applies the recorded ones as ``x * mask``, whose forward
    differs from relu(x) only where x lies within rounding of 0 and whose
    backward is relu's under that mask. An f32 forward on the card and one
    on the CPU can put a pre-activation within 1e-7 of 0 on either side of
    the kink, and the gradients of the two branches then differ by that
    element's whole upstream gradient, far outside the train contract
    (phase 11, PERF.md §6). ``flips`` counts the card's own decisions that
    the recorded ones replaced, of ``total``; ``crossed`` lists each such
    pre-activation as (CPU, card)."""

    def __init__(self, torch):
        self.torch, self.real = torch, torch.relu
        self.inputs, self.i, self.flips, self.total, self.crossed = [], None, 0, 0, []

    def __enter__(self):
        self.torch.relu = self
        return self

    def __exit__(self, *exc):
        self.torch.relu = self.real

    def replay(self):
        self.i = 0

    def __call__(self, x):
        if self.i is None:
            self.inputs.append(x.detach().clone())
            return self.real(x)
        recorded = self.inputs[self.i].to(x.device)
        self.i += 1
        mask = recorded > 0
        flip = (x.detach() > 0) != mask
        self.flips += int(flip.sum())
        self.total += mask.numel()
        self.crossed += list(zip(recorded[flip].tolist(), x.detach()[flip].tolist()))
        return x * mask


def score_lines(path):
    return [line for line in Path(path).read_text().splitlines() if " —— epoch " in line]


def run_quiet(fn, *args):
    """``fn(*args)`` with its standard output caught; returns that output."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def in_dir(path, fn, *args):
    """``fn(*args)`` from the working directory ``path``."""
    here = os.getcwd()
    os.chdir(path)
    try:
        return fn(*args)
    finally:
        os.chdir(here)


def state_arrays(np, path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def rank1_timings(torch, card, dev, rank1_kernel, rank1_seed):
    """Phase 8's readings of the rank-1 kernel at [2, TRAIN_B, 128], p = 0.2,
    printed, and ``(wrapper ms of a pair, plain ms, bound, SDPA ms of a
    pair)`` returned; its tensors are freed on return, before the train
    step's peak memory is read."""
    RANK1 = rank1_kernel.NAME
    *ins, g_out = rank1_inputs(torch, TRAIN_B, dev, seed=5)
    x1, x2, wq, wk = ins
    rb, rf = rank1_bound(TRAIN_B), rank1_floor(TRAIN_B)
    r1 = rank1_kernel.Rank1Kernel(wq, wk, rank1_seed, 0.2)
    fwd = lambda: r1.forward(x1, x2, 3)
    bwd = lambda: r1.backward(x1, x2, 3, g_out)
    r1_fwd_ms, r1_bwd_ms = cuda_ms(torch, fwd), cuda_ms(torch, bwd)
    r1_fwd_dev, r1_bwd_dev = cuda_graph_ms(torch, fwd), cuda_graph_ms(torch, bwd)
    r1_dev = r1_fwd_dev + r1_bwd_dev

    def plain_fwd_bwd():
        xs = [x.clone().requires_grad_() for x in ins]
        torch.autograd.grad(rank1_kernel.rank1_attention_ref(*xs, rank1_seed, 3, 0.2),
                            xs, g_out)

    r1_plain_fwd = cuda_ms(torch, lambda: rank1_kernel.rank1_attention_ref(
        *ins, rank1_seed, 3, 0.2))
    r1_plain_ms = cuda_ms(torch, plain_fwd_bwd)
    rank1_ms = r1_fwd_ms + r1_bwd_ms
    print(f"[time] {card} | {RANK1} [2, {TRAIN_B}, 128] p=0.2: forward {r1_fwd_ms:.4f} ms "
          f"a wrapper call, {r1_fwd_dev:.4f} of device time; backward {r1_bwd_ms:.4f} "
          f"and {r1_bwd_dev:.4f}; plain version forward {r1_plain_fwd:.4f}, forward "
          f"and autograd backward {r1_plain_ms:.4f}; bound forward {rb['fwd'][0]:.5f} "
          f"({rb['fwd'][2]}), backward {rb['bwd'][0]:.5f} ({rb['bwd'][2]}), both "
          f"{rb['both'][0]:.5f} ({rb['both'][2]}); device time "
          f"{100 * rb['both'][0] / r1_dev:.1f}% of the bound")
    print(f"[time] {card} | {RANK1} own floor: forward {rf['fwd'][0]:.5f} ms "
          f"({rf['fwd'][1]}), backward {rf['bwd'][0]:.5f} ({rf['bwd'][1]}), both "
          f"{rf['both'][0]:.5f}; device time {100 * rf['fwd'][0] / r1_fwd_dev:.1f}% of "
          f"it forward, {100 * rf['bwd'][0] / r1_bwd_dev:.1f}% backward, "
          f"{100 * rf['both'][0] / r1_dev:.1f}% both")

    # the CUDA launches of a forward and backward pair through autograd
    xs = [t.clone().requires_grad_() for t in ins]
    pair_kernel = rank1_kernel.Rank1Kernel(xs[2], xs[3], rank1_seed, 0.2)
    pair = lambda: torch.autograd.grad(pair_kernel(xs[0], xs[1], 3), xs, g_out)
    pair()
    pair_launches = traced_launches(torch, pair, 10)
    print(f"[profile] {card} | {RANK1} forward and backward through autograd: "
          + (f"{pair_launches[0]:g} CUDA kernels a pair over 10 pairs "
             f"({pair_launches[1]})" if pair_launches else
             "not measured (the trace lost a marker kernel)"))
    if pair_launches:
        check(pair_launches[0] == 2 and all("rank1_" in k for k in pair_launches[1]),
              f"{RANK1}: a pair is not one forward and one backward kernel")

    # the wrapper's host time a call, split: the per-step checks, the
    # allocations, the ctypes launch, and what autograd adds to a pair
    def host_us(fn, n=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        return (t1 - t0) / n / 1e3

    z_out = torch.empty_like(x1)
    dx_out = torch.empty((2, 2, TRAIN_B, 128), device=dev)
    dw_out = torch.empty((2, 2, 128), device=dev)
    host = {
        "checks forward": host_us(lambda: r1.check(x1, x2)),
        "checks backward": host_us(lambda: r1.check(x1, x2, g_out)),
        "allocation forward": host_us(lambda: torch.empty_like(x1)),
        "allocation backward": host_us(lambda: (
            torch.empty((2, 2, TRAIN_B, 128), device=dev),
            torch.empty((2, 2, 128), device=dev))),
        "ctypes launch forward": host_us(lambda: r1.launch_fwd(x1, x2, 3, z_out)),
        "ctypes launch backward": host_us(
            lambda: r1.launch_bwd(x1, x2, 3, g_out, dx_out, dw_out)),
        "pair without autograd": host_us(lambda: (fwd(), bwd())),
        "pair through autograd": host_us(pair),
    }
    host["autograd"] = host["pair through autograd"] - host["pair without autograd"]
    print(f"[time] {card} | {RANK1} wrapper host time, us a call (perf_counter_ns over "
          "2000 calls): " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))

    # the library yardstick: F.scaled_dot_product_attention on the same
    # function (rank1_sdpa_qkv's padded q, k, v made outside the timing)
    q, k, v = (t.detach() for t in rank1_sdpa_qkv(torch, *ins))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    gz = torch.nn.functional.pad(g_out[..., None], (0, 7))
    sdpa_fwd = lambda: rank1_sdpa_call(torch, q, k, v, 0.2)
    sdpa_pair = lambda: torch.autograd.grad(
        torch.nn.functional.scaled_dot_product_attention(
            *qkv, dropout_p=0.2, scale=1.0), qkv, gz)
    sdpa_ms = {"forward": cuda_ms(torch, sdpa_fwd), "both": cuda_ms(torch, sdpa_pair)}
    sdpa_dev = {}
    for part, fn in (("forward", sdpa_fwd), ("both", sdpa_pair)):
        try:
            sdpa_dev[part] = f"{cuda_graph_ms(torch, fn):.4f}"
        except RuntimeError as err:  # a backend that a graph cannot capture
            sdpa_dev[part] = f"not measured ({str(err).splitlines()[0][:80]})"
            torch.cuda.synchronize()
    _, _, events = device_profile(torch, sdpa_pair, 1)
    names = " ".join(e.key.lower() for e in events)
    backend = ("flash" if "flash" in names else "cuDNN" if "cudnn" in names
               else "memory-efficient" if "fmha" in names or "efficient" in names
               else "math")
    print(f"[time] {card} | {RANK1} library yardstick F.scaled_dot_product_attention "
          f"[2, {TRAIN_B}, 128, 8], p=0.2, {backend} backend: forward "
          f"{sdpa_ms['forward']:.4f} ms a call, {sdpa_dev['forward']} of device time; "
          f"forward and backward {sdpa_ms['both']:.4f} and {sdpa_dev['both']}; the "
          f"kernel's pair {rank1_ms:.4f} and {r1_dev:.4f}; kernels: "
          + ", ".join(f"{e.key[:50]} x{e.count}" for e in events))

    return rank1_ms, r1_plain_ms, rb, sdpa_ms["both"]


def loop_ms(torch, module, fn_name, trainer, batch):
    """``(forward ms, backward ms)`` of a model's recurrence loop inside a
    train step at ``batch``: ``module.fn_name`` (``marn_variants.
    fused_directions``, ``marn_newz.recurrence``, ``dialogue_rnn.
    recurrence``, ``hybrid_rnn.recurrence``) called again on the
    arguments one train forward gave it, their tensors made leaves so the
    backward stops there, timed with CUDA events (median of 3); the backward
    of a random output gradient through those leaves and the parameters the
    loop reads."""
    real, seen = getattr(module, fn_name), []
    setattr(module, fn_name, lambda *a: seen.append(a) or real(*a))
    try:
        with torch.no_grad():
            trainer.model.train()(*trainer.predictor.batch_inputs(batch),
                                  generator=trainer.generator)
    finally:
        setattr(module, fn_name, real)

    def leaf(a):
        if torch.is_tensor(a):
            return a.detach().requires_grad_() if a.is_floating_point() else a
        return type(a)(map(leaf, a)) if isinstance(a, (tuple, list)) else a
    args = tuple(map(leaf, seen[0]))
    run = lambda: real(*args)  # noqa: E731
    fwd_ms = cuda_ms(torch, run, warmup=1, iters=3)
    ys = run()
    ys = ys[0] if isinstance(ys, tuple) else ys  # DialogueRNN's emotions
    gy = torch.randn_like(ys)
    bwd_ms = cuda_ms(torch, lambda: ys.backward(gy, retain_graph=True), warmup=1, iters=3)
    trainer.optimizer.zero_grad(set_to_none=True)
    return fwd_ms, bwd_ms


def kernel_split(events, n):
    """``(kernel launches, busy ms, rank-1 ms)`` a call from ``n`` calls'
    profiler events."""
    kernels = [e for e in events if "Memcpy" not in e.key and "Memset" not in e.key]
    return (sum(e.count for e in kernels) / n,
            sum(e.self_device_time_total for e in events) / n / 1e3,
            sum(e.self_device_time_total for e in events if "rank1_" in e.key) / n / 1e3)


def variant_phase(torch, card, eval_batch, meld_test, names):
    """Phase 9 (the module docstring); returns the rank-1 kernel's launches
    by path, each counted from 0 just before its run."""
    from ser_tpu_torch.data.synthetic import synthetic_batch
    from ser_tpu_torch.models import marn_variants
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels.rank1 import NAME as RANK1
    from ser_tpu_torch.ops.layers import Dropout
    from ser_tpu_torch.serving import Predictor
    from ser_tpu_torch.train.trainer import ModelTrainer

    T = eval_batch["qmask"].shape[0]
    n_utts = int(eval_batch["umask"].sum())
    train_batch = synthetic_batch(L=TRAIN_L, B=TRAIN_B, seed=1, min_len=min(20, TRAIN_L))
    meld_batch = next(iter(meld_test))
    launches = {}
    for name in names:
        # (a) a feature request at the IEMOCAP eval shape, card against CPU
        spec = get_model_spec(name)
        x, qmask, umask = spec.make_inputs(eval_batch)
        gpu = Predictor(name, seed=0, device="cuda")
        cpu = Predictor(name, state_dict={k: v.cpu() for k, v in gpu.model.state_dict().items()},
                        device="cpu")
        reset_launches()
        logp = gpu.predict(x, qmask, umask)[0]
        torch.cuda.synchronize()
        req_launches = dict(LAUNCHES)
        launches[f"{name} request [{T}, {x.shape[1]}]"] = req_launches.get(RANK1, 0)
        logp = logp.cpu()
        ref = cpu.predict(x, qmask, umask)[0]
        err = (logp - ref).abs().max().item()
        print(f"[variant] {name} request [{T}, {x.shape[1]}]: launches {req_launches}, "
              f"max|gpu-cpu| {err:.3e}")
        check(torch.isfinite(logp).all().item() and logp.shape == ref.shape,
              f"{name}: non-finite or misshapen log-probs")
        check(req_launches == {RANK1: T}, f"{name}: a request launched {req_launches}, "
              f"want {RANK1} {T} times")
        check(torch.allclose(logp, ref, rtol=1e-3, atol=1e-4),
              f"{name} request: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
        request = lambda: gpu.predict(x, qmask, umask)  # noqa: E731
        req_ms = cuda_ms(torch, request, warmup=2, iters=10)
        wall, busy, events = device_profile(torch, request, 3)
        n_kernels, busy_ms, r1_ms = kernel_split(events, 3)
        print(f"[time] {card} | {name} request [{T}, {x.shape[1]}]: {req_ms:.4f} ms "
              f"(median of 10), {n_utts / req_ms * 1e3:.1f} utterances/s; profile of 3: "
              f"{n_kernels:.0f} kernel launches a request, device busy {busy_ms:.4f} ms a "
              f"request, idle {100 * (1 - busy / wall):.1f}% of {wall / 3:.3f} ms, "
              f"{RANK1} {r1_ms:.4f} ms ({100 * r1_ms / busy_ms:.1f}% of busy)")
        # (c) a MELD request at P = 9 for sp and nsps
        if name in ("MARN1_sp", "MARN1_nsps"):
            gpu9 = Predictor(name, seed=0, device="cuda", n_classes=7)
            cpu9 = Predictor(name, state_dict={k: v.cpu() for k, v in
                                               gpu9.model.state_dict().items()},
                             device="cpu", n_classes=7)
            x9, q9, u9 = spec.make_inputs(meld_batch)
            reset_launches()
            logp9 = gpu9.predict(x9, q9, u9)[0]
            torch.cuda.synchronize()
            meld_launches = LAUNCHES[RANK1]
            launches[f"{name} MELD request {list(q9.shape)}"] = meld_launches
            err9 = (logp9.cpu() - cpu9.predict(x9, q9, u9)[0]).abs().max().item()
            print(f"[variant] {name} MELD request {list(q9.shape)}: {RANK1} launches "
                  f"{meld_launches}, max|gpu-cpu| {err9:.3e}")
            check(q9.shape[-1] == 9 and meld_launches == q9.shape[0],
                  f"{name}: a MELD request launched {RANK1} {meld_launches} times")
            check(torch.allclose(logp9.cpu(), cpu9.predict(x9, q9, u9)[0], rtol=1e-3,
                                 atol=1e-4), f"{name} MELD request: card and CPU disagree")
            del gpu9, cpu9
        del gpu, cpu

        # (b) train steps at [110, 80]: launches, time, peak memory, profile,
        #     the recurrence's share
        trainer = ModelTrainer(model=name, seed=0, lr=TRAIN_LR)
        step = lambda: trainer._train_step_impl(train_batch, TRAIN_LR)  # noqa: E731
        step()
        torch.cuda.synchronize()
        reset_launches()
        step()
        torch.cuda.synchronize()
        step_launches = dict(LAUNCHES)
        launches[f"{name} train step [{TRAIN_L}, {TRAIN_B}]"] = step_launches.get(RANK1, 0)
        want = 2 * TRAIN_L - (name in Z_NOT_IN_OUTPUT)
        check(step_launches == {RANK1: want}, f"{name}: a train step launched "
              f"{step_launches}, want {RANK1} {want} times")
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(torch, step, warmup=0, iters=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall, busy, events = device_profile(torch, step, 1)
        n_kernels, busy_ms, r1_ms = kernel_split(events, 1)
        # the recurrence's share, between two readings of the step: the
        # host's speed drifts within a call
        fwd_ms, bwd_ms = loop_ms(torch, marn_variants, "fused_directions", trainer,
                                 train_batch)
        step_again_ms = cuda_ms(torch, step, warmup=0, iters=3)
        share = 200 * (fwd_ms + bwd_ms) / (step_ms + step_again_ms)
        print(f"[time] {card} | {name} train step [{TRAIN_L}, {TRAIN_B}]: {step_ms:.2f} ms "
              f"(median of 3), peak {peak:.4f} GiB, {RANK1} launches a step "
              f"{step_launches[RANK1]}; profile of one step: {n_kernels:.0f} kernel "
              f"launches, wall {wall:.2f} ms, busy {busy_ms:.3f} ms (idle "
              f"{100 * (1 - busy / wall):.1f}%), {RANK1} {r1_ms:.4f} ms; then the "
              f"recurrence forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms, then the "
              f"step {step_again_ms:.2f} ms: the recurrence {share:.1f}% of a step")
        del trainer, step

        # one step card against CPU, dropout off, constants made random
        L_c, B_c = (TRAIN_L, TRAIN_B) if name == "MARN1_sp" else VARIANT_CHECK_SHAPE
        check_batch = synthetic_batch(L=L_c, B=B_c, seed=2, min_len=L_c // 2)
        trainers = {d: ModelTrainer(device=d, model=name, seed=0, lr=TRAIN_LR)
                    for d in ("cpu", "cuda")}
        randomize_constants(torch, [t.model for t in trainers.values()], seed=1)
        loss = {}
        t0 = time.perf_counter()
        for d, t in trainers.items():
            no_dropout(t.model, Dropout)
            reset_launches()
            loss[d] = t._train_step_impl(check_batch, TRAIN_LR).item()
        torch.cuda.synchronize()
        check_launches = LAUNCHES[RANK1]
        worst, dead_cpu, dead_card = grad_check(torch, trainers["cpu"].model,
                                                trainers["cuda"].model)
        moved = max((p.detach().cpu() - q.detach()).abs().max().item() for p, q in zip(
            trainers["cuda"].model.parameters(), trainers["cpu"].model.parameters()))
        loss_rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        print(f"[variant] {name} one step [{L_c}, {B_c}] card vs CPU ({time.perf_counter() - t0:.1f} "
              f"s): |loss| rel {loss_rel:.3e}, gradients {worst:.3f} of the tolerance, "
              f"{len(dead_card)} parameters with no gradient, max |param card - CPU| after "
              f"Adam {moved / TRAIN_LR:.3f} lr, {RANK1} launches {check_launches}")
        check(loss_rel <= TRAIN_LOSS_RTOL, f"{name} step loss: card and CPU disagree")
        check(worst <= 1.0, f"{name} step gradients: card and CPU disagree")
        check(dead_cpu == dead_card and len(dead_card) == VARIANT_DEAD[name],
              f"{name} dead parameters: CPU {len(dead_cpu)}, card {len(dead_card)}, "
              f"want {VARIANT_DEAD[name]}")
        check(moved <= 2.05 * TRAIN_LR, f"{name} Adam updates: card and CPU differ")
        check(check_launches == 2 * L_c - (name in Z_NOT_IN_OUTPUT),
              f"{name}: {RANK1} {check_launches} launches in a step of T={L_c}")
        del trainers

    # (d) the train CLI on the card, then the predict CLI on its checkpoint
    _, params_csv, rep = train_predict_cli("MARN1_nsps")
    p_weights = rep["fusion_weights"]["p"]
    print(f"[cli] MARN1_nsps softmax(p) {p_weights}")
    check(params_csv[0] == "p" and len(params_csv) == 3,
          f"train CLI MARN1_nsps: parameters.csv {params_csv}")
    check(len(p_weights) == 2 and abs(sum(p_weights) - 1) < 1e-6, "softmax(p) in the JSON")
    return launches


def train_predict_cli(name):
    """The train CLI (``python -m ser_tpu_torch.train --model name
    --synthetic --epoch 2``) on the card in this process, then the predict
    CLI on its epoch-2 checkpoint, which must report ``score.txt``'s Acc and
    F1. Returns ``(score lines, parameters.csv lines, predict JSON)``."""
    from ser_tpu_torch import predict as predict_cli
    from ser_tpu_torch.train import __main__ as train_cli

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        exp = tmp / "exp"
        t0 = time.perf_counter()
        run_quiet(in_dir, tmp, train_cli.main, train_cli.parser_args(
            ["--model", name, "--synthetic", "--epoch", "2", "--batch_size", str(TRAIN_B),
             "--save_path", str(exp)]))
        print(f"[cli] train CLI {name}, 2 epochs, in process: {time.perf_counter() - t0:.1f} s")
        lines = score_lines(exp / "score.txt")
        for line in lines:
            print(f"[cli]   score.txt: {line}")
        check(len(lines) == 2, f"train CLI {name}: {len(lines)} score lines")
        params_csv = (tmp / "parameters.csv").read_text().splitlines()
        out = run_quiet(predict_cli.main, [
            "--model", name, "--synthetic", "--initial_model",
            str(exp / "model" / "model_0002.model"), "--res_csv", str(tmp / "predict.csv")])
        check("is not in the model" not in out, "predict CLI skipped checkpoint names")
        rep = json.loads(out[out.index("{"):])
        scored = re.search(r"Acc ([\d.]+), Fscore ([\d.]+)", lines[1]).groups()
        predicted = (f"{rep['weighted_accuracy']:.2f}", f"{rep['weighted_f1']:.2f}")
        print(f"[cli] predict {name} on model_0002: Acc {predicted[0]}, F1 {predicted[1]}; "
              f"score.txt epoch 2: Acc {scored[0]}, Fscore {scored[1]}")
        check(predicted == scored, f"{name}: the predict CLI's Acc/F1 differ from score.txt's")
    return lines, params_csv, rep


def no_port_kernel(torch, what):
    """Fail unless every kernel counter of the port still reads 0."""
    from ser_tpu_torch.ops.kernels import LAUNCHES

    torch.cuda.synchronize()
    launched = {k: v for k, v in LAUNCHES.items() if v}
    check(not launched, f"{what} launched port kernels {launched}; none is on its path")


def f64_drift(torch, name, state, inputs, n_classes, card_out, cpu_out):
    """After a failed card-against-CPU request: the same request in f64 on
    the CPU, and how far the card's and the CPU's f32 outputs lie from it."""
    from ser_tpu_torch.models.registry import build_model, get_model_spec
    from ser_tpu_torch.ops.init import generator

    model = build_model(name, generator(0), n_classes)
    model.load_state_dict(state)
    model.double().eval()
    with torch.inference_mode():
        ref = get_model_spec(name).extract_logp(
            model(*(torch.as_tensor(a, dtype=torch.float64) for a in inputs)))
    print(f"[rest] {name} against f64 on the CPU: max|card - f64| "
          f"{(card_out.double() - ref).abs().max().item():.3e}, max|CPU f32 - f64| "
          f"{(cpu_out.double() - ref).abs().max().item():.3e}, max|f64| "
          f"{ref.abs().max().item():.3e}")


def step_f64_drift(torch, name, state, batch, trainers):
    """After a missed card-against-CPU train step: the same step's
    gradients in f64 on the CPU from ``state`` (dropout off); for the tensor
    where the card and the CPU part most against the tolerance, how far each
    f32 gradient lies from f64."""
    from ser_tpu_torch.models.registry import build_model, get_model_spec
    from ser_tpu_torch.ops.init import generator
    from ser_tpu_torch.ops.layers import Dropout
    from ser_tpu_torch.train.losses import masked_loss

    spec = get_model_spec(name)
    model = build_model(name, generator(0))
    model.load_state_dict(state)
    model.double().train()
    no_dropout(model, Dropout)
    x, qmask, umask = (torch.as_tensor(a, dtype=torch.float64) for a in spec.make_inputs(batch))
    logp = spec.extract_logp(model(x, qmask, umask, generator=torch.Generator()))
    masked_loss(logp, spec.rows(torch.as_tensor(batch["label"])), spec.rows(umask)).backward()
    g64 = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    cpu = {n: p.grad.double() for n, p in trainers["cpu"].model.named_parameters()
           if p.grad is not None}
    card = {n: p.grad.cpu().double() for n, p in trainers["cuda"].model.named_parameters()
            if p.grad is not None}
    top = max(g.abs().max().item() for g in cpu.values())
    frac = {n: (card[n] - g).abs().max().item()
            / (GRAD_RTOL * g.abs().max().item() + GRAD_FLOOR * top) for n, g in cpu.items()}
    n = max(frac, key=frac.get)
    print(f"[baseline] {name} against an f64 step on the CPU, at {n} ({frac[n]:.3f} of the "
          f"tolerance): max|CPU f32 - f64| {(cpu[n] - g64[n]).abs().max().item():.3e}, "
          f"max|card - f64| {(card[n] - g64[n]).abs().max().item():.3e}, max|f64| "
          f"{g64[n].abs().max().item():.3e}")


def rest_phase(torch, card, eval_batch, meld_test, names):
    """Phase 10 (the module docstring)."""
    import copy

    from ser_tpu_torch.data.synthetic import synthetic_batch
    from ser_tpu_torch.models import marn_newz, marn_variants
    from ser_tpu_torch.models.marn_newz import MARN1NewZ
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.ops.init import generator
    from ser_tpu_torch.ops.kernels import reset_launches
    from ser_tpu_torch.ops.layers import Dropout
    from ser_tpu_torch.serving import Predictor
    from ser_tpu_torch.streaming import NewZStream
    from ser_tpu_torch.train.trainer import ModelTrainer

    import numpy as np

    n_utts = int(eval_batch["umask"].sum())
    train_batch = synthetic_batch(L=TRAIN_L, B=TRAIN_B, seed=1, min_len=min(20, TRAIN_L))
    meld_batch = next(iter(meld_test))
    for name in names:
        # (a) a feature request at the IEMOCAP eval shape and (c) for mf and
        #     newz a MELD request, card against CPU, no kernel of the port
        spec = get_model_spec(name)
        requests = [("request", eval_batch, 6)]
        if name in ("MARN1_mf", "MARN1_newz"):
            requests.append(("MELD request", meld_batch, 7))
        for label, batch, C in requests:
            inputs = spec.make_inputs(batch)
            shape = list(inputs[1].shape)
            gpu = Predictor(name, seed=0, device="cuda", n_classes=C)
            state = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
            cpu = Predictor(name, state_dict=state, device="cpu", n_classes=C)
            reset_launches()
            out = gpu.predict(*inputs)[0]
            no_port_kernel(torch, f"{name} {label}")
            out, ref = out.cpu(), cpu.predict(*inputs)[0]
            err = (out - ref).abs().max().item()
            ok = torch.allclose(out, ref, rtol=1e-3, atol=1e-4)
            print(f"[rest] {name} {label} {shape}: no port kernel launched, max|gpu-cpu| "
                  f"{err:.3e}, max|out| {ref.abs().max().item():.3e}")
            if not ok:
                f64_drift(torch, name, state, inputs, C, out, ref)
            check(torch.isfinite(out).all().item() and out.shape == ref.shape,
                  f"{name} {label}: non-finite or misshapen outputs")
            check(ok, f"{name} {label}: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
            if label == "request":
                request = lambda: gpu.predict(*inputs)  # noqa: E731
                req_ms = cuda_ms(torch, request, warmup=2, iters=10)
                wall, busy, events = device_profile(torch, request, 3)
                n_kernels, busy_ms, _ = kernel_split(events, 3)
                print(f"[time] {card} | {name} request {shape[:2]}: {req_ms:.4f} ms "
                      f"(median of 10), {n_utts / req_ms * 1e3:.1f} utterances/s; profile "
                      f"of 3: {n_kernels:.0f} kernel launches a request, device busy "
                      f"{busy_ms:.4f} ms a request, idle {100 * (1 - busy / wall):.1f}% of "
                      f"{wall / 3:.3f} ms")
            del gpu, cpu

        # (b) train steps at [110, 80]: no kernel of the port, time, peak
        #     memory, profile, the recurrence loop's share
        trainer = ModelTrainer(model=name, seed=0, lr=TRAIN_LR)
        step = lambda: trainer._train_step_impl(train_batch, TRAIN_LR)  # noqa: E731
        reset_launches()
        step()  # also the warm-up
        no_port_kernel(torch, f"{name} train step")
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(torch, step, warmup=0, iters=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall, busy, events = device_profile(torch, step, 1)
        n_kernels, busy_ms, _ = kernel_split(events, 1)
        loop = ((marn_newz, "recurrence") if name == "MARN1_newz"
                else (marn_variants, "fused_directions"))
        fwd_ms, bwd_ms = loop_ms(torch, *loop, trainer, train_batch)
        step_again_ms = cuda_ms(torch, step, warmup=0, iters=3)
        share = 200 * (fwd_ms + bwd_ms) / (step_ms + step_again_ms)
        print(f"[time] {card} | {name} train step [{TRAIN_L}, {TRAIN_B}]: {step_ms:.2f} ms "
              f"(median of 3), peak {peak:.4f} GiB; profile of one step: {n_kernels:.0f} "
              f"kernel launches, wall {wall:.2f} ms, busy {busy_ms:.3f} ms (idle "
              f"{100 * (1 - busy / wall):.1f}%); then the loop forward {fwd_ms:.2f} ms, "
              f"backward {bwd_ms:.2f} ms, then the step {step_again_ms:.2f} ms: the loop "
              f"{share:.1f}% of a step")
        del trainer, step

        # one step card against CPU, dropout off, constants made random
        L_c, B_c = VARIANT_CHECK_SHAPE
        check_batch = synthetic_batch(L=L_c, B=B_c, seed=2, min_len=L_c // 2)
        trainers = {d: ModelTrainer(device=d, model=name, seed=0, lr=TRAIN_LR)
                    for d in ("cpu", "cuda")}
        randomize_constants(torch, [t.model for t in trainers.values()], seed=1)
        loss = {}
        reset_launches()
        for d, t in trainers.items():
            no_dropout(t.model, Dropout)
            loss[d] = t._train_step_impl(check_batch, TRAIN_LR).item()
        no_port_kernel(torch, f"{name} check step")
        worst, dead_cpu, dead_card = grad_check(torch, trainers["cpu"].model,
                                                trainers["cuda"].model)
        moved = max((p.detach().cpu() - q.detach()).abs().max().item() for p, q in zip(
            trainers["cuda"].model.parameters(), trainers["cpu"].model.parameters()))
        loss_rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        print(f"[rest] {name} one step [{L_c}, {B_c}] card vs CPU: |loss| rel "
              f"{loss_rel:.3e}, gradients {worst:.3f} of the tolerance, {len(dead_card)} "
              f"parameters with no gradient, max |param card - CPU| after Adam "
              f"{moved / TRAIN_LR:.3f} lr")
        check(loss_rel <= TRAIN_LOSS_RTOL, f"{name} step loss: card and CPU disagree")
        check(worst <= 1.0, f"{name} step gradients: card and CPU disagree")
        check(dead_cpu == dead_card and len(dead_card) == REST_DEAD[name],
              f"{name} dead parameters: CPU {len(dead_cpu)}, card {len(dead_card)}, "
              f"want {REST_DEAD[name]}")
        check(moved <= 2.05 * TRAIN_LR, f"{name} Adam updates: card and CPU differ")
        del trainers

    # (d) newz streamed: one dialogue of IEMOCAP's longest length through
    #     NewZStream on the card, against its causal batch forward on the
    #     card and the stream on the CPU; ms a new utterance, launches an
    #     append, the drift from the bidirectional forward
    x, qmask, _ = get_model_spec("MARN1_newz").make_inputs(
        synthetic_batch(L=STREAM_L, B=1, seed=5, min_len=STREAM_L))
    x, qmask = x[:, 0], qmask[:, 0]
    models = {"cpu": MARN1NewZ(generator=generator(0), causal_encoder=True).eval()}
    models["cuda"] = copy.deepcopy(models["cpu"]).cuda()
    streams = {d: NewZStream(m, max_len=STREAM_MAX_LEN) for d, m in models.items()}
    stream = streams["cuda"]
    stream.append(x[0], qmask[0])  # warm-up
    stream.reset()
    reset_launches()
    t_per, logits = [], []
    for t in range(STREAM_L):
        t0 = time.perf_counter()
        logits.append(stream.append(x[t], qmask[t]))
        t_per.append((time.perf_counter() - t0) * 1e3)
    no_port_kernel(torch, "the newz stream")
    logits = np.stack(logits)
    cpu_logits = np.stack([streams["cpu"].append(x[t], qmask[t]) for t in range(STREAM_L)])
    xt, qt = torch.from_numpy(x[:, None]).cuda(), torch.from_numpy(qmask[:, None]).cuda()
    with torch.inference_mode():
        causal = models["cuda"](xt, qt)[0].cpu().numpy()
        models["cuda"].causal_encoder = False
        bidir = models["cuda"](xt, qt)[0].cpu().numpy()
    stream.reset()
    rows = iter(range(STREAM_L))
    wall, busy, events = device_profile(
        torch, lambda: (lambda t: stream.append(x[t], qmask[t]))(next(rows)), 20)
    n_kernels, busy_ms, _ = kernel_split(events, 20)
    err_causal = float(np.abs(logits - causal).max())
    err_cpu = float(np.abs(logits - cpu_logits).max())
    print(f"[time] {card} | MARN1_newz stream, {STREAM_L} utterances, max_len "
          f"{STREAM_MAX_LEN}: {statistics.median(t_per):.4f} ms a new utterance (median), "
          f"p90 {float(np.percentile(t_per, 90)):.4f}, first {t_per[0]:.4f}, last "
          f"{t_per[-1]:.4f}; profile of 20 appends: {n_kernels:.0f} kernel launches an "
          f"append, device busy {busy_ms:.4f} ms an append, idle "
          f"{100 * (1 - busy / wall):.1f}%")
    print(f"[rest] MARN1_newz stream: max|stream - causal batch forward| {err_causal:.3e}, "
          f"max|card - CPU stream| {err_cpu:.3e}; against the bidirectional forward: "
          f"argmax agreement {float((logits.argmax(-1) == bidir.argmax(-1)).mean()):.4f}, "
          f"max logit drift {float(np.abs(logits - bidir).max()):.4f}")
    check(np.isfinite(logits).all() and logits.shape == (STREAM_L, 6), "stream logits")
    check(np.allclose(logits, causal, rtol=1e-4, atol=1e-5),
          "the stream and its causal batch forward disagree beyond rtol 1e-4, atol 1e-5")
    check(np.allclose(logits, cpu_logits, rtol=1e-4, atol=1e-5),
          "the stream on the card and on the CPU disagree beyond rtol 1e-4, atol 1e-5")

    # (e) the CLIs: serve stream on the card; the newz train CLI, then the
    #     predict CLI on its checkpoint
    from ser_tpu_torch import serve as serve_cli

    t0 = time.perf_counter()
    out = run_quiet(serve_cli.main, ["stream", "--device", "cuda"])
    rep = json.loads(out[out.index("{"):])
    print(f"[cli] {card} | python -m ser_tpu_torch.serve stream --device cuda, in process: "
          f"{time.perf_counter() - t0:.1f} s: " + json.dumps(rep))
    check({"ms_per_new_utterance_median", "ms_per_new_utterance_p90",
           "argmax_agreement_vs_bidirectional", "max_logit_drift_vs_bidirectional",
           "contract"} <= set(rep), "serve stream's JSON keys")
    _, params_csv, rep = train_predict_cli("MARN1_newz")
    w = rep["fusion_weights"]["w"]
    print(f"[cli] MARN1_newz raw w {w}")
    check(params_csv[0] == "w" and len(params_csv) == 3,
          f"train CLI MARN1_newz: parameters.csv {params_csv}")
    check(len(w) == 2, "MARN1_newz's raw w in the JSON")


def baseline_phase(torch, card, eval_batch, meld_test, names):
    """Phase 11 (the module docstring). Returns the MFCC kernel's launches
    on DialogueRNN's wav path."""
    import copy

    import numpy as np

    from ser_tpu_torch import predict as predict_cli
    from ser_tpu_torch.compat.from_jax import to_jax_params
    from ser_tpu_torch.data.synthetic import generate_iemocap_pickles, synthetic_batch
    from ser_tpu_torch.models import dialogue_rnn, hybrid_rnn
    from ser_tpu_torch.models.dialogue_rnn import BiModel
    from ser_tpu_torch.models.registry import build_model, get_model_spec
    from ser_tpu_torch.ops.init import generator
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels.mfcc import NAME as MFCC
    from ser_tpu_torch.ops.layers import Dropout
    from ser_tpu_torch.serving import Predictor
    from ser_tpu_torch.train.metrics import weighted_accuracy
    from ser_tpu_torch.train.trainer import ModelTrainer

    n_utts = int(eval_batch["umask"].sum())
    train_batch = synthetic_batch(L=TRAIN_L, B=TRAIN_B, seed=1, min_len=min(20, TRAIN_L))
    meld_batch = next(iter(meld_test))
    loops = {"DialogueRNN": dialogue_rnn, "MARN_AT": hybrid_rnn, "MARN_ATV": hybrid_rnn}

    def card_against_cpu(name, label, inputs, n_classes):
        """One request on the card against the CPU on the same seeded
        weights, the valid rows at rtol 1e-3, atol 1e-4, no port kernel
        launched; returns the card's ``Predictor``."""
        spec = get_model_spec(name)
        gpu = Predictor(name, seed=0, device="cuda", n_classes=n_classes)
        state = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
        cpu = Predictor(name, state_dict=state, device="cpu", n_classes=n_classes)
        reset_launches()
        out = gpu.predict(*inputs)[0]
        no_port_kernel(torch, f"{name} {label}")
        out, ref = out.cpu(), cpu.predict(*inputs)[0]
        check(torch.isfinite(out).all().item() and out.shape == ref.shape,
              f"{name} {label}: non-finite or misshapen outputs")
        valid = torch.as_tensor(spec.rows(inputs[2])) > 0
        out, ref = out[valid], ref[valid]
        ok = torch.allclose(out, ref, rtol=1e-3, atol=1e-4)
        print(f"[baseline] {name} {label} {list(inputs[1].shape)}: no port kernel launched, "
              f"max|gpu-cpu| {(out - ref).abs().max().item():.3e} over {len(out)} valid rows "
              f"({spec.logp_layout} order), max|out| {ref.abs().max().item():.3e}")
        if not ok:
            f64_drift(torch, name, state, inputs, n_classes, out, ref)
        check(ok, f"{name} {label}: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
        return gpu

    for name in names:
        # (a) a feature request at the IEMOCAP eval shape, card against CPU,
        #     then its time, launches and idle share
        inputs = get_model_spec(name).make_inputs(eval_batch)
        gpu = card_against_cpu(name, "request", inputs, 6)
        request = lambda: gpu.predict(*inputs)  # noqa: E731
        req_ms = cuda_ms(torch, request, warmup=2, iters=10)
        wall, busy, events = device_profile(torch, request, 3)
        n_kernels, busy_ms, _ = kernel_split(events, 3)
        print(f"[time] {card} | {name} request {list(inputs[1].shape[:2])}: {req_ms:.4f} ms "
              f"(median of 10), {n_utts / req_ms * 1e3:.1f} utterances/s; profile of 3: "
              f"{n_kernels:.0f} kernel launches a request, device busy {busy_ms:.4f} ms a "
              f"request, idle {100 * (1 - busy / wall):.1f}% of {wall / 3:.3f} ms")
        del gpu, request
        # (c) BiLSTM, MARN_AT and MARN_ATV on the MELD request, P = 9
        if name in ("BiLSTM", "MARN_AT", "MARN_ATV"):
            card_against_cpu(name, "MELD request", get_model_spec(name).make_inputs(meld_batch),
                             7)

        # (b) train steps at [110, 80]: no kernel of the port, time, peak
        #     memory, profile, the recurrence loop's share
        trainer = ModelTrainer(model=name, seed=0, lr=TRAIN_LR)
        step = lambda: trainer._train_step_impl(train_batch, TRAIN_LR)  # noqa: E731
        reset_launches()
        step()  # also the warm-up
        no_port_kernel(torch, f"{name} train step")
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(torch, step, warmup=0, iters=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall, busy, events = device_profile(torch, step, 1)
        n_kernels, busy_ms, _ = kernel_split(events, 1)
        line = (f"[time] {card} | {name} train step [{TRAIN_L}, {TRAIN_B}]: {step_ms:.2f} ms "
                f"(median of 3), peak {peak:.4f} GiB; profile of one step: {n_kernels:.0f} "
                f"kernel launches, wall {wall:.2f} ms, busy {busy_ms:.3f} ms (idle "
                f"{100 * (1 - busy / wall):.1f}%)")
        if name in loops:
            fwd_ms, bwd_ms = loop_ms(torch, loops[name], "recurrence", trainer, train_batch)
            step_again_ms = cuda_ms(torch, step, warmup=0, iters=3)
            share = 200 * (fwd_ms + bwd_ms) / (step_ms + step_again_ms)
            line += (f"; then the loop forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms, "
                     f"then the step {step_again_ms:.2f} ms: the loop {share:.1f}% of a step")
        print(line)
        del trainer, step

        # one step card against CPU, dropout off, constants made random:
        # first as it is (reported; on a miss both sides against an f64
        # step), then with the card taking the CPU step's ReLU decisions
        # (PinnedRelu; checked)
        L_c, B_c = VARIANT_CHECK_SHAPE
        check_batch = synthetic_batch(L=L_c, B=B_c, seed=2, min_len=L_c // 2)
        for pinned in (False, True):
            trainers = {d: ModelTrainer(device=d, model=name, seed=0, lr=TRAIN_LR)
                        for d in ("cpu", "cuda")}
            randomize_constants(torch, [t.model for t in trainers.values()], seed=1)
            start = copy.deepcopy(trainers["cpu"].model.state_dict())
            loss = {}
            reset_launches()
            with PinnedRelu(torch) as relu:
                for d, t in trainers.items():  # the CPU first, then the card
                    no_dropout(t.model, Dropout)
                    loss[d] = t._train_step_impl(check_batch, TRAIN_LR).item()
                    if pinned:
                        relu.replay()
            no_port_kernel(torch, f"{name} check step")
            worst, dead_cpu, dead_card = grad_check(torch, trainers["cpu"].model,
                                                    trainers["cuda"].model)
            if not pinned:
                print(f"[baseline] {name} one step [{L_c}, {B_c}] card vs CPU, each its own "
                      f"ReLU decisions: gradients {worst:.3f} of the tolerance")
                if worst > 1.0:
                    step_f64_drift(torch, name, start, check_batch, trainers)
                continue
            moved = max((p.detach().cpu() - q.detach()).abs().max().item() for p, q in zip(
                trainers["cuda"].model.parameters(), trainers["cpu"].model.parameters()))
            loss_rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
            print(f"[baseline] {name} one step [{L_c}, {B_c}] card vs CPU, the CPU's ReLU "
                  f"decisions: |loss| rel {loss_rel:.3e}, gradients {worst:.3f} of the "
                  f"tolerance, {len(dead_card)} parameters with no gradient, max |param card "
                  f"- CPU| after Adam {moved / TRAIN_LR:.3f} lr; {relu.flips} of the card's "
                  f"{relu.total} ReLU decisions replaced, pre-activations (CPU, card) "
                  f"{relu.crossed[:4]}")
            check(relu.flips <= 1e-5 * relu.total, f"{name}: the card's forward crossed "
                  f"{relu.flips} ReLU kinks, more than rounding explains")
            check(loss_rel <= TRAIN_LOSS_RTOL, f"{name} step loss: card and CPU disagree")
            check(worst <= 1.0, f"{name} step gradients: card and CPU disagree")
            check(dead_cpu == dead_card and len(dead_card) == BASELINE_DEAD[name],
                  f"{name} dead parameters: CPU {len(dead_cpu)}, card {len(dead_card)}, "
                  f"want {BASELINE_DEAD[name]}")
            check(moved <= 2.05 * TRAIN_LR, f"{name} Adam updates: card and CPU differ")
        del trainers

    # (c) BiModel alone at P = 9 on a 712-wide input at the MELD request's
    #     qmask and umask, as tests/test_p9_parity.py builds it (7 classes)
    qmask9, umask9 = meld_batch["qmask"], meld_batch["umask"]
    L9, B9 = qmask9.shape[:2]
    x9 = (np.random.default_rng(9).standard_normal((L9, B9, 712)).astype(np.float32)
          * umask9.T[:, :, None])
    models = {"cpu": BiModel(n_classes=7, generator=generator(0)).eval()}
    models["cuda"] = copy.deepcopy(models["cpu"]).cuda()
    reset_launches()
    with torch.inference_mode():
        outs = {d: m(*(torch.as_tensor(a, device=next(m.parameters()).device)
                       for a in (x9, qmask9, umask9)))[0].cpu() for d, m in models.items()}
    no_port_kernel(torch, "BiModel at P = 9")
    valid = torch.as_tensor(umask9.T) > 0
    out, ref = outs["cuda"][valid], outs["cpu"][valid]
    print(f"[baseline] BiModel P=9 [{L9}, {B9}, 712], 7 classes: max|gpu-cpu| "
          f"{(out - ref).abs().max().item():.3e} over {len(out)} valid rows")
    check(torch.isfinite(outs["cuda"]).all().item(), "BiModel at P = 9: non-finite outputs")
    check(torch.allclose(out, ref, rtol=1e-3, atol=1e-4),
          "BiModel at P = 9: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
    del models, outs

    # (d) the wav path: the predict CLI with DialogueRNN and the MFCC front
    #     end on the card in this process (the kernel's launches counted),
    #     against --device cpu on the same pickles
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drnn_wav_") as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "dialogue_rnn_seed0.npz"
        np.savez(ckpt, **to_jax_params(build_model("DialogueRNN", generator(0)).state_dict()))
        feature_path = generate_iemocap_pickles(str(tmp / "pickles"), seed=PREDICT_SEED,
                                                with_wav=True)
        base = ["--model", "DialogueRNN", "--audio_frontend", "mfcc", "--initial_model",
                str(ckpt)]
        reset_launches()
        t0 = time.perf_counter()
        out = run_quiet(predict_cli.main, base + ["--synthetic", "--res_csv",
                                                  str(tmp / "cuda.csv")])
        torch.cuda.synchronize()
        wav_launches = {k: v for k, v in LAUNCHES.items() if v}
        cuda_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_cpu = run_quiet(predict_cli.main, base + ["--feature_path", feature_path,
                                                      "--device", "cpu", "--res_csv",
                                                      str(tmp / "cpu.csv")])
        cpu_s = time.perf_counter() - t0
        rep = json.loads(out[out.index("{"):])
        rep_cpu = json.loads(out_cpu[out_cpu.index("{"):])
        preds, labels, masks = read_res_csv(tmp / "cuda.csv")
        cpu_preds, cpu_labels, cpu_masks = read_res_csv(tmp / "cpu.csv")
    n_batches = math.ceil(rep["n_examples"] / 80)  # the CLI's default --batch_size
    valid = [i for i, m in enumerate(masks) if m > 0]
    flips = sum(preds[i] != cpu_preds[i] for i in valid)
    print(f"[cli] {card} | predict --model DialogueRNN --synthetic --audio_frontend mfcc, in "
          f"process: card {cuda_s:.1f} s, launches {wav_launches}; CPU {cpu_s:.1f} s; "
          f"predictions differ on {flips} of {len(valid)} valid utterances; card "
          f"{json.dumps(rep)}; CPU {json.dumps(rep_cpu)}")
    check(wav_launches == {MFCC: n_batches},
          f"DialogueRNN's wav path launched {wav_launches}, want {MFCC} once a batch "
          f"({n_batches})")
    check("is not in the model" not in out + out_cpu, "predict CLI skipped checkpoint names")
    check(labels == cpu_labels and masks == cpu_masks,
          "the card and CPU runs read different pickles")
    check(all(math.isfinite(rep[k]) for k in ("weighted_accuracy", "weighted_f1")),
          "non-finite CLI metrics")
    check(rep["weighted_accuracy"] == weighted_accuracy(labels, preds, masks),
          "CLI accuracy does not match its res.csv")
    check(flips <= 0.001 * len(valid), "card and CPU predictions differ on more than 0.1% "
          "of the valid utterances")

    # (e) the train CLI for 2 epochs, then the predict CLI on its checkpoint:
    #     DialogueRNN, and MARN_ATV for the time-major rows
    for name in ("DialogueRNN", "MARN_ATV"):
        reset_launches()
        _, _, rep = train_predict_cli(name)
        no_port_kernel(torch, f"the {name} CLIs")
        check(rep["fusion_weights"] == {}, f"{name} has no fusion weights")
    return wav_launches[MFCC]


# phase 12: the onlysp artifact at serve.py export's default buckets, its
# requests (the first IEMOCAP eval dialogue alone, 8 and all 31 eval
# dialogues, the reference train shape) and the bucket each must pick
SERVE_L, SERVE_B = 110, (1, 8, 32, 80)
SERVE_REQUESTS = (("one dialogue", (110, 1)), ("8 dialogues", (110, 8)),
                  ("IEMOCAP eval", (110, 32)), ("train shape", (110, 80)))
# the other models' buckets: L = 82 admits the eval request without padding
# it in time, so a rank-1 variant's request runs its T = 82 steps
ZOO_SERVE_L, ZOO_SERVE_B = (82, 110), (1, 32)
# a bucket's graph replay against the eager forward on the same padded batch
REPLAY_ATOL = 1e-5
# the CLI artifact's L: the loader pads a batch to its length bucket, 128
# for IEMOCAP's longest dialogues (110 utterances)
CLI_SERVE_L = 128


def cut(batch, l, b):
    """The first ``b`` dialogues' first ``l`` steps of a padded batch."""
    return {k: (v[:b, :l] if k in ("umask", "label") else v[:l, :b])
            for k, v in batch.items() if k != "vid"}


def run_cli_json(fn, argv):
    """A CLI's ``main(argv)`` in this process; its last JSON object."""
    out = run_quiet(fn, argv)
    lines = out.strip().splitlines()
    start = next(i for i in range(len(lines) - 1, -1, -1) if lines[i].startswith("{"))
    return json.loads("\n".join(lines[start:])), out


def serve_run_card_and_cpu(torch, what, artifact, card_flags, cpu_flags):
    """``serve run`` of ``artifact`` on the card and on the CPU, in this
    process: both reports, the card's launches and the predictions'
    agreement on the valid rows (at least 0.999) printed; returns the card
    run's recurrence launches."""
    import numpy as np

    from ser_tpu_torch import serve as serve_cli
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels.lsthm import NAME
    from ser_tpu_torch.serving import ServingModel

    runs = []  # each run's predictions on its valid rows
    real_predict = ServingModel.predict

    def recording(self, batch):
        out = real_predict(self, batch)
        runs[-1].append(out["preds"][batch["umask"] > 0])
        return out

    ServingModel.predict = recording
    try:
        runs.append([])
        reset_launches()
        t0 = time.perf_counter()
        rep_card, _ = run_cli_json(serve_cli.main, ["run", "--artifact", artifact, *card_flags])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_launches = dict(LAUNCHES)
        runs.append([])
        rep_cpu, _ = run_cli_json(serve_cli.main, ["run", "--artifact", artifact,
                                                   "--device", "cpu", *cpu_flags])
    finally:
        ServingModel.predict = real_predict
    agree = float(np.mean(np.concatenate(runs[0]) == np.concatenate(runs[1])))
    print(f"[cli] serve run {what}: card {run_s:.1f} s, launches {run_launches}, "
          f"{rep_card['n_utterances']} utterances, Acc {rep_card['weighted_accuracy']:.4f} "
          f"F1 {rep_card['weighted_f1']:.4f}; CPU Acc {rep_cpu['weighted_accuracy']:.4f} "
          f"F1 {rep_cpu['weighted_f1']:.4f}; predictions agree on {agree:.5f} of valid rows")
    check(rep_card["n_utterances"] == rep_cpu["n_utterances"] > 0,
          f"serve run {what}: utterances {rep_card['n_utterances']} and "
          f"{rep_cpu['n_utterances']}")
    check(agree >= 0.999, f"serve run {what}: card and CPU agree on {agree}")
    check(run_launches.get(NAME, 0) >= 1, f"serve run {what} launched {run_launches}")
    return run_launches[NAME]


def serving_phase(torch, card, eval_batch, meld_path, keep_dir):
    """Phase 12 (the module docstring); the onlysp f32, bf16 and int8
    artifacts are written into ``keep_dir`` (phase 17 reads them). Returns
    the recurrence kernel's and the rank-1 kernel's launches by path, each
    counted from 0 just before its run."""
    import numpy as np

    from ser_tpu_torch import serve as serve_cli
    from ser_tpu_torch.compat.from_jax import to_jax_params
    from ser_tpu_torch.data.synthetic import generate_iemocap_pickles, synthetic_batch
    from ser_tpu_torch.models.registry import available_models
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels.lsthm import NAME
    from ser_tpu_torch.ops.kernels.rank1 import NAME as RANK1
    from ser_tpu_torch.serving import GRAPH_WARMUP, Predictor, ServingModel, save_model

    launches = {NAME: {}, RANK1: {}}
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_")
    tmp = Path(tmp_dir.name)
    n0 = int(eval_batch["umask"][0].sum())
    L_e, B_e = eval_batch["qmask"].shape[:2]
    batches = {"one dialogue": cut(eval_batch, n0, 1), "8 dialogues": cut(eval_batch, L_e, 8),
               "IEMOCAP eval": cut(eval_batch, L_e, B_e),
               "train shape": cut(synthetic_batch(L=TRAIN_L, B=TRAIN_B, seed=1, min_len=20),
                                  TRAIN_L, TRAIN_B)}

    # (a) onlysp f32 at full width: seeded weights with the reference's
    #     constant-initialised parameters made random (a served model is a
    #     trained one; with the sequence attentions' W all ones the tail sums
    #     cancel to ~1e-6, which bf16 cannot hold: PERF.md §6)
    gpu = Predictor(seed=0, device="cuda")
    randomize_constants(torch, [gpu.model], seed=3)
    weights = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    paths = {d: str(Path(keep_dir) / f"onlysp_{d}.ser") for d in ("f32", "bf16", "int8")}
    for dtype, path in paths.items():
        save_model(path, "MARN1_onlysp", weights, SERVE_L, SERVE_B, dtype=dtype)
    sizes = {d: os.path.getsize(p) for d, p in paths.items()}
    t0 = time.perf_counter()
    served = ServingModel.load(paths["f32"], device="cuda")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    cpu = ServingModel.load(paths["f32"], device="cpu")
    print(f"[serve] onlysp artifacts at L={SERVE_L}, B={list(SERVE_B)}: "
          + ", ".join(f"{d} {n} B" for d, n in sizes.items())
          + f"; f32 loaded onto the card in {load_ms:.1f} ms")
    f32_out, total = {}, 0
    for what, bucket in SERVE_REQUESTS:
        batch = batches[what]
        b, l = batch["umask"].shape
        reset_launches()
        t0 = time.perf_counter()
        out = served.predict(batch)
        torch.cuda.synchronize()
        first_ms, first = (time.perf_counter() - t0) * 1e3, dict(LAUNCHES)
        reset_launches()
        again = served.predict(batch)
        torch.cuda.synchronize()
        per_request = dict(LAUNCHES)
        total += per_request.get(NAME, 0)
        xp, qp, up = served.padded_inputs(batch, bucket)
        replay = served.bucket_forward(bucket, xp, qp, up)
        eager = gpu.predict(xp, qp, up)[0]
        err_eager = (replay - eager).abs().max().item()
        ref = cpu.predict(batch)
        err_cpu = float(np.abs(out["logp"] - ref["logp"]).max())
        graph = served.graph(bucket, xp.shape[-1], qp.shape[-1])
        replay_ms = cuda_ms(torch, graph.replay, warmup=2, iters=20)
        request_ms = cuda_ms(torch, lambda: served.predict(batch), warmup=1, iters=10)
        eager_ms = cuda_ms(torch, lambda: gpu.predict(xp, qp, up), warmup=1, iters=10)
        eager_request_ms = cuda_ms(torch, lambda: gpu.predict_batch(batch), warmup=1, iters=10)
        print(f"[serve] onlysp f32 {what} [{l}, {b}] -> bucket {list(served.last_bucket)}: "
              f"first request (warm-up, capture, replay) {first_ms:.1f} ms launching {first}, "
              f"then {per_request} a request; max|replay - eager| {err_eager:.3e}, "
              f"max|card - CPU| {err_cpu:.3e}, two replays bit-equal: "
              f"{np.array_equal(out['logp'], again['logp'])}")
        print(f"[time] {card} | onlysp f32 bucket {list(bucket)}: replay {replay_ms:.4f} ms; "
              f"request [{l}, {b}] served {request_ms:.4f} ms (inputs built, copied, padded, "
              f"replayed, copied out), eager Predictor.predict_batch {eager_request_ms:.4f} ms "
              f"(unpadded); eager Predictor on the padded inputs {eager_ms:.4f} ms (medians of "
              f"20, 10, 10, 10)")
        check(served.last_bucket == bucket, f"{what}: bucket {served.last_bucket}, want {bucket}")
        check(first == {NAME: GRAPH_WARMUP + 1} and per_request == {NAME: 1},
              f"{what}: launches {first} then {per_request}, want {NAME} "
              f"{GRAPH_WARMUP + 1} (warm-up and one replay) then once a request")
        check(out["logp"].shape == (b, l, 6) and np.isfinite(out["logp"]).all(),
              f"{what}: non-finite or misshapen log-probs")
        check(np.array_equal(out["logp"], again["logp"]), f"{what}: two replays differ")
        check(err_eager <= REPLAY_ATOL, f"{what}: replay and eager Predictor differ")
        check(np.allclose(out["logp"], ref["logp"], rtol=1e-3, atol=1e-4),
              f"{what}: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
        f32_out[what] = out
    launches[NAME]["onlysp f32 artifact, a request of each bucket"] = total
    # where the time of the eval request goes, served against eager
    batch = batches["IEMOCAP eval"]
    xp, qp, up = served.padded_inputs(batch, (110, 32))
    for what, fn in (("served", lambda: served.predict(batch)),
                     ("eager Predictor.predict_batch", lambda: gpu.predict_batch(batch))):
        wall, busy, events = device_profile(torch, fn, 3)
        n_kernels = kernel_split(events, 3)[0]
        idle = (f"{100 * (1 - busy / wall):.1f}%" if busy > 0
                else "not measured (the tracer saw no kernel)")
        print(f"[profile] {card} | onlysp f32 {what} IEMOCAP eval request [{L_e}, {B_e}], profile "
              f"of 3: {n_kernels:.0f} kernels a request, busy {busy / 3:.4f} ms of "
              f"{wall / 3:.4f} ms, idle {idle}")
    del gpu, cpu

    # (b) bf16 and int8 against (a)'s f32 artifact on the card
    check(sizes["int8"] < 0.45 * sizes["f32"], f"int8 artifact {sizes['int8']} B, f32 "
          f"{sizes['f32']} B: not under 0.45x")
    for dtype in ("bf16", "int8"):
        low = ServingModel.load(paths[dtype], device="cuda")
        total = 0
        for what, bucket in SERVE_REQUESTS:
            batch = batches[what]
            low.predict(batch)
            reset_launches()
            out = low.predict(batch)
            torch.cuda.synchronize()
            per_request = dict(LAUNCHES)
            total += per_request.get(NAME, 0)
            ref = f32_out[what]
            valid = batch["umask"] > 0
            drift = np.abs(out["logp"] - ref["logp"])
            agree = float((out["preds"] == ref["preds"])[valid].mean())
            graph = low.graph(bucket, *(a.shape[-1] for a in low.padded_inputs(batch, bucket)[:2]))
            replay_ms = cuda_ms(torch, graph.replay, warmup=2, iters=20)
            print(f"[serve] onlysp {dtype} {what} -> {list(low.last_bucket)}: launches "
                  f"{per_request}, |logp - f32| max {drift.max():.4f} mean {drift.mean():.5f} "
                  f"(valid rows: max {drift[valid].max():.4f}), argmax agreement on valid rows "
                  f"{agree:.4f}")
            print(f"[time] {card} | onlysp {dtype} bucket {list(bucket)}: replay "
                  f"{replay_ms:.4f} ms (median of 20)")
            check(np.isfinite(out["logp"]).all() and out["logp"].dtype == np.float32,
                  f"{dtype} {what}: non-finite or not f32")
            check(per_request == {NAME: 1}, f"{dtype} {what}: launches {per_request}")
            if dtype == "bf16":
                check(drift.max() < 0.5 and drift.mean() < 0.1, f"bf16 {what}: drift")
            else:
                check(agree >= 0.9 and drift[valid].max() < 1.0, f"int8 {what}: agreement "
                      f"{agree}, drift {drift[valid].max()}")
        launches[NAME][f"onlysp {dtype} artifact, a request of each bucket"] = total
        del low

    # (c) every other model of the registry: f32 artifact, the eval request
    for name in available_models():
        if name == "MARN1_onlysp":
            continue
        gpu_m = Predictor(name, seed=0, device="cuda")
        path = str(tmp / f"{name}.ser")
        save_model(path, name, {k: v.cpu() for k, v in gpu_m.model.state_dict().items()},
                   ZOO_SERVE_L, ZOO_SERVE_B)
        served_m = ServingModel.load(path, device="cuda")
        cpu_m = ServingModel.load(path, device="cpu")
        t0 = time.perf_counter()
        out = served_m.predict(eval_batch)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        bucket = served_m.last_bucket
        xp, qp, up = served_m.padded_inputs(eval_batch, bucket)
        reset_launches()
        eager = gpu_m.predict(xp, qp, up)[0]
        torch.cuda.synchronize()
        eager_launches = dict(LAUNCHES)
        reset_launches()
        again = served_m.predict(eval_batch)
        torch.cuda.synchronize()
        replay_launches = dict(LAUNCHES)
        if RANK1 in replay_launches:
            launches[RANK1][f"{name} f32 artifact request [{L_e}, {B_e}]"] = \
                replay_launches[RANK1]
        replay = served_m.bucket_forward(bucket, xp, qp, up)
        err_eager = (replay - eager).abs().max().item()
        ref = cpu_m.predict(eval_batch)
        rows = (eval_batch["umask"] > 0) if name in BASELINES else np.ones_like(
            eval_batch["umask"], bool)
        err_cpu = float(np.abs(out["logp"] - ref["logp"])[rows].max())
        graph = served_m.graph(bucket, xp.shape[-1], qp.shape[-1])
        replay_ms = cuda_ms(torch, graph.replay, warmup=2, iters=10)
        eager_ms = cuda_ms(torch, lambda: gpu_m.predict(xp, qp, up), warmup=1, iters=5)
        print(f"[serve] {name} f32 request [{L_e}, {B_e}] -> bucket {list(bucket)}: first "
              f"request {first_ms:.1f} ms, launches a request {replay_launches} (eager "
              f"{eager_launches}), max|replay - eager| {err_eager:.3e}, max|card - CPU| "
              f"{err_cpu:.3e}" + (" (valid rows)" if name in BASELINES else ""))
        print(f"[time] {card} | {name} f32 bucket {list(bucket)}: replay {replay_ms:.4f} ms "
              f"(median of 10), eager Predictor {eager_ms:.4f} ms (median of 5)")
        want = {RANK1: L_e} if name in VARIANTS else {}
        check(bucket == (L_e, 32), f"{name}: bucket {bucket}")
        check(replay_launches == eager_launches == want, f"{name}: launches a request "
              f"{replay_launches}, eager {eager_launches}, want {want}")
        check(np.isfinite(out["logp"]).all() and np.array_equal(out["logp"], again["logp"]),
              f"{name}: non-finite log-probs or two replays differ")
        check(err_eager <= REPLAY_ATOL, f"{name}: replay and eager Predictor differ")
        check(np.allclose(out["logp"][rows], ref["logp"][rows], rtol=1e-3, atol=1e-4),
              f"{name}: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
        del gpu_m, served_m, cpu_m, graph, eager, replay
        torch.cuda.empty_cache()

    # (d) the CLIs on the card: export from an .npz and from a reference
    #     torch state dict with module.model. keys; run against the CPU on
    #     the same pickles; bench; a MELD artifact through run
    npz, ref_model = tmp / "onlysp.npz", tmp / "onlysp.model"
    np.savez(npz, **to_jax_params(weights))
    torch.save({f"module.model.{k}": v for k, v in weights.items()}, ref_model)
    art, art_torch = str(tmp / "cli.ser"), str(tmp / "cli_torch.ser")
    buckets = ["--L", str(CLI_SERVE_L), "--B", ",".join(map(str, SERVE_B))]
    run_cli_json(serve_cli.main, ["export", "--initial_model", str(npz), "--out", art, *buckets])
    _, log = run_cli_json(serve_cli.main, ["export", "--initial_model", str(ref_model),
                                           "--torch_format", "--out", art_torch, *buckets])
    check("is not in" not in log, f"the torch-format export skipped keys: {log}")
    check(Path(art).read_bytes() == Path(art_torch).read_bytes(),
          "the artifacts from the .npz and the module.model. state dict differ")

    pickles = generate_iemocap_pickles(str(tmp / "pickles"), seed=PREDICT_SEED)
    launches[NAME]["serve run --synthetic (first batch of a bucket: warm-up, replay)"] = \
        serve_run_card_and_cpu(torch, "IEMOCAP --synthetic", art, ["--synthetic"], ["--feature_path", pickles])
    rep, _ = run_cli_json(serve_cli.main, ["bench", "--artifact", art, "--iters", "20"])
    print(f"[time] {card} | serve bench {rep['backend']}: " + ", ".join(
        f"{k} {v['ms_per_call']} ms, {v['utterances_per_sec']} utt/s"
        for k, v in rep["buckets"].items()))
    check(rep["backend"] == "cuda" and len(rep["buckets"]) == len(SERVE_B)
          and all(v["ms_per_call"] > 0 and math.isfinite(v["utterances_per_sec"])
                  for v in rep["buckets"].values()), f"serve bench rows {rep['buckets']}")
    meld_model = Predictor(seed=0, device="cpu", n_classes=7).model
    randomize_constants(torch, [meld_model], seed=4)
    meld_npz, meld_art = tmp / "meld.npz", str(tmp / "meld.ser")
    np.savez(meld_npz, **to_jax_params(meld_model.state_dict()))
    run_cli_json(serve_cli.main, ["export", "--initial_model", str(meld_npz), "--out", meld_art,
                                  "--dataset", "MELD", "--n_classes", "7", "--L", "32",
                                  "--B", f"8,{TRAIN_B}"])
    launches[NAME]["serve run MELD 7 classes, P = 9"] = serve_run_card_and_cpu(
        torch, "MELD --n_classes 7", meld_art, ["--feature_path", meld_path],
        ["--feature_path", meld_path])
    tmp_dir.cleanup()
    return launches


# phase 13: the five zoo kinds of --encoder_attention, --infonce and
# --debug_nans on MARN1_onlysp
ZOO_KINDS = ("external", "self", "simplified_self", "mobilevit_v2", "muse")
ZOO_TIMED = ("external", "muse")  # their [110, 80] step timed
ZOO_CHECK_SHAPE = (32, 16)  # the card-against-CPU step
ZOO_DEAD = 38  # onlysp's dead set under every kind (tests/test_torch_encoder_attention.py)
INFONCE_W = 0.1
# the card-against-CPU step's weight: the query is its own positive, so the
# term is the negatives' share of the softmax, about 1e-4 at [32, 16]
INFONCE_CHECK_W = 1e4
ZOO_MOVES = 2e-2  # the least the enlarged op moves a request's log-probs
ZOO_SERVE_KIND = "muse"


def enlarge_zoo_ops(torch, models, seed):
    """The zoo ops' parameters (``slf_attn.op.``), the same on every model,
    drawn N(0, 100/fan-in) in place of the zoo's N(0, 0.001²) init, at which
    an op adds about 1e-4 before the encoder's residual and LayerNorm and a
    whole-forward comparison could not see it."""
    g = torch.Generator().manual_seed(seed)
    new = {n: 10 * torch.randn(p.shape, generator=g) / (p[0].numel() if p.ndim > 1
                                                       else p.numel()) ** 0.5
           for n, p in models[0].named_parameters() if "slf_attn.op." in n}
    with torch.no_grad():
        for model in models:
            params = dict(model.named_parameters())
            for name, value in new.items():
                params[name].copy_(value.to(params[name].device))


def zoo_phase(torch, card, eval_batch):
    """Phase 13 (the module docstring). Returns the recurrence kernel's and
    the rank-1 kernel's launches by path, each counted from 0 just before
    its run."""
    import numpy as np

    from ser_tpu_torch import predict as predict_cli
    from ser_tpu_torch import serve as serve_cli
    from ser_tpu_torch.compat.from_jax import to_jax_params
    from ser_tpu_torch.data.synthetic import generate_iemocap_pickles, synthetic_batch
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels.lsthm import NAME
    from ser_tpu_torch.ops.kernels.rank1 import NAME as RANK1
    from ser_tpu_torch.ops.layers import Dropout
    from ser_tpu_torch.serving import Predictor, ServingModel
    from ser_tpu_torch.train import __main__ as train_cli
    from ser_tpu_torch.train.trainer import ModelTrainer
    from ser_tpu_torch.utils import profiling

    launches = {NAME: {}, RANK1: {}}
    T, B_e = eval_batch["qmask"].shape[:2]
    x, qmask, umask = get_model_spec("MARN1_onlysp").make_inputs(eval_batch)
    train_batch = synthetic_batch(L=TRAIN_L, B=TRAIN_B, seed=1, min_len=min(20, TRAIN_L))
    L_c, B_c = ZOO_CHECK_SHAPE
    check_batch = synthetic_batch(L=L_c, B=B_c, seed=2, min_len=L_c // 2)

    def card_vs_cpu_step(what, **kw):
        """One step at ZOO_CHECK_SHAPE on the card and the CPU, dropout off,
        the constant-initialised parameters made random: the train contract
        and the dead set, which must be onlysp's unused parameters."""
        trainers = {d: ModelTrainer(device=d, seed=0, lr=TRAIN_LR, **kw) for d in ("cpu", "cuda")}
        randomize_constants(torch, [t.model for t in trainers.values()], seed=1)
        loss = {}
        reset_launches()
        for d, t in trainers.items():
            no_dropout(t.model, Dropout)
            loss[d] = t._train_step_impl(check_batch, TRAIN_LR).item()
        torch.cuda.synchronize()
        step_launches = dict(LAUNCHES)
        worst, dead_cpu, dead_card = grad_check(torch, trainers["cpu"].model,
                                                trainers["cuda"].model)
        moved = max((p.detach().cpu() - q.detach()).abs().max().item() for p, q in zip(
            trainers["cuda"].model.parameters(), trainers["cpu"].model.parameters()))
        loss_rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        want_dead = {n for n, _ in trainers["cpu"].model.named_parameters() if DEAD.search(n)}
        print(f"[zoo] {what} one step [{L_c}, {B_c}] card vs CPU: |loss| rel {loss_rel:.3e}, "
              f"gradients {worst:.3f} of the tolerance, {len(dead_card)} parameters with no "
              f"gradient, max |param card - CPU| after Adam {moved / TRAIN_LR:.3f} lr, "
              f"launches {step_launches}")
        check(loss_rel <= TRAIN_LOSS_RTOL, f"{what} step loss: card and CPU disagree")
        check(worst <= 1.0, f"{what} step gradients: card and CPU disagree")
        check(dead_cpu == dead_card == want_dead and len(want_dead) == ZOO_DEAD,
              f"{what} dead parameters: CPU {len(dead_cpu)}, card {len(dead_card)}, "
              f"want the {ZOO_DEAD} unused ones")
        check(moved <= 2.05 * TRAIN_LR, f"{what} Adam updates: card and CPU differ")
        check(step_launches == {RANK1: 2 * L_c}, f"{what}: a step launched {step_launches}")

    def timed_step(trainer, what):
        """ms of a [110, 80] step (median of 3) and its peak memory; the
        launches of one step, which must be 2T of the rank-1 kernel."""
        step = lambda: trainer._train_step_impl(train_batch, TRAIN_LR)  # noqa: E731
        step()
        torch.cuda.synchronize()
        reset_launches()
        step()
        torch.cuda.synchronize()
        step_launches = dict(LAUNCHES)
        launches[RANK1][f"{what} train step [{TRAIN_L}, {TRAIN_B}]"] = step_launches.get(RANK1, 0)
        check(step_launches == {RANK1: 2 * TRAIN_L},
              f"{what}: a train step launched {step_launches}, want {RANK1} {2 * TRAIN_L}")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, step, warmup=0, iters=3)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    # (a) the eval request [82, 31] under each kind (mha's time beside),
    #     card against CPU, the recurrence kernel once
    for kind in ("mha",) + ZOO_KINDS:
        gpu = Predictor(seed=0, device="cuda", encoder_attention=kind)
        moved = None
        if kind != "mha":
            at_init = gpu.predict(x, qmask, umask)[0]
            enlarge_zoo_ops(torch, [gpu.model], seed=4)
        reset_launches()
        logp = gpu.predict(x, qmask, umask)[0]
        torch.cuda.synchronize()
        req_launches = dict(LAUNCHES)
        launches[NAME][f"{kind} request [{T}, {B_e}]"] = req_launches.get(NAME, 0)
        check(req_launches == {NAME: 1}, f"{kind} request launched {req_launches}")
        err = None
        if kind != "mha":  # phase 4 holds mha's
            cpu = Predictor(state_dict={k: v.cpu() for k, v in gpu.model.state_dict().items()},
                            device="cpu", encoder_attention=kind)
            ref = cpu.predict(x, qmask, umask)[0]
            err = (logp.cpu() - ref).abs().max().item()
            check(torch.isfinite(logp).all().item() and logp.shape == ref.shape,
                  f"{kind}: non-finite or misshapen log-probs")
            check(torch.allclose(logp.cpu(), ref, rtol=1e-3, atol=1e-4),
                  f"{kind} request: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
            valid = torch.as_tensor(umask).reshape(-1) > 0
            moved = (logp - at_init)[valid.to(logp.device)].abs().max().item()
            check(moved > ZOO_MOVES, f"{kind}: the op moves the log-probs by {moved:.3e} only")
            del cpu
        req_ms = cuda_ms(torch, lambda: gpu.predict(x, qmask, umask), warmup=2, iters=10)
        print(f"[time] {card} | onlysp --encoder_attention {kind} request [{T}, {B_e}]: "
              f"{req_ms:.4f} ms (median of 10), launches {req_launches}"
              + ("" if err is None else f", max|gpu-cpu| {err:.3e}, the op moves the "
                 f"log-probs by {moved:.3e}"))
        del gpu

    # (b) a step under each kind card against CPU; external's and muse's
    #     [110, 80] step timed
    for kind in ZOO_KINDS:
        card_vs_cpu_step(f"--encoder_attention {kind}", encoder_attention=kind)
    step_ms = {}
    for kind in ("mha",) + ZOO_TIMED:
        trainer = ModelTrainer(seed=0, lr=TRAIN_LR, encoder_attention=kind)
        step_ms[kind] = timed_step(trainer, f"--encoder_attention {kind}")
        del trainer
    print(f"[time] {card} | onlysp train step [{TRAIN_L}, {TRAIN_B}] (median of 3, peak): "
          + ", ".join(f"{k} {ms:.2f} ms {peak:.4f} GiB" for k, (ms, peak) in step_ms.items()))

    # (c) --infonce: the term of one forward equals the step's loss less the
    #     plain step's, from one generator state; a step card against CPU
    base = ModelTrainer(seed=0, lr=TRAIN_LR)
    nce = ModelTrainer(seed=0, lr=TRAIN_LR, infonce=INFONCE_W)
    g = torch.Generator(base.device).set_state(base.generator.get_state())
    base.model.train()
    with torch.no_grad():
        feats = base.model(*base.predictor.batch_inputs(train_batch), generator=g)
        aux = INFONCE_W * ModelTrainer.infonce_term(feats).item()
    del feats
    l0 = base._train_step_impl(train_batch, TRAIN_LR).item()
    reset_launches()
    l1 = nce._train_step_impl(train_batch, TRAIN_LR).item()
    torch.cuda.synchronize()
    nce_launches = dict(LAUNCHES)
    print(f"[zoo] --infonce {INFONCE_W} [{TRAIN_L}, {TRAIN_B}]: loss {l1:.6f}, plain {l0:.6f}, "
          f"difference {l1 - l0:.6e}, {INFONCE_W}·info_nce of the forward {aux:.6e}, "
          f"launches {nce_launches}")
    check(math.isfinite(l1) and abs((l1 - l0) - aux) <= 1e-5 + 1e-4 * abs(aux),
          "--infonce: the step's loss less the plain one is not the term")
    check(nce_launches == {RANK1: 2 * TRAIN_L}, f"--infonce step launched {nce_launches}")
    del base
    nce_ms = timed_step(nce, f"--infonce {INFONCE_W}")
    print(f"[time] {card} | onlysp train step [{TRAIN_L}, {TRAIN_B}] --infonce {INFONCE_W}: "
          f"{nce_ms[0]:.2f} ms, peak {nce_ms[1]:.4f} GiB; plain {step_ms['mha'][0]:.2f} ms, "
          f"peak {step_ms['mha'][1]:.4f} GiB")
    del nce
    card_vs_cpu_step(f"--infonce {INFONCE_CHECK_W:g}", infonce=INFONCE_CHECK_W)

    # (d) the entry points: the train CLI under the zoo flags, predict on
    #     its checkpoint, one step under --debug_nans, serve export and run
    #     under muse, a NaN caught
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
        tmp = Path(tmp)
        exp = tmp / "exp"
        what = "train CLI external --infonce, 2 epochs"
        reset_launches()
        t0 = time.perf_counter()
        run_quiet(in_dir, tmp, train_cli.main, train_cli.parser_args(
            ["--synthetic", "--epoch", "2", "--batch_size", "16", "--encoder_attention",
             "external", "--infonce", str(INFONCE_W), "--save_path", str(exp)]))
        torch.cuda.synchronize()
        cli_launches = dict(LAUNCHES)
        launches[NAME][what] = cli_launches.get(NAME, 0)
        launches[RANK1][what] = cli_launches.get(RANK1, 0)
        lines = score_lines(exp / "score.txt")
        print(f"[cli] train CLI --encoder_attention external --infonce {INFONCE_W}, 2 epochs: "
              f"{time.perf_counter() - t0:.1f} s, launches {cli_launches}")
        for line in lines:
            print(f"[cli]   score.txt: {line}")
        check(len(lines) == 2, "train CLI under the zoo flags: score lines")
        check(cli_launches.get(NAME, 0) > 0 and cli_launches.get(RANK1, 0) > 0,
              f"train CLI under the zoo flags launched {cli_launches}")
        # --debug_nans through the CLI: 16 dialogues, one step of 16
        feats = generate_iemocap_pickles(str(tmp / "feats"), seed=5, n_train=16, n_test=4,
                                         min_len=L_c // 2, max_len=L_c)
        what = "train CLI external --infonce --debug_nans, one step"
        reset_launches()
        t0 = time.perf_counter()
        run_quiet(in_dir, tmp, train_cli.main, train_cli.parser_args(
            ["--feature_path", feats, "--epoch", "1", "--batch_size", "16", "--encoder_attention",
             "external", "--infonce", str(INFONCE_W), "--debug_nans", "--save_path",
             str(tmp / "exp_nans")]))
        torch.cuda.synchronize()
        nans_launches = dict(LAUNCHES)
        launches[NAME][what] = nans_launches.get(NAME, 0)
        launches[RANK1][what] = nans_launches.get(RANK1, 0)
        nans_lines = score_lines(tmp / "exp_nans" / "score.txt")
        print(f"[cli] {what}: {time.perf_counter() - t0:.1f} s, launches {nans_launches}; "
              f"score.txt: {nans_lines}")
        check(len(nans_lines) == 1 and not profiling.nan_checks_enabled(),
              "train CLI under --debug_nans: score line or the NaN checks left on")
        check(0 < nans_launches.get(RANK1, 0) <= 2 * L_c and nans_launches.get(NAME, 0) > 0,
              f"train CLI under --debug_nans launched {nans_launches}")
        out = run_quiet(predict_cli.main, [
            "--synthetic", "--encoder_attention", "external", "--initial_model",
            str(exp / "model" / "model_0002.model"), "--res_csv", str(tmp / "predict.csv")])
        check("is not in the model" not in out, "predict CLI skipped checkpoint names")
        rep = json.loads(out[out.index("{"):])
        scored = re.search(r"Acc ([\d.]+), Fscore ([\d.]+)", lines[1]).groups()
        predicted = (f"{rep['weighted_accuracy']:.2f}", f"{rep['weighted_f1']:.2f}")
        print(f"[cli] predict --encoder_attention external on model_0002: Acc {predicted[0]}, "
              f"F1 {predicted[1]}; score.txt epoch 2: Acc {scored[0]}, Fscore {scored[1]}")
        check(predicted == scored, "external: the predict CLI's Acc/F1 differ from score.txt's")

        muse = Predictor(seed=0, device="cpu", encoder_attention=ZOO_SERVE_KIND).model
        randomize_constants(torch, [muse], seed=3)
        enlarge_zoo_ops(torch, [muse], seed=5)
        npz, art = tmp / "muse.npz", str(tmp / "muse.ser")
        np.savez(npz, **to_jax_params(muse.state_dict()))
        run_cli_json(serve_cli.main, ["export", "--initial_model", str(npz), "--out", art,
                                      "--encoder_attention", ZOO_SERVE_KIND, "--L",
                                      str(CLI_SERVE_L), "--B", ",".join(map(str, SERVE_B))])
        launches[NAME][f"serve run --synthetic {ZOO_SERVE_KIND}"] = serve_run_card_and_cpu(
            torch, f"{ZOO_SERVE_KIND} --synthetic", art, ["--synthetic"],
            ["--synthetic"])
        served = ServingModel.load(art, device="cuda")
        check(served.header["encoder_attention"] == ZOO_SERVE_KIND, "the artifact's kind")
        bucket = (CLI_SERVE_L, SERVE_B[-1])
        xp, qp, up = served.padded_inputs(cut(eval_batch, T, B_e), bucket)
        replay = served.bucket_forward(bucket, xp, qp, up)
        with torch.no_grad():
            eager = served._forward(*(t.cuda() for t in (xp, qp, up)))
        err = (replay - eager).abs().max().item()
        print(f"[serve] {ZOO_SERVE_KIND} bucket {list(bucket)}: max|replay - eager| {err:.3e}")
        check(err <= REPLAY_ATOL, f"{ZOO_SERVE_KIND}: the bucket graph's replay differs")
        del served

    # the cost of --debug_nans's checks (anomaly mode syncs at every
    # backward node) on a [32, 16] step, then a NaN caught
    trainer = ModelTrainer(seed=0, lr=TRAIN_LR)
    step = lambda: trainer._train_step_impl(check_batch, TRAIN_LR)  # noqa: E731
    plain_ms = cuda_ms(torch, step, warmup=1, iters=3)
    profiling.enable_nan_checks(True)
    try:
        checked_ms = cuda_ms(torch, step, warmup=1, iters=3)
    finally:
        profiling.enable_nan_checks(False)
    print(f"[time] {card} | onlysp train step [{L_c}, {B_c}] with --debug_nans's checks "
          f"{checked_ms:.2f} ms, without {plain_ms:.2f} ms (medians of 3)")
    nan_batch = synthetic_batch(L=L_c, B=B_c, seed=3, min_len=L_c // 2)
    nan_batch["acouf"][1, 0, 3] = np.nan  # a valid row of the first dialogue
    profiling.enable_nan_checks(True)
    try:
        trainer._train_step_impl(nan_batch, TRAIN_LR)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    finally:
        profiling.enable_nan_checks(False)
    print(f"[zoo] --debug_nans, a NaN in one valid row's acouf: {raised}")
    check(raised is not None, "--debug_nans: a NaN in acouf raised no FloatingPointError")
    return launches


# phase 14: --compute_dtype bf16 training through the bf16 form of the
# rank-1 kernel, and --dp data parallelism over torch.distributed
# the bf16 kernel against its plain version: each output is rounded to bf16
# once from f32 sums taken in another order, so the two may differ by one
# bf16 ulp (at most 2^-7 of the value); dwq and dwk's floor scales with
# their largest entry, as RANK1_ATOL's does
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-5
BF16_DIST_SHAPE = (9, 3)  # the bf16-against-f32 gradient distance, card and CPU
DP_CHECK_SHAPE = (32, 16)  # the NCCL one-rank and the two-process steps
DP_WORKERS = 2
ONLYSP_DEAD = 38


def grad_vector(torch, model):
    """Every parameter's gradient (zeros where ``.grad`` is None) as one f64
    vector on the CPU."""
    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .detach().double().cpu().reshape(-1) for p in model.parameters()])


def bf16_distance(torch, device, batch, constants_random):
    """How far a bf16 step's gradients lie from the f32 step's on
    ``device``: ‖g_bf16 − g_f32‖ / ‖g_f32‖ over all parameters, MARN1_onlysp
    with seeded weights (the constant-initialised ones made random when
    ``constants_random``), dropout off."""
    from ser_tpu_torch.ops.layers import Dropout
    from ser_tpu_torch.train.trainer import ModelTrainer

    grads = {}
    for dtype in ("f32", "bf16"):
        trainer = ModelTrainer(device=device, seed=0, lr=TRAIN_LR, compute_dtype=dtype,
                               res_csv_path=None)
        if constants_random:
            randomize_constants(torch, [trainer.model], seed=1)
        no_dropout(trainer.model, Dropout)
        trainer._train_step_impl(batch, TRAIN_LR)
        grads[dtype] = grad_vector(torch, trainer.model)
    return ((grads["bf16"] - grads["f32"]).norm() / grads["f32"].norm()).item()


def whole_grads(torch, trainer):
    """``{name: gradient or None}`` of ``trainer``'s parameters, under
    ``--tp`` the shards' gathered (every tp process must call it)."""
    from ser_tpu_torch.parallel import gather_shards

    named = {n: p.grad for n, p in trainer.model.named_parameters()}
    live = [n for n in trainer.shards if named[n] is not None]
    if live:
        with torch.no_grad():
            named.update(zip(live, gather_shards([named[n] for n in live],
                                                 [trainer.shards[n] for n in live],
                                                 trainer.grid)))
    return named


def dp_step(torch, trainer, batch):
    """One dropout-off step of ``trainer`` on ``batch`` with the
    constant-initialised parameters made random: ``(loss, {name: grad or
    None}, {name: parameter})`` on the CPU, whole under ``--tp``."""
    from ser_tpu_torch.ops.layers import Dropout

    with trainer.whole_parameters(reshard=True):
        randomize_constants(torch, [trainer.model], seed=1)
    no_dropout(trainer.model, Dropout)
    loss = trainer._train_step_impl(batch, TRAIN_LR).item()
    grads = whole_grads(torch, trainer)
    params = trainer._whole_train_state()[0]
    return (loss, {n: None if g is None else g.detach().cpu() for n, g in grads.items()},
            {n: p.detach().cpu() for n, p in params.items()})


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_worker(out_dir):
    """One of DP_WORKERS processes sharing the card over gloo (phase 14e):
    its rows of the DP_CHECK_SHAPE batch, one dropout-off step, its loss,
    reduced gradients and updated parameters written to ``out_dir``; then
    the train CLI under ``--dp`` for one epoch in the same process group,
    from ``out_dir``, and the kernels' launches of that run."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from ser_tpu_torch.data.loaders import EpochLoader
    from ser_tpu_torch.data.synthetic import synthetic_batch
    from ser_tpu_torch.device import disable_tf32
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.parallel import initialize_distributed, world
    from ser_tpu_torch.train import __main__ as train_cli
    from ser_tpu_torch.train.trainer import ModelTrainer

    disable_tf32()
    torch.cuda.set_device(0)  # NCCL refuses two ranks on one card; gloo shares it
    torch.distributed.init_process_group("gloo", init_method="env://")
    device = initialize_distributed("cuda")
    rank, size = world()
    L_c, B_c = DP_CHECK_SHAPE
    batch = EpochLoader([], [], B_c, process_index=rank, process_count=size)._local_rows(
        synthetic_batch(L=L_c, B=B_c, seed=2, min_len=L_c // 2))
    trainer = ModelTrainer(device=device, seed=0, lr=TRAIN_LR, dp=True, res_csv_path=None)
    loss, grads, params = dp_step(torch, trainer, batch)
    np.savez(Path(out_dir) / f"rank{rank}.npz", loss=np.float64(loss),
             **{f"grad/{n}": g.numpy() for n, g in grads.items() if g is not None},
             **{f"param/{n}": p.numpy() for n, p in params.items()})
    reset_launches()
    run_quiet(in_dir, out_dir, train_cli.main, train_cli.parser_args(
        ["--dp", "--synthetic", "--epoch", "1", "--batch_size", "16", "--num_workers", "0",
         "--save_path", str(Path(out_dir) / "cli")]))
    torch.cuda.synchronize()
    np.savez(Path(out_dir) / f"cli{rank}.npz", **{k: np.int64(v) for k, v in LAUNCHES.items()})
    torch.distributed.destroy_process_group()
    return 0


def bf16_dp_phase(torch, card, dev, logs):
    """Phase 14 (the module docstring). Returns the bf16 rank-1 kernel's
    record for the kernels line, its launches by path each counted from 0
    just before its run, the f32 kernels' launches by path in the
    two-process train CLI, and the DP_CHECK_SHAPE steps that phase 15 is
    held to: the one-process step's ``(loss, grads, params)`` and the two
    processes' saved arrays."""
    import numpy as np

    from ser_tpu_torch.data.synthetic import synthetic_batch
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels import rank1 as rank1_kernel
    from ser_tpu_torch.ops.kernels.lsthm import NAME
    from ser_tpu_torch.parallel import initialize_distributed, world
    from ser_tpu_torch.train import __main__ as train_cli
    from ser_tpu_torch.train.trainer import ModelTrainer

    RANK1, RANK1_BF16 = rank1_kernel.NAME, rank1_kernel.NAME_BF16
    bf = torch.bfloat16
    launches = {}

    # (a) the bf16 kernel: registers, against its plain version, against the
    #     f32 kernel rounded once, its mask, device time beside the f32
    #     kernel's, the plain version and SDPA in bf16
    forms = ptxas_summary(logs[RANK1])
    print("[bf16] " + "; ".join(forms))
    check(len(forms) == 4 and sum("(bf16)" in f for f in forms) == 2
          and all("spill stores 0 B, loads 0 B" in f for f in forms),
          f"{RANK1}: the f32 and bf16 forms' registers and spills: {forms}")
    seed = torch.tensor([20240611], dtype=torch.int32, device=dev)
    names = ("z", "dx1", "dx2", "dwq", "dwk")
    bf16_err = 0.0
    for B in (80, 31, 1):
        *ins, g_out = rank1_inputs(torch, B, dev, seed=B)
        ins_bf, g_bf = [t.to(bf) for t in ins], g_out.to(bf)
        for p in (0.0, 0.2):
            got = rank1_fwd_bwd(torch, rank1_kernel.rank1_attention, ins_bf, g_bf, seed, 3, p)
            again = rank1_fwd_bwd(torch, rank1_kernel.rank1_attention, ins_bf, g_bf, seed, 3, p)
            want = rank1_fwd_bwd(torch, rank1_kernel.rank1_attention_ref, ins_bf, g_bf,
                                 seed, 3, p)
            wide = rank1_fwd_bwd(torch, rank1_kernel.rank1_attention,
                                 [t.float() for t in ins_bf], g_bf.float(), seed, 3, p)
            fracs = []
            for name, a, b, c in zip(names, got, want, wide):
                check(a.dtype == bf and torch.isfinite(a).all().item(),
                      f"{RANK1_BF16} {name}: {a.dtype} or non-finite, B={B}")
                a32, b32 = a.float(), b.float()
                floor = BF16_ATOL * (b32.abs().max().item() if name in ("dwq", "dwk") else 1.0)
                err = (a32 - b32).abs()
                frac = (err / (BF16_RTOL * b32.abs() + floor)).max().item()
                bf16_err = max(bf16_err, err.max().item())
                fracs.append(f"{name} {frac:.3f}")
                check(frac <= 1.0, f"{RANK1_BF16} {name} disagrees with its plain version, "
                      f"B={B}, p={p}")
                check(torch.equal(a, c.to(bf)), f"{RANK1_BF16} {name} is not the f32 kernel's "
                      f"on the widened inputs rounded once, B={B}, p={p}")
            bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"[bf16] {RANK1_BF16} [2, {B}, 128] p={p}: fraction of the tolerance "
                  f"{', '.join(fracs)}; every output the f32 kernel's rounded once; two runs "
                  f"bit-equal: {bit_equal}")
            check(bit_equal, f"two {RANK1_BF16} runs differ, B={B}, p={p}")
    # the mask: with wk = 0 every e is 1, and with x2 = 1 a row's z is its
    # kept count over (1 - p) D; the two forms' counts row by row
    counts = {}
    x1 = torch.randn(2, TRAIN_B, 128, device=dev)
    for dtype in (torch.float32, bf):
        z = rank1_kernel.rank1_attention(
            x1.to(dtype), torch.ones(2, TRAIN_B, 128, device=dev, dtype=dtype),
            torch.ones(2, 128, device=dev, dtype=dtype),
            torch.zeros(2, 128, device=dev, dtype=dtype), seed, 0, 0.2)
        counts[dtype] = (z.float() * 0.8 * 128).round()
    plain_kept = int(rank1_kernel.keep_mask(seed, 0, TRAIN_B, 0.2).sum().item())
    print(f"[bf16] {RANK1_BF16} mask: kept {int(counts[bf].sum().item())} of "
          f"{2 * TRAIN_B * 128 * 128} draws, f32 kernel {int(counts[torch.float32].sum().item())}, "
          f"plain mask {plain_kept}; every row's count the f32 kernel's: "
          f"{torch.equal(counts[bf], counts[torch.float32])}")
    check(torch.equal(counts[bf], counts[torch.float32])
          and int(counts[bf].sum().item()) == plain_kept,
          f"{RANK1_BF16}: its mask is not the f32 kernel's")

    *ins, g_out = rank1_inputs(torch, TRAIN_B, dev, seed=5)
    device_ms = {}
    for dtype in (torch.float32, bf, bf, torch.float32):  # in turns
        xs, g = [t.to(dtype) for t in ins], g_out.to(dtype)
        k = rank1_kernel.Rank1Kernel(xs[2], xs[3], seed, 0.2)
        pair = (cuda_graph_ms(torch, lambda: k.forward(xs[0], xs[1], 3))
                + cuda_graph_ms(torch, lambda: k.backward(xs[0], xs[1], 3, g)))
        device_ms.setdefault(dtype, []).append(pair)
    xs, g = [t.to(bf) for t in ins], g_out.to(bf)
    k = rank1_kernel.Rank1Kernel(xs[2], xs[3], seed, 0.2)
    bf16_ms = (cuda_ms(torch, lambda: k.forward(xs[0], xs[1], 3))
               + cuda_ms(torch, lambda: k.backward(xs[0], xs[1], 3, g)))

    def plain_pair():
        leaves = [t.clone().requires_grad_() for t in xs]
        torch.autograd.grad(rank1_kernel.rank1_attention_ref(*leaves, seed, 3, 0.2),
                            leaves, g)

    bf16_plain_ms = cuda_ms(torch, plain_pair)
    qkv = [t.detach().clone().requires_grad_() for t in rank1_sdpa_qkv(torch, *xs)]
    gz = torch.nn.functional.pad(g[..., None], (0, 7))
    bf16_sdpa_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        torch.nn.functional.scaled_dot_product_attention(*qkv, dropout_p=0.2, scale=1.0),
        qkv, gz))
    rb16 = rank1_bound(TRAIN_B, itemsize=2)
    print(f"[time] {card} | {RANK1_BF16} [2, {TRAIN_B}, 128] p=0.2: forward and backward "
          f"{bf16_ms:.4f} ms a wrapper pair, device time (CUDA graph) bf16 "
          f"{device_ms[bf]} ms, f32 {device_ms[torch.float32]} ms in turns (f32, bf16, bf16, "
          f"f32); plain bf16 form forward and autograd backward {bf16_plain_ms:.4f}; "
          f"F.scaled_dot_product_attention bf16 forward and backward {bf16_sdpa_ms:.4f}; "
          f"bound {rb16['both'][0]:.5f} ({rb16['both'][2]})")
    del ins, g_out, xs, g, qkv, k

    # (b) onlysp's bf16 step at [110, 80] in turns with the f32 step; one
    #     bf16 step of each variant, DialogueRNN and BiLSTM
    train_batch = synthetic_batch(L=TRAIN_L, B=TRAIN_B, seed=1, min_len=min(20, TRAIN_L))
    trainers = {d: ModelTrainer(seed=0, lr=TRAIN_LR, compute_dtype=d) for d in ("f32", "bf16")}
    for t in trainers.values():
        t._train_step_impl(train_batch, TRAIN_LR)
    torch.cuda.synchronize()
    reset_launches()
    trainers["bf16"]._train_step_impl(train_batch, TRAIN_LR)
    torch.cuda.synchronize()
    step_launches = dict(LAUNCHES)
    what = f"MARN1_onlysp bf16 train step [{TRAIN_L}, {TRAIN_B}]"
    launches[what] = step_launches.get(RANK1_BF16, 0)
    check(step_launches == {RANK1_BF16: 2 * TRAIN_L},
          f"{what} launched {step_launches}, want {RANK1_BF16} {2 * TRAIN_L}")
    master = {p.dtype for p in trainers["bf16"].model.parameters()} | {
        v.dtype for s in trainers["bf16"].optimizer.state.values() for v in s.values()
        if v.is_floating_point()} | {p.grad.dtype for p in trainers["bf16"].model.parameters()
                                     if p.grad is not None}
    check(master == {torch.float32}, f"bf16 step: master state in {master}")
    step_ms, peak, rise, prof = {}, {}, {}, {}
    for d in ("f32", "bf16", "bf16", "f32"):
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # what earlier phases still hold
        step_ms.setdefault(d, []).append(cuda_ms(
            torch, lambda: trainers[d]._train_step_impl(train_batch, TRAIN_LR),
            warmup=0, iters=5))
        peak[d] = torch.cuda.max_memory_allocated() / 2 ** 30
        rise[d] = peak[d] - held / 2 ** 30
    for d in ("f32", "bf16"):  # one step of each under the profiler
        wall, _, events = device_profile(
            torch, lambda: trainers[d]._train_step_impl(train_batch, TRAIN_LR), 1)
        prof[d] = (wall, *kernel_split(events, 1))
    print(f"[time] {card} | onlysp train step [{TRAIN_L}, {TRAIN_B}] (median of 5, in turns "
          f"f32, bf16, bf16, f32): bf16 {step_ms['bf16']} ms, peak {peak['bf16']:.4f} GiB "
          f"({rise['bf16']:.4f} above what was held before the step); f32 {step_ms['f32']} ms, "
          f"peak {peak['f32']:.4f} GiB ({rise['f32']:.4f} above); {RANK1_BF16} launches a "
          f"step {step_launches[RANK1_BF16]}; master parameters, gradients and Adam state f32")
    print(f"[profile] {card} | onlysp train step [{TRAIN_L}, {TRAIN_B}], one step each: " + "; ".join(
        f"{d} wall {w:.2f} ms, {n:.0f} kernel launches, device busy {b:.3f} ms (idle "
        f"{100 * (1 - b / w):.1f}%), the rank-1 kernel {r:.4f} ms"
        for d, (w, n, b, r) in prof.items()))
    del trainers
    L_c, B_c = DP_CHECK_SHAPE
    check_batch = synthetic_batch(L=L_c, B=B_c, seed=2, min_len=L_c // 2)
    for name in VARIANTS + ("DialogueRNN", "BiLSTM"):
        trainer = ModelTrainer(model=name, seed=0, lr=TRAIN_LR, compute_dtype="bf16")
        reset_launches()
        loss = trainer._train_step_impl(check_batch, TRAIN_LR).item()
        torch.cuda.synchronize()
        got = dict(LAUNCHES)
        want = ({RANK1_BF16: 2 * L_c - (name in Z_NOT_IN_OUTPUT)} if name in VARIANTS else {})
        if name in VARIANTS:
            launches[f"{name} bf16 train step [{L_c}, {B_c}]"] = got.get(RANK1_BF16, 0)
        print(f"[bf16] {name} bf16 train step [{L_c}, {B_c}]: loss {loss:.6f}, launches {got}")
        check(math.isfinite(loss) and got == want,
              f"{name} bf16 step: loss {loss}, launches {got}, want {want}")
        del trainer

    # (c) the bf16-against-f32 gradient distance at [9, 3], card and CPU
    dist_batch = synthetic_batch(L=BF16_DIST_SHAPE[0], B=BF16_DIST_SHAPE[1], seed=0)
    dist = {(init, d): bf16_distance(torch, d, dist_batch, init == "constants random")
            for init in ("reference", "constants random") for d in ("cpu", "cuda")}
    print(f"[bf16] onlysp bf16-against-f32 gradient distance at {list(BF16_DIST_SHAPE)}, "
          "‖g_bf16 - g_f32‖ / ‖g_f32‖: " + ", ".join(
              f"{init} init card {dist[init, 'cuda']:.4f} CPU {dist[init, 'cpu']:.4f}"
              for init in ("reference", "constants random")))
    check(dist["constants random", "cuda"] <= 1.5 * dist["constants random", "cpu"] + 0.02,
          "the card's bf16 step lies further from its f32 step than the CPU's allows")

    # (d) the train CLI under --compute_dtype bf16
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp:
        exp = Path(tmp) / "exp"
        reset_launches()
        t0 = time.perf_counter()
        run_quiet(in_dir, tmp, train_cli.main, train_cli.parser_args(
            ["--synthetic", "--epoch", "2", "--batch_size", "16", "--compute_dtype", "bf16",
             "--save_path", str(exp)]))
        torch.cuda.synchronize()
        cli_launches = dict(LAUNCHES)
        what = "train CLI --compute_dtype bf16, 2 epochs"
        launches[what] = cli_launches.get(RANK1_BF16, 0)
        lines = score_lines(exp / "score.txt")
        print(f"[cli] {what}: {time.perf_counter() - t0:.1f} s, launches {cli_launches}")
        for line in lines:
            print(f"[cli]   score.txt: {line}")
        check(len(lines) == 2 and cli_launches.get(RANK1_BF16, 0) > 0
              and cli_launches.get(NAME, 0) > 0 and RANK1 not in cli_launches,
              f"{what}: score lines {len(lines)}, launches {cli_launches}")

    # (e) --dp: one NCCL rank is the plain step, bit for bit (dropout on,
    #     rank 0 keeps the seed's stream); two processes sharing the card
    #     over gloo against the one-process step
    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        initialize_distributed("cuda")
        backend = torch.distributed.get_backend()
        plain, dp = (ModelTrainer(seed=0, lr=TRAIN_LR, dp=flag) for flag in (False, True))
        check(dp.dp and world() == (0, 1) and not plain.dp, "the one-rank trainer is not dp")
        losses = [t._train_step_impl(check_batch, TRAIN_LR) for t in (plain, dp)]
        same = torch.equal(*losses) and all(
            torch.equal(p, q) for p, q in zip(plain.model.parameters(), dp.model.parameters()))
        print(f"[dp] one {backend} rank, [{L_c}, {B_c}] with dropout: loss {losses[1].item():.6f}, "
              f"plain {losses[0].item():.6f}; loss and parameters bit-equal: {same}")
        check(backend == "nccl" and same, "one NCCL rank's step is not the plain step")
        del plain, dp
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    one = dp_step(torch, ModelTrainer(seed=0, lr=TRAIN_LR, res_csv_path=None), check_batch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dp_worker", tmp],
            env=dict(os.environ, WORLD_SIZE=str(DP_WORKERS), RANK=str(r), LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=port),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DP_WORKERS)]
        t0 = time.perf_counter()
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, out in zip(procs, outs):
            check(p.returncode == 0, f"a --dp worker failed:\n{out[-3000:]}")
        ranks = [state_arrays(np, Path(tmp) / f"rank{r}.npz") for r in range(DP_WORKERS)]
        cli = [{k: int(v) for k, v in state_arrays(np, Path(tmp) / f"cli{r}.npz").items()}
               for r in range(DP_WORKERS)]
        lines = score_lines(Path(tmp) / "cli" / "score.txt")
        blocks = (Path(tmp) / "cli" / "score.txt").read_text().count("Model: MARN1_onlysp")
        res_rows = len((Path(tmp) / "res.csv").read_text().splitlines())
    loss1, grads1, params1 = one
    top = max(g.abs().max().item() for g in grads1.values() if g is not None)
    worst, moved = 0.0, 0.0
    for r in ranks:
        got = {k[len("grad/"):]: torch.from_numpy(v) for k, v in r.items()
               if k.startswith("grad/")}
        check(set(got) == {n for n, g in grads1.items() if g is not None}
              and len(grads1) - len(got) == ONLYSP_DEAD,
              f"--dp: the live set {len(got)} of {len(grads1)}, want {ONLYSP_DEAD} dead")
        for n, gr in got.items():
            tol = GRAD_RTOL * grads1[n].abs().max().item() + GRAD_FLOOR * top
            worst = max(worst, (gr - grads1[n]).abs().max().item() / tol)
        moved = max(moved, max((torch.from_numpy(r[f"param/{n}"]) - p).abs().max().item()
                               for n, p in params1.items()))
    loss_rel = max(abs(float(r["loss"]) - loss1) / abs(loss1) for r in ranks)
    equal = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0] if
                k.startswith("param/"))
    print(f"[dp] {DP_WORKERS} processes sharing the card over gloo, [{L_c}, {B_c}] dropout off "
          f"({time.perf_counter() - t0:.1f} s): |loss| rel {loss_rel:.3e} of the one-process "
          f"step's, gradients {worst:.3f} of the tolerance, parameters bit-equal across "
          f"processes: {equal}, max |param - one process| after Adam {moved / TRAIN_LR:.3f} lr")
    check(loss_rel <= TRAIN_LOSS_RTOL and worst <= 1.0 and equal and moved <= 2.05 * TRAIN_LR,
          "--dp over two processes is not the one-process step")
    what = f"train CLI --dp, {DP_WORKERS} processes over gloo, 1 epoch"
    dp_launches = {name: {what: sum(c.get(name, 0) for c in cli)} for name in (RANK1, NAME)}
    print(f"[cli] {what}: launches by process {cli}; score.txt blocks {blocks}, lines {lines}; "
          f"res.csv {res_rows} lines")
    check(len(lines) == 1 and blocks == 1 and res_rows > 1
          and all(c.get(RANK1, 0) > 0 and c.get(NAME, 0) > 0 for c in cli),
          f"{what}: score lines {lines}, blocks {blocks}, launches {cli}")

    rb16 = rank1_bound(TRAIN_B, itemsize=2)
    return {"name": RANK1_BF16, "route": "cuda",
            "source": "ser_tpu_torch/csrc/rank1_attention.cu",
            "replaces": "ser_tpu/ops/attention.py:41",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": bf16_err, "ms": bf16_ms, "plain_ms": bf16_plain_ms,
            "bound_ms": rb16["both"][0], "bound_by": rb16["both"][1],
            "library_ms": bf16_sdpa_ms, "device_ms": statistics.median(device_ms[bf]),
            "f32_device_ms": statistics.median(device_ms[torch.float32])}, dp_launches, (
                one, ranks)


TP_WAYS = 2  # phase 15: tp 2 alone, and the (2, 2) grid
TP_GRID = (2, 2)


def launch_workers(out_dir, mode, n, timeout=420):
    """``n`` processes of this script as ``--tp_worker out_dir mode``,
    sharing the card over gloo (NCCL refuses two ranks on one card), each
    with its output in ``out_dir/<mode><rank>.log``; fails the run where one
    fails, and leaves none running."""
    port = str(free_port())
    logs = [Path(out_dir) / f"{mode}{r}.log" for r in range(n)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--tp_worker", str(out_dir),
                     mode],
                    env=dict(os.environ, WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK="0",
                             MASTER_ADDR="localhost", MASTER_PORT=port),
                    stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        check(p.returncode == 0, f"a --tp_worker {mode} process failed:\n"
              f"{log.read_text()[-3000:]}")
    return [json.loads((Path(out_dir) / f"{mode}{r}.json").read_text()) for r in range(n)]


def tp_worker(out_dir, mode):
    """One process of phase 15 (the module docstring): ``tp``, one of
    TP_WAYS processes at tp 2, or ``grid``, one of the TP_GRID processes.
    Writes its steps' arrays to ``out_dir/<mode><rank>.npz`` and its
    numbers, with the kernels' launches of each path counted from 0 just
    before it, to ``out_dir/<mode><rank>.json``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from ser_tpu_torch.data.loaders import EpochLoader, get_loaders
    from ser_tpu_torch.data.synthetic import synthetic_batch
    from ser_tpu_torch.device import disable_tf32
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels.lsthm import (lsthm_onlysp_recurrence_bidir,
                                                 lsthm_onlysp_recurrence_bidir_ref)
    from ser_tpu_torch.parallel import initialize_distributed, world
    from ser_tpu_torch.train import __main__ as train_cli
    from ser_tpu_torch.train.trainer import ModelTrainer

    disable_tf32()
    torch.cuda.set_device(0)  # NCCL refuses two ranks on one card; gloo shares it
    torch.distributed.init_process_group("gloo", init_method="env://")
    device = initialize_distributed("cuda")
    rank, size = world()
    out = Path(out_dir)
    result = {"rank": rank, "launches": {}}

    def counted(what, fn):
        torch.cuda.synchronize()
        reset_launches()
        value = fn()
        torch.cuda.synchronize()
        result["launches"][what] = dict(LAUNCHES)
        return value

    def timed(what, trainer, batch):
        torch.cuda.reset_peak_memory_stats()
        result[f"{what}_ms"] = [cuda_ms(torch, lambda: trainer._train_step_impl(batch, TRAIN_LR),
                                        warmup=0, iters=3)]
        result[f"{what}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    train_batch = synthetic_batch(L=TRAIN_L, B=TRAIN_B, seed=1, min_len=min(20, TRAIN_L))
    if mode == "tp":
        # (a) one step with dropout on; (d) what each process holds
        trainer = ModelTrainer(device=device, seed=0, lr=TRAIN_LR, tp=TP_WAYS,
                               res_csv_path=None)
        loss = counted("step", lambda: trainer._train_step_impl(train_batch, TRAIN_LR))
        params = trainer._whole_train_state()[0]
        np.savez(out / f"tp{rank}.npz", loss=loss.cpu().numpy(),
                 **{n: p.detach().cpu().numpy() for n, p in params.items()})
        result["param_bytes"] = sum(p.numel() * p.element_size()
                                    for p in trainer.model.parameters())
        result["adam_bytes"] = sum(v.numel() * v.element_size()
                                   for state in trainer.optimizer.state.values()
                                   for k, v in state.items() if k != "step")
        timed("step", trainer, train_batch)
        del trainer, params
        # (c) eval on the gathered weights, then the recurrence kernel
        #     against its plain version at the eval's shapes
        ev = ModelTrainer(device=device, seed=0, tp=TP_WAYS, res_csv_path=None)
        with ev.whole_parameters(reshard=True):
            randomize_constants(torch, [ev.model], seed=1)
        test_loader = get_loaders((out / "feats.txt").read_text(), valid=0.2,
                                  batch_size=TRAIN_B, seed=PREDICT_SEED)[2]
        result["acc"], result["f1"], _ = counted("eval", lambda: ev.eval_network(test_loader))
        result["kernel_err"], result["kernel_twice_equal"] = 0.0, True
        with ev.whole_parameters(), torch.inference_mode():
            for batch in test_loader:
                seqs, consts = ev.model.recurrence_inputs(*ev.predictor.batch_inputs(batch))[:2]
                got = lsthm_onlysp_recurrence_bidir(seqs, consts)
                again = lsthm_onlysp_recurrence_bidir(seqs, consts)
                want = lsthm_onlysp_recurrence_bidir_ref(seqs, consts)
                result["kernel_err"] = max(result["kernel_err"],
                                           (got - want).abs().max().item())
                result["kernel_twice_equal"] &= bool(torch.equal(got, again)
                                                     and torch.isfinite(got).all().item())
                result["kernel_shape"] = list(seqs[3].shape)
        del ev
        # (e) the train CLI
        t0 = time.perf_counter()
        counted("cli", lambda: run_quiet(in_dir, out, train_cli.main, train_cli.parser_args(
            ["--tp", str(TP_WAYS), "--synthetic", "--epoch", "1", "--batch_size", "16",
             "--num_workers", "0", "--save_path", str(out / "cli")])))
        result["cli_s"] = time.perf_counter() - t0
    else:
        # (b) the DP_CHECK_SHAPE step, dropout off, then the [110, 80] step timed
        dp_index, n_dp = rank // TP_WAYS, size // TP_WAYS
        L_c, B_c = DP_CHECK_SHAPE
        rows = lambda b, n: EpochLoader([], [], n, process_index=dp_index,  # noqa: E731
                                        process_count=n_dp)._local_rows(b)
        trainer = ModelTrainer(device=device, seed=0, lr=TRAIN_LR, tp=TP_WAYS,
                               res_csv_path=None)
        loss, grads, params = dp_step(torch, trainer, rows(
            synthetic_batch(L=L_c, B=B_c, seed=2, min_len=L_c // 2), B_c))
        np.savez(out / f"grid{rank}.npz", loss=np.float64(loss),
                 **{f"grad/{n}": g.numpy() for n, g in grads.items() if g is not None},
                 **{f"param/{n}": p.numpy() for n, p in params.items()})
        del trainer
        trainer = ModelTrainer(device=device, seed=0, lr=TRAIN_LR, tp=TP_WAYS,
                               res_csv_path=None)
        big = rows(train_batch, TRAIN_B)
        counted("step", lambda: trainer._train_step_impl(big, TRAIN_LR))
        timed("step", trainer, big)
    (out / f"{mode}{rank}.json").write_text(json.dumps(result))
    torch.distributed.destroy_process_group()
    return 0


def tp_phase(torch, card, dp_steps):
    """Phase 15 (the module docstring): ``--tp`` in processes sharing the
    card over gloo. ``dp_steps`` is phase 14's one-process and two-process
    DP_CHECK_SHAPE steps. Returns the rank-1 and recurrence kernels'
    launches by path, each counted from 0 just before its run."""
    import numpy as np

    from ser_tpu_torch.data.loaders import get_loaders
    from ser_tpu_torch.data.synthetic import generate_iemocap_pickles, synthetic_batch
    from ser_tpu_torch.ops.kernels import rank1 as rank1_kernel
    from ser_tpu_torch.ops.kernels.lsthm import NAME
    from ser_tpu_torch.parallel import shard_dims
    from ser_tpu_torch.train.trainer import ModelTrainer

    RANK1 = rank1_kernel.NAME
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        feats = generate_iemocap_pickles(str(Path(tmp) / "feats"), seed=PREDICT_SEED)
        (Path(tmp) / "feats.txt").write_text(feats)
        # the one-process references: (a)'s step with dropout on, twice;
        # (d)'s rule from shard_dims; (c)'s eval
        train_batch = synthetic_batch(L=TRAIN_L, B=TRAIN_B, seed=1, min_len=min(20, TRAIN_L))
        one = []
        for _ in range(2):
            trainer = ModelTrainer(seed=0, lr=TRAIN_LR, res_csv_path=None)
            loss = trainer._train_step_impl(train_batch, TRAIN_LR).cpu().numpy()
            one.append((loss, {n: p.detach().cpu().numpy()
                               for n, p in trainer.model.named_parameters()}))
        named = dict(trainer.model.named_parameters())
        dims = shard_dims(trainer.model, TP_WAYS)
        held = {n: p.numel() // TP_WAYS if dims[n] is not None else p.numel()
                for n, p in named.items()}
        rule_params = 4 * sum(held.values())
        rule_adam = 4 * 2 * sum(held[n] for n, p in named.items() if p.grad is not None)
        whole = 4 * sum(p.numel() for p in named.values())
        del trainer, named
        ev = ModelTrainer(seed=0, res_csv_path=None)
        randomize_constants(torch, [ev.model], seed=1)
        test_loader = get_loaders(feats, valid=0.2, batch_size=TRAIN_B, seed=PREDICT_SEED)[2]
        acc1, f11, _ = ev.eval_network(test_loader)
        del ev
        torch.cuda.synchronize()

        t0 = time.perf_counter()
        tp_res = launch_workers(tmp, "tp", TP_WAYS)
        tp_s = time.perf_counter() - t0
        tp_steps = [state_arrays(np, Path(tmp) / f"tp{r}.npz") for r in range(TP_WAYS)]
        lines = score_lines(Path(tmp) / "cli" / "score.txt")
        blocks = (Path(tmp) / "cli" / "score.txt").read_text().count("Model: MARN1_onlysp")
        t0 = time.perf_counter()
        grid_res = launch_workers(tmp, "grid", TP_GRID[0] * TP_GRID[1])
        grid_s = time.perf_counter() - t0
        grid_steps = [state_arrays(np, Path(tmp) / f"grid{r}.npz")
                      for r in range(TP_GRID[0] * TP_GRID[1])]

    # (a) tp 2 with dropout on against the one-process step
    same = lambda a, b: a.shape == b.shape and np.array_equal(  # noqa: E731
        a.view(np.uint32), b.view(np.uint32))
    deterministic = same(one[0][0], one[1][0]) and all(
        same(one[0][1][n], one[1][1][n]) for n in one[0][1])
    loss1, params1 = one[0]
    bit_equal = all(same(s["loss"], loss1) and all(same(s[n], p) for n, p in params1.items())
                    for s in tp_steps)
    loss_rel = max(abs(float(s["loss"]) - float(loss1)) / abs(float(loss1)) for s in tp_steps)
    moved = max(np.abs(s[n] - p).max() for s in tp_steps for n, p in params1.items())
    print(f"[tp] {TP_WAYS} processes sharing the card over gloo, tp={TP_WAYS}, MARN1_onlysp "
          f"[{TRAIN_L}, {TRAIN_B}] with dropout ({tp_s:.1f} s with eval and the CLI): two "
          f"one-process steps bit-equal: {deterministic}; the tp step's loss and gathered "
          f"parameters bit-equal to the one-process step: {bit_equal} (|loss| rel "
          f"{loss_rel:.3e}, max |param - one process| {moved / TRAIN_LR:.3f} lr)")
    if deterministic:
        check(bit_equal, "the tp step is not the one-process step bit for bit")
    else:
        check(loss_rel <= TRAIN_LOSS_RTOL and moved <= 2.05 * TRAIN_LR,
              "the tp step is not the one-process step at the train-step contract")
    # (d) what each process holds
    for r in tp_res:
        print(f"[tp] rank {r['rank']}: parameters {r['param_bytes']} B, Adam's moments "
              f"{r['adam_bytes']} B; the rule's {rule_params} B and {rule_adam} B (whole "
              f"parameters {whole} B)")
        check((r["param_bytes"], r["adam_bytes"]) == (rule_params, rule_adam),
              f"rank {r['rank']} holds {r['param_bytes']} B of parameters and "
              f"{r['adam_bytes']} B of moments, the rule {rule_params} B and {rule_adam} B")
    # (c) eval
    print(f"[tp] eval of the synthetic test split at batch {TRAIN_B} on the gathered "
          f"weights (constants made random): " + "; ".join(
              f"rank {r['rank']} Acc {r['acc']} F1 {r['f1']}, {NAME} "
              f"{r['launches']['eval'].get(NAME, 0)} launches" for r in tp_res)
          + f"; one process Acc {acc1} F1 {f11}")
    check(all((r["acc"], r["f1"]) == (acc1, f11) for r in tp_res),
          "tp eval does not give the one-process Acc and F1")
    kernel_err = max(r["kernel_err"] for r in tp_res)
    print(f"[tp] {NAME} at the eval's shape {tp_res[0]['kernel_shape']} on the gathered "
          f"weights: max|kernel - plain| {kernel_err:.3e}, two runs bit-equal and finite: "
          f"{all(r['kernel_twice_equal'] for r in tp_res)}")
    check(kernel_err <= 1e-4 and all(r["kernel_twice_equal"] for r in tp_res),
          f"{NAME} disagrees with its plain version at the tp eval's shape")
    # (b) the (2, 2) grid against the one-process step and the dp = 2 step
    (dloss1, dgrads1, dparams1), dp_ranks = dp_steps
    top = max(g.abs().max().item() for g in dgrads1.values() if g is not None)
    worst, moved, dead = 0.0, 0.0, set()
    for s in grid_steps:
        got = {k[len("grad/"):]: torch.from_numpy(v) for k, v in s.items()
               if k.startswith("grad/")}
        dead.add(len(dgrads1) - len(got))
        check(set(got) == {n for n, g in dgrads1.items() if g is not None},
              f"the (2, 2) grid's live set: {len(got)} of {len(dgrads1)}")
        for n, g in got.items():
            tol = GRAD_RTOL * dgrads1[n].abs().max().item() + GRAD_FLOOR * top
            worst = max(worst, (g - dgrads1[n]).abs().max().item() / tol)
        moved = max(moved, max((torch.from_numpy(s[f"param/{n}"]) - p).abs().max().item()
                               for n, p in dparams1.items()))
    loss_rel = max(abs(float(s["loss"]) - dloss1) / abs(dloss1) for s in grid_steps)
    as_dp = all(s["loss"] == dp_ranks[0]["loss"] and all(
        np.array_equal(s[k], dp_ranks[0][k]) for k in dp_ranks[0] if k.startswith("param/"))
        for s in grid_steps)
    L_c, B_c = DP_CHECK_SHAPE
    print(f"[tp] {TP_GRID[0] * TP_GRID[1]} processes sharing the card over gloo, dp="
          f"{TP_GRID[0]} x tp={TP_GRID[1]}, [{L_c}, {B_c}] dropout off ({grid_s:.1f} s with the "
          f"timed steps): |loss| rel {loss_rel:.3e} of the one-process step's, gradients "
          f"{worst:.3f} of the tolerance, dead {sorted(dead)}, max |param - one process| after "
          f"Adam {moved / TRAIN_LR:.3f} lr; loss and parameters bit-equal to phase 14's dp=2 "
          f"step: {as_dp}")
    check(loss_rel <= TRAIN_LOSS_RTOL and worst <= 1.0 and moved <= 2.05 * TRAIN_LR
          and dead == {ONLYSP_DEAD}, "the (2, 2) grid's step is not the one-process step")
    check(as_dp, "the (2, 2) grid's step is not phase 14's dp=2 step bit for bit")
    # (e) the CLI
    cli = [r["launches"]["cli"] for r in tp_res]
    print(f"[cli] train CLI --tp {TP_WAYS}, {TP_WAYS} processes over gloo, 1 epoch: "
          f"{max(r['cli_s'] for r in tp_res):.1f} s, launches by process {cli}; score.txt "
          f"blocks {blocks}, lines {lines}")
    check(len(lines) == 1 and blocks == 1
          and all(c.get(RANK1, 0) > 0 and c.get(NAME, 0) > 0 for c in cli),
          f"train CLI --tp: score lines {lines}, blocks {blocks}, launches {cli}")
    # times, memory and launches
    for what, res, n in ((f"tp={TP_WAYS}", tp_res, TP_WAYS),
                         (f"dp={TP_GRID[0]} x tp={TP_GRID[1]}", grid_res, TP_GRID[1])):
        steps = [r["launches"]["step"] for r in res]
        print(f"[time] {card} | {what} train step [{TRAIN_L}, {TRAIN_B}], {len(res)} processes "
              f"sharing the card over gloo (median of 3 a process): "
              + "; ".join(f"rank {r['rank']} {r['step_ms'][0]:.1f} ms, peak "
                          f"{r['step_peak_gib']:.4f} GiB" for r in res)
              + f"; launches a step by process {steps}")
        check(all(s == {RANK1: 2 * TRAIN_L} for s in steps),
              f"{what} step launched {steps}, want {RANK1} {2 * TRAIN_L}")
    sums = lambda res, what, name: sum(r["launches"][what].get(name, 0)  # noqa: E731
                                       for r in res)
    return {RANK1: {f"tp={TP_WAYS} train step [{TRAIN_L}, {TRAIN_B}], {TP_WAYS} processes":
                    sums(tp_res, "step", RANK1),
                    f"dp={TP_GRID[0]} x tp={TP_GRID[1]} train step [{TRAIN_L}, {TRAIN_B}], "
                    f"4 processes": sums(grid_res, "step", RANK1),
                    f"train CLI --tp {TP_WAYS}, {TP_WAYS} processes, 1 epoch":
                    sums(tp_res, "cli", RANK1)},
            NAME: {f"tp={TP_WAYS} eval, {TP_WAYS} processes": sums(tp_res, "eval", NAME),
                   f"train CLI --tp {TP_WAYS}, {TP_WAYS} processes, 1 epoch":
                   sums(tp_res, "cli", NAME)}}


# phase 16: the DialogueRNN suite's extras at full width. The JAX package
# fixes no width for them, so they take the registry DialogueRNN's (D_m 712,
# the trimodal input; D_g = D_p = 500, D_e = D_h = 300), the CNN its own
# defaults (embedding 300, 50 filters a width, 100 out, which is
# DailyDialogue's D_m), E2E D_emb 300 and D_m 100, a 20,000-token vocabulary
# and 32 words an utterance or a turn
EXTRA_WIDTHS = (500, 500, 300, 300)  # D_g, D_p, D_e, D_h
EXTRA_VOCAB, EXTRA_WORDS, DAILY_L = 20000, 32, 32
E2E_D_EMB, E2E_D_M = 300, 100


def extras_cases(np, torch):
    """Phase 16's models: name -> a dict of ``build(generator)``, the CPU
    ``inputs`` and forward ``kw``, ``pick`` (the output compared and
    trained), ``valid`` (its valid rows, or None for all), ``loss(out)``
    and ``evals`` (``(label, config)``: the model rebuilt with ``config``
    for an eval alone)."""
    from ser_tpu_torch.data.synthetic import synthetic_batch
    from ser_tpu_torch.models import dialogue_rnn_extras as X
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.train.losses import masked_mse_loss, masked_nll_loss

    rng = np.random.default_rng(16)
    batch = synthetic_batch(L=TRAIN_L, B=TRAIN_B, seed=1, min_len=min(20, TRAIN_L))
    x, qmask, umask = (torch.as_tensor(a) for a in get_model_spec("DialogueRNN").make_inputs(batch))
    labels = torch.as_tensor(batch["label"]).long()
    daily = synthetic_batch(L=DAILY_L, B=TRAIN_B, seed=3, min_len=8)
    d_qmask, d_umask = torch.as_tensor(daily["qmask"]), torch.as_tensor(daily["umask"])
    d_ids = torch.as_tensor(rng.integers(0, EXTRA_VOCAB, (DAILY_L, TRAIN_B, EXTRA_WORDS)))
    d_labels = torch.as_tensor(rng.integers(0, 7, (TRAIN_B, DAILY_L)))
    turns = tuple(torch.as_tensor(rng.integers(0, EXTRA_VOCAB, (EXTRA_WORDS, TRAIN_B)))
                  for _ in range(3))
    words = torch.as_tensor(rng.standard_normal((EXTRA_VOCAB, E2E_D_EMB)).astype(np.float32))
    e_labels = torch.as_tensor(rng.integers(0, 7, TRAIN_B))
    target = torch.as_tensor(rng.standard_normal(TRAIN_B * TRAIN_L).astype(np.float32))

    def nll_rows(out, lab, mask):  # [L, B, C] batch-major against [B, L]
        rows = out.transpose(0, 1).reshape(-1, out.shape[-1])
        return masked_nll_loss(rows, lab.to(out.device).reshape(-1), mask.to(out.device))

    def turn_nll(out):
        return masked_nll_loss(out, e_labels.to(out.device), out.new_ones(TRAIN_B))

    ident = lambda o: o  # noqa: E731
    return {
        "DialogueRNNModel": dict(
            build=lambda g, **c: X.DialogueRNNModel(712, *EXTRA_WIDTHS, n_classes=6, generator=g,
                                                    **c),
            inputs=(x, qmask, umask), kw=dict(att2=True), pick=ident, valid=umask.T > 0,
            loss=lambda o: nll_rows(o, labels, umask),
            evals=(("att2 off", None, dict(att2=False)), ("att2", None, dict(att2=True)),
                   ("general2, listener state, att2",
                    dict(context_attention="general2", listener_state=True), dict(att2=True)))),
        "AVECModel": dict(
            build=lambda g, **c: X.AVECModel(712, *EXTRA_WIDTHS, generator=g, **c),
            inputs=(x, qmask), kw={}, pick=ident, valid=umask.reshape(-1) > 0,
            loss=lambda o: masked_mse_loss(o, target.to(o.device), umask.to(o.device).reshape(-1)),
            evals=(("", None, {}),)),
        "DailyDialogueModel": dict(
            build=lambda g, **c: X.DailyDialogueModel(100, *EXTRA_WIDTHS, vocab_size=EXTRA_VOCAB,
                                                      generator=g, **c),
            inputs=(d_ids, d_qmask, d_umask), kw={}, pick=lambda o: o[0], valid=d_umask.T > 0,
            loss=lambda o: nll_rows(o, d_labels, d_umask), evals=(("att2", None, {}),)),
        "E2EModel": dict(
            build=lambda g, **c: X.E2EModel(E2E_D_EMB, E2E_D_M, *EXTRA_WIDTHS, generator=g, **c),
            inputs=(*turns, words), kw=dict(att2=True), pick=ident, valid=None, loss=turn_nll,
            evals=(("att2", None, dict(att2=True)),)),
        "BiE2EModel": dict(
            build=lambda g, **c: X.BiE2EModel(E2E_D_EMB, E2E_D_M, *EXTRA_WIDTHS,
                                              vocab_size=EXTRA_VOCAB, generator=g, **c),
            inputs=turns, kw=dict(att2=True), pick=ident, valid=None, loss=turn_nll,
            evals=(("att2", None, dict(att2=True)),)),
    }


def seeded_pair(torch, case, config=None):
    """The case's model on the CPU and on the card with the same seeded
    weights, carried through the JAX package's names (``to_jax_params``,
    ``from_jax_params``) and loaded strictly."""
    from ser_tpu_torch.compat.from_jax import from_jax_params, to_jax_params
    from ser_tpu_torch.ops.init import generator

    config = config or {}
    weights = from_jax_params(to_jax_params(case["build"](generator(0), **config).state_dict()))
    pair = {}
    for dev in ("cpu", "cuda"):
        model = case["build"](generator(1), **config)
        model.load_state_dict(weights, strict=True)
        pair[dev] = model.to(dev)
    return pair


def extras_step(torch, model, case, inputs, generator):
    """One train step of a phase 16 model on ``inputs`` (on its device):
    forward, loss, backward, the port's Adam at TRAIN_LR; returns the
    loss."""
    from ser_tpu_torch.train.optim import torch_adam

    out = case["pick"](model(*inputs, **case["kw"], generator=generator))
    loss = case["loss"](out)
    loss.backward()
    torch_adam(model.parameters(), lr=TRAIN_LR).step()
    return loss


def kept_fractions(torch, fn):
    """Calls ``fn`` with every dropout of the port recorded: ``{rate: (live
    entries drawn, kept)}``, counted where the input was nonzero."""
    from ser_tpu_torch.models import dialogue_rnn
    from ser_tpu_torch.ops import layers

    real, drawn = layers.dropout, {}

    def recording(x, p, generator):
        out = real(x, p, generator)
        live = x != 0
        n, k = drawn.get(p, (0, 0))
        drawn[p] = (n + int(live.sum()), k + int((live & (out != 0)).sum()))
        return out

    layers.dropout = dialogue_rnn.dropout = recording
    try:
        fn()
    finally:
        layers.dropout = dialogue_rnn.dropout = real
    return drawn


def extras_phase(torch, card, cli_res, cli_report, onlysp_request_ms, onlysp_step_ms,
                 eval_batch, meld_path):
    """Phase 16 (the module docstring)."""
    import copy

    import numpy as np

    from ser_tpu_torch import analysis
    from ser_tpu_torch.data import loaders
    from ser_tpu_torch.data.collate import collate, collate_ref
    from ser_tpu_torch.data.synthetic import generate_iemocap_pickles, synthetic_batch
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.ops.kernels import reset_launches
    from ser_tpu_torch.ops.layers import Dropout
    from ser_tpu_torch.serving import Predictor
    from ser_tpu_torch.train.trainer import ModelTrainer
    from ser_tpu_torch.utils.flops import count_flops, efficiency

    # (a), (b) the six extras, card against CPU, then their times
    for name, case in extras_cases(np, torch).items():
        t0 = time.perf_counter()
        for label, config, kw in case["evals"]:
            pair = seeded_pair(torch, case, config)
            reset_launches()
            with torch.inference_mode():
                outs = {d: case["pick"](m.eval()(*(a.to(d) for a in case["inputs"]), **kw))
                        for d, m in pair.items()}
            no_port_kernel(torch, f"{name} {label}")
            out, ref = outs["cuda"].cpu(), outs["cpu"]
            check(out.shape == ref.shape and torch.isfinite(out).all().item(),
                  f"{name} {label}: non-finite or misshapen outputs")
            if case["valid"] is not None:
                out, ref = out[case["valid"]], ref[case["valid"]]
            print(f"[extras] {name} {label} {list(case['inputs'][0].shape)}: no port kernel "
                  f"launched, max|gpu-cpu| {(out - ref).abs().max().item():.3e} over "
                  f"{len(out)} valid rows, max|out| {ref.abs().max().item():.3e}")
            check(torch.allclose(out, ref, rtol=1e-3, atol=1e-4),
                  f"{name} {label}: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
        # one step, dropout off, card against CPU; the card replays the
        # CPU's ReLU decisions (PinnedRelu), the flips counted and bounded
        pair = seeded_pair(torch, case)
        start = {k: v.clone() for k, v in pair["cpu"].state_dict().items()}
        loss = {}
        reset_launches()
        with PinnedRelu(torch) as relu:
            for d, m in pair.items():  # the CPU first, then the card
                no_dropout(m.train(), Dropout)
                loss[d] = extras_step(torch, m, case, [a.to(d) for a in case["inputs"]],
                                      torch.Generator(device=d)).item()
                relu.replay()
        no_port_kernel(torch, f"{name} check step")
        worst, dead_cpu, dead_card = grad_check(torch, pair["cpu"], pair["cuda"])
        moved = max((p.detach().cpu() - q.detach()).abs().max().item() for p, q in zip(
            pair["cuda"].parameters(), pair["cpu"].parameters()))
        loss_rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        print(f"[extras] {name} one step card vs CPU (dropout off, the CPU's ReLU decisions): "
              f"|loss| rel {loss_rel:.3e}, gradients {worst:.3f} of the tolerance, "
              f"{len(dead_card)} parameters with no gradient, max |param card - CPU| after Adam "
              f"{moved / TRAIN_LR:.3f} lr; {relu.flips} of {relu.total} ReLU decisions replaced")
        check(relu.flips <= 1e-5 * relu.total, f"{name}: the card's forward crossed "
              f"{relu.flips} ReLU kinks, more than rounding explains")
        check(loss_rel <= TRAIN_LOSS_RTOL, f"{name} step loss: card and CPU disagree")
        check(worst <= 1.0, f"{name} step gradients: card and CPU disagree")
        check(dead_cpu == dead_card, f"{name} dead parameters: CPU {sorted(dead_cpu)}, card "
              f"{sorted(dead_card)}")
        check(moved <= 2.05 * TRAIN_LR, f"{name} Adam updates: card and CPU differ")
        del pair, start

        # one step with dropout on (the card): finite, each rate's kept
        # fraction within 6 standard deviations of 1 - p
        model = case["build"](torch.Generator().manual_seed(0)).cuda().train()
        gen = torch.Generator(device="cuda").manual_seed(0)
        inputs = [a.cuda() for a in case["inputs"]]
        losses = []
        drawn = kept_fractions(torch, lambda: losses.append(
            extras_step(torch, model, case, inputs, gen).item()))
        line = []
        for p, (n, k) in sorted(drawn.items()):
            line.append(f"p {p}: {k / n:.5f} kept of {n}")
            check(abs(k / n - (1 - p)) < 6 * math.sqrt(p * (1 - p) / n),
                  f"{name}: dropout {p} kept {k / n:.5f} of {n}")
        check(math.isfinite(losses[0]) and drawn, f"{name}: dropout step loss {losses}")
        print(f"[extras] {name} step with dropout on: loss {losses[0]:.5f}; " + "; ".join(line))

        # (b) a request (inputs on the card, the output copied out) and a
        #     step on the card: median ms, launches, idle, peak memory
        model.eval()

        def request():
            with torch.inference_mode():
                return case["pick"](model(*inputs, **case["kw"])).cpu()

        req_ms = cuda_ms(torch, request, warmup=2, iters=10)
        wall, busy, events = device_profile(torch, request, 1)
        n_req, _, _ = kernel_split(events, 1)
        req_idle = 100 * (1 - busy / wall)
        model.train()
        step = lambda: extras_step(torch, model, case, inputs, gen)  # noqa: E731
        step()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(torch, step, warmup=0, iters=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall, busy, events = device_profile(torch, step, 1)
        n_step, _, _ = kernel_split(events, 1)
        print(f"[time] {card} | {name} {list(case['inputs'][0].shape)}: request "
              f"{req_ms:.3f} ms (median of 10), {n_req:.0f} kernel launches, idle "
              f"{req_idle:.1f}%; step {step_ms:.2f} ms (median of 3), {n_step:.0f} launches, "
              f"idle {100 * (1 - busy / wall):.1f}%, peak {peak:.4f} GiB ({peak - held:.4f} "
              f"above what was held before the step); {time.perf_counter() - t0:.1f} s")
        del model, gen, step, inputs

    # (c) the C collate: the loaders' batches through it bit-equal to the
    #     numpy version, IEMOCAP and MELD; host ms of a [110, 80] batch
    real_collate, compared = loaders.collate, []

    def both(items, **kw):
        got = real_collate(items, **kw)
        want = collate_ref(items, **kw)
        same = sorted(got) == sorted(want) and got["vid"] == want["vid"] and all(
            got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
            for k in got if k != "vid")
        compared.append(same)
        return got

    with tempfile.TemporaryDirectory(prefix="chip_smoke_collate_") as tmp:
        iemocap_path = generate_iemocap_pickles(tmp, seed=PREDICT_SEED)
        loaders.collate = both
        try:
            for path, dataset, n_classes in ((iemocap_path, "IEMOCAP", 6),
                                             (meld_path, "MELD", 7)):
                for loader in loaders.get_loaders(path, dataset, batch_size=TRAIN_B,
                                                  n_classes=n_classes):
                    for _ in loader:
                        pass
        finally:
            loaders.collate = real_collate
        train_set = loaders.IEMOCAPDataset(
            path=iemocap_path + "IEMOCAP_features/IEMOCAP_features_raw.pkl")
        items = [train_set[i] for i in range(TRAIN_B)]
    check(compared and all(compared), f"C collate differs from numpy on "
          f"{compared.count(False)} of {len(compared)} loader batches")
    host, L_c = {}, max([TRAIN_L] + [it[8].shape[0] for it in items])
    for way, fn in (("C", collate), ("numpy", collate_ref), ("C", collate),
                    ("numpy", collate_ref)):
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn(items, pad_length=L_c, pad_batch=TRAIN_B)
            times.append((time.perf_counter() - t0) * 1e3)
        host.setdefault(way, []).append(statistics.median(times))
    print(f"[collate] {card} | {len(compared)} loader batches (IEMOCAP and MELD, batch "
          f"{TRAIN_B}) bit-equal through the C path and numpy; a [{L_c}, {TRAIN_B}] "
          f"batch on the host (median of 10, in turns C, numpy, C, numpy): C {host['C']} ms, "
          f"numpy {host['numpy']} ms")

    # (d) FLOPs of onlysp's eval forward [82, 31] and train step [110, 80],
    #     counted on the plain path on the CPU, against phases 5 and 8
    x, qmask, umask = get_model_spec("MARN1_onlysp").make_inputs(eval_batch)
    cpu = Predictor(seed=0, device="cpu")
    with torch.inference_mode():
        eval_flops = count_flops(cpu.model, *(torch.as_tensor(a) for a in (x, qmask, umask)))
    trainer = ModelTrainer(device="cpu", seed=0, lr=TRAIN_LR)
    train_batch = synthetic_batch(L=TRAIN_L, B=TRAIN_B, seed=1, min_len=min(20, TRAIN_L))
    step_flops = count_flops(lambda: trainer._train_step_impl(train_batch, TRAIN_LR))
    step_ms = statistics.median(onlysp_step_ms)
    print(f"[flops] {card} | MARN1_onlysp eval forward {list(qmask.shape[:2])}: {eval_flops} "
          f"FLOPs, {efficiency(eval_flops, onlysp_request_ms / 1e3)} at phase 5's request "
          f"{onlysp_request_ms:.4f} ms; train step [{TRAIN_L}, {TRAIN_B}]: {step_flops} FLOPs, "
          f"{efficiency(step_flops, step_ms / 1e3)} at phase 8's step {step_ms:.2f} ms")
    check(eval_flops > 0 and step_flops > 0, "FLOP counts")
    del cpu, trainer

    # (e) analyze_res on phase 4c's res.csv: the predict CLI's Acc and F1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_analysis_") as tmp:
        res = Path(tmp) / "res.csv"
        res.write_text(cli_res)
        report = analysis.analyze_res(str(res))
    print(f"[analysis] phase 4c's res.csv: {json.dumps(report)}")
    check(report["weighted_accuracy"] == cli_report["weighted_accuracy"]
          and report["weighted_f1"] == cli_report["weighted_f1"],
          f"analyze_res gives {report['weighted_accuracy']}, {report['weighted_f1']}; the "
          f"predict CLI {cli_report['weighted_accuracy']}, {cli_report['weighted_f1']}")


# phase 17: the train CLI's --eval score header, ModelTrainer's h.csv, the
# two user scripts, and the attention zoo's 20 classes no flag reaches, at
# the JAX classes' default widths on a batch of 50 (the vendored modules'
# own examples: NCHW [50, 512, 7, 7], sequences [50, 49, 512]). UFO and
# EMSA have no default heads: 8 of 64, the encoder zoo's rule at 512
ZOO_B, ZOO_C, ZOO_HW, ZOO_HEADS = 50, 512, 7, 8
ZOO_ITERS = 10
CONVERGENCE_ARGS = ["--models", "MARN1_onlysp", "--seeds", "1", "--epochs", "1"]


def zoo_classes(torch):
    """name -> (port module from a generator, input on the CPU, sequence op)."""
    from ser_tpu_torch.ops import attention_zoo as Z

    C, n, h = ZOO_C, ZOO_HW * ZOO_HW, ZOO_HEADS
    nchw = torch.randn(ZOO_B, C, ZOO_HW, ZOO_HW, generator=torch.Generator().manual_seed(17))
    seq = torch.randn(ZOO_B, n, C, generator=torch.Generator().manual_seed(18))
    cases = {
        "SEAttention": lambda g: Z.SEAttention(C, generator=g),
        "ECAAttention": lambda g: Z.ECAAttention(generator=g),
        "CBAMChannelGate": lambda g: Z.CBAMChannelGate(C, generator=g),
        "CBAMSpatialGate": lambda g: Z.CBAMSpatialGate(generator=g),
        "CBAMBlock": lambda g: Z.CBAMBlock(C, generator=g),
        "SpatialGroupEnhance": lambda g: Z.SpatialGroupEnhance(generator=g),
        "CoordAttention": lambda g: Z.CoordAttention(C, C, generator=g),
        "TripletAttention": lambda g: Z.TripletAttention(generator=g),
        "ShuffleAttention": lambda g: Z.ShuffleAttention(C, generator=g),
        "SKAttention": lambda g: Z.SKAttention(C, generator=g),
        "BAMBlock": lambda g: Z.BAMBlock(C, generator=g),
        "PSA": lambda g: Z.PSA(C, generator=g),
        "CoTAttention": lambda g: Z.CoTAttention(C, generator=g),
        "DoubleAttention": lambda g: Z.DoubleAttention(C, 128, 128, generator=g),
        "DAModule": lambda g: Z.DAModule(C, 3, ZOO_HW, ZOO_HW, generator=g),
        "PolarizedSelfAttention": lambda g: Z.PolarizedSelfAttention(C, generator=g),
        "PolarizedSelfAttention sequential": lambda g: Z.PolarizedSelfAttention(
            C, True, generator=g),
        "S2Attention": lambda g: Z.S2Attention(C, generator=g),
    }
    out = {name: (build, nchw, False) for name, build in cases.items()}
    out["AFTFull"] = (lambda g: Z.AFTFull(C, n, generator=g), seq, False)
    out["UFOAttention"] = (lambda g: Z.UFOAttention(C, C // h, C // h, h, generator=g),
                           seq, True)
    out["EMSA"] = (lambda g: Z.EMSA(C, C // h, C // h, h, ZOO_HW, ZOO_HW, generator=g),
                   seq, True)
    return out


def randomize_zoo(torch, module, seed):
    """Every parameter and statistic of a zoo module drawn anew, so that no
    nonlinearity sits at its init's linear or constant point: a matrix or
    kernel N(0, 1/fan_in), a running variance in [0.5, 1.5), a norm's
    weight 1 + N(0, 0.1²), a running mean N(0, 0.1²), any other vector
    N(0, 0.5²)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            z = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif t.ndim >= 2:
                t.copy_(z / math.sqrt(t.numel() / t.shape[0]))
            elif name.endswith("running_mean"):
                t.copy_(0.1 * z)
            elif name.endswith("weight"):
                t.copy_(1.0 + 0.1 * z)
            else:
                t.copy_(0.5 * z)


def tools_zoo_phase(torch, card, weights, artifacts):
    """Phase 17 (the module docstring). ``weights``: phase 4's onlysp state
    dict; ``artifacts``: phase 12's f32, bf16 and int8 onlysp artifacts.
    Returns the launches of the recurrence kernel and of both rank-1 forms
    by path, each counted from 0 just before its run."""
    import numpy as np

    from ser_tpu_torch.compat.from_jax import to_jax_params
    from ser_tpu_torch.data.loaders import get_loaders
    from ser_tpu_torch.data.synthetic import generate_iemocap_pickles, synthetic_batch
    from ser_tpu_torch.ops.init import generator
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels.lsthm import NAME
    from ser_tpu_torch.ops.kernels.rank1 import NAME as RANK1, NAME_BF16 as RANK1_BF16
    from ser_tpu_torch.scripts import compare_artifacts, convergence_bf16
    from ser_tpu_torch.serving import GRAPH_WARMUP, ServingModel
    from ser_tpu_torch.train import __main__ as train_cli
    from ser_tpu_torch.train.trainer import ModelTrainer

    launches = {NAME: {}, RANK1: {}, RANK1_BF16: {}}
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_tools_")
    tmp = Path(tmp_dir.name)

    # (a) train --eval True on the card and on the CPU: score.txt's header;
    #     ModelTrainer's h.csv beside res.csv, card against CPU
    t0 = time.perf_counter()
    ckpt = tmp / "onlysp.npz"
    np.savez(ckpt, **to_jax_params(weights))
    pickles = generate_iemocap_pickles(str(tmp / "pickles"), seed=PREDICT_SEED)
    scores, cli_path = {}, "train --eval True, the test split at batch 80"
    for dev in ("cuda", "cpu"):
        reset_launches()
        argv = ["--eval", "True", "--initial_model", str(ckpt), "--feature_path", pickles,
                "--save_path", str(tmp / dev), "--num_workers", "0", "--device", dev]
        out = in_dir(tmp, run_quiet, train_cli.main, train_cli.parser_args(argv))
        if dev == "cuda":
            launches[NAME][cli_path] = LAUNCHES[NAME]
        scores[dev] = (tmp / dev / "score.txt").read_bytes()
        check("Acc " in out and "is not in the model" not in out,
              f"train --eval ({dev}): {out}")
    header = "Model: MARN1_onlysp \nDataset : IEMOCAP\n" + "-" * 20 + "\n"
    print(f"[tools] train --eval True: score.txt {scores['cuda']!r} on the card, byte-equal to "
          f"the CPU's: {scores['cuda'] == scores['cpu']}; {NAME} launches "
          f"{launches[NAME][cli_path]}")
    check(scores["cuda"] == scores["cpu"] == header.encode(),
          f"train --eval's score.txt: card {scores['cuda']!r}, CPU {scores['cpu']!r}")
    check(LAUNCHES[NAME] == 0 and launches[NAME][cli_path] > 0,
          "train --eval on the card did not launch the recurrence kernel")
    test_loader = get_loaders(pickles, batch_size=80, valid=0.2, seed=PREDICT_SEED)[2]
    rows, h_path = {}, "ModelTrainer eval with h.csv"
    for dev in ("cuda", "cpu"):
        trainer = ModelTrainer(device=dev, res_csv_path=str(tmp / f"res_{dev}.csv"),
                               legacy_h_csv_path=str(tmp / f"h_{dev}.csv"))
        run_quiet(trainer.load_parameters, str(ckpt))
        reset_launches()
        trainer.eval_network(test_loader)
        torch.cuda.synchronize()
        if dev == "cuda":
            launches[NAME][h_path] = LAUNCHES[NAME]
        rows[dev] = list(csv.reader((tmp / f"h_{dev}.csv").read_text().splitlines()))
        res = list(csv.reader((tmp / f"res_{dev}.csv").read_text().splitlines()))
        check(rows[dev][1:] == [[r[1], r[0], r[2]] for r in res[1:]],
              f"h.csv ({dev}) does not hold res.csv's rows")
    h, h_cpu = rows["cuda"], rows["cpu"]
    valid = [i for i, r in enumerate(h[1:], 1) if float(r[2]) > 0]
    agree = sum(h[i][1] == h_cpu[i][1] for i in valid) / max(len(valid), 1)
    print(f"[tools] ModelTrainer h.csv: {len(h) - 1} rows, header {','.join(h[0])}; trues and "
          f"masks card = CPU: {[r[0::2] for r in h] == [r[0::2] for r in h_cpu]}, predictions "
          f"agree on {agree:.5f} of {len(valid)} valid rows; {NAME} launches "
          f"{launches[NAME][h_path]}")
    check(h[0] == ["trues", "preds", "masks"] and len(h) == len(h_cpu) > 1
          and [r[0::2] for r in h] == [r[0::2] for r in h_cpu] and agree >= 0.999,
          f"h.csv: card and CPU differ (agreement {agree})")
    check(launches[NAME][h_path] > 0, "the h.csv eval launched no "
          f"{NAME}")
    print(f"[tools] (a) in {time.perf_counter() - t0:.1f} s")

    # (b) compare_artifacts on phase 12's three onlysp artifacts, against
    #     the same figures computed here from ServingModel on the same batch
    t0 = time.perf_counter()
    cmp_path = "compare_artifacts, 3 artifacts at [110, 80]"
    reset_launches()
    report, _ = run_cli_json(compare_artifacts.main, list(artifacts))
    torch.cuda.synchronize()
    launches[NAME][cmp_path] = LAUNCHES[NAME]
    print(f"[tools] compare_artifacts: {json.dumps(report)}")
    served = [ServingModel.load(path, device="cuda") for path in artifacts]
    L, B = served[0].buckets[-1]
    batch = synthetic_batch(L=L, B=B, n_classes=6, seed=3)
    base = served[0].predict(batch)["logp"]
    valid = batch["umask"] > 0
    for path, s in zip(artifacts[1:], served[1:]):
        dtype, logp = s.header.get("dtype", "f32"), s.predict(batch)["logp"]
        d = np.abs(logp - base)[valid]
        inline = {"path": path, "max_logp_drift": float(d.max()),
                  "mean_logp_drift": float(d.mean()), "argmax_agreement": round(float(
                      (logp.argmax(-1) == base.argmax(-1))[valid].mean()), 4)}
        print(f"[tools] {dtype} inline (new bucket graphs, the same batch): {inline}; equal to "
              f"compare_artifacts' {report[dtype] == inline}")
        # other graphs of the same forward: the figures within 1e-5, the
        # agreement within one row of a thousand
        check(report[dtype]["path"] == path and all(
            abs(report[dtype][k] - inline[k]) <= 1e-5 for k in ("max_logp_drift",
                                                                "mean_logp_drift"))
              and abs(report[dtype]["argmax_agreement"] - inline["argmax_agreement"]) <= 1e-3,
              f"compare_artifacts {dtype}: {report[dtype]}, inline {inline}")
    check(report["model"] == "MARN1_onlysp" and report["shape"] == [L, B]
          and report["bf16"]["max_logp_drift"] < 0.5
          and report["int8"]["argmax_agreement"] >= 0.9,
          f"compare_artifacts: {report}")
    want = len(artifacts) * (GRAPH_WARMUP + 1)
    check(launches[NAME][cmp_path] == want,
          f"compare_artifacts launched {NAME} "
          f"{launches[NAME][cmp_path]} times, want {want}")
    del served
    print(f"[tools] (b) in {time.perf_counter() - t0:.1f} s")

    # (c) convergence_bf16, one seed, one epoch, on the card: the rank-1
    #     kernel 2T times a step in f32, its bf16 form 2T times a step in bf16
    t0 = time.perf_counter()
    # the script's set and loaders: its f32 run trains on the train
    # loader's first epoch, its bf16 run on the second
    steps = generate_iemocap_pickles(str(tmp / "conv"), **convergence_bf16.DATA)
    conv_train, _, conv_test = get_loaders(steps, batch_size=8, valid=0.25)
    two_t = [2 * sum(b["qmask"].shape[0] for b in conv_train) for _ in range(2)]
    n_test = len(conv_test)
    reset_launches()
    out = tmp / "conv.json"
    run_quiet(convergence_bf16.main, CONVERGENCE_ARGS + ["--out", str(out)])
    doc = json.loads(out.read_text())
    torch.cuda.synchronize()
    got = {k: LAUNCHES[k] for k in (RANK1, RANK1_BF16, NAME)}
    what = "convergence_bf16 MARN1_onlysp, 1 seed, 1 epoch"
    launches[RANK1][what], launches[RANK1_BF16][what], launches[NAME][what] = got.values()
    run = doc["models"]["MARN1_onlysp"]
    print(f"[tools] {what}: f32 {run['f32']['runs'][0]}, bf16 {run['bf16']['runs'][0]}; "
          f"launches {got}, want {two_t[0]} f32 and {two_t[1]} bf16 rank-1 launches (2T a "
          f"step over {len(conv_train)} steps an epoch) and {2 * n_test} of {NAME}")
    check(list(doc) == ["backend", "epochs", "seeds", "n_train", "n_test", "models"]
          and doc["backend"] == "cuda" and list(run) == [
              "f32", "bf16", "f1_gap_mean", "f32_seed_spread", "within_seed_noise"]
          and all(list(run[d]) == ["runs", "f1_mean", "f1_min", "f1_max"]
                  and list(run[d]["runs"][0]) == ["final_loss", "first_loss", "acc", "f1",
                                                  "wall_s"] for d in ("f32", "bf16")),
          f"convergence_bf16's document: {doc}")
    check(got == {RANK1: two_t[0], RANK1_BF16: two_t[1], NAME: 2 * n_test},
          f"convergence_bf16 launches {got}")
    print(f"[tools] (c) in {time.perf_counter() - t0:.1f} s")

    # (d) the 20 zoo classes, card against CPU: a forward, and a forward and
    #     backward of a fixed weighted sum, the card replaying the CPU's ReLU
    #     decisions; no port kernel; ms a forward and a forward and backward
    t0 = time.perf_counter()
    for name, (build, x, seq) in zoo_classes(torch).items():
        pair = {}
        for dev in ("cpu", "cuda"):
            m = build(generator(0))
            randomize_zoo(torch, m, seed=5)
            pair[dev] = m.to(dev).eval()
        call = lambda m, xi: m(xi, xi, xi) if seq else m(xi)  # noqa: E731
        xs = {"cpu": x.clone().requires_grad_(), "cuda": x.cuda().requires_grad_()}
        outs = {}
        reset_launches()
        with PinnedRelu(torch) as relu:
            for dev in ("cpu", "cuda"):  # the CPU first, then the card
                outs[dev] = call(pair[dev], xs[dev])
                if dev == "cpu":  # the sum's weights
                    w = torch.randn(outs[dev].shape, generator=torch.Generator().manual_seed(6))
                (outs[dev] * w.to(dev)).sum().backward()
                relu.replay()
        w = w.cuda()
        no_port_kernel(torch, f"zoo {name}")
        out, ref = outs["cuda"].detach().cpu(), outs["cpu"].detach()
        worst, dead_cpu, dead_card = grad_check(torch, pair["cpu"], pair["cuda"])
        gx, gx_ref = xs["cuda"].grad.cpu(), xs["cpu"].grad
        gx_worst = ((gx - gx_ref).abs().max() / (GRAD_RTOL * gx_ref.abs().max())).item()
        for p in pair["cuda"].parameters():
            p.grad = None
        xc = xs["cuda"].detach()
        with torch.no_grad():
            fwd_ms = cuda_ms(torch, lambda: call(pair["cuda"], xc), warmup=2, iters=ZOO_ITERS)
        xg = xc.clone().requires_grad_()
        both_ms = cuda_ms(torch, lambda: (call(pair["cuda"], xg) * w).sum().backward(),
                          warmup=2, iters=ZOO_ITERS)
        no_port_kernel(torch, f"zoo {name} timed")
        err = (out - ref).abs().max().item()
        print(f"[zoo] {name} {list(x.shape)} -> {list(ref.shape)}: max|card - CPU| {err:.3e} "
              f"(max|out| {ref.abs().max().item():.3e}), gradients {worst:.3f} and input "
              f"gradient {gx_worst:.3f} of the tolerance, {relu.flips} of {relu.total} ReLU "
              f"decisions replaced; no port kernel")
        print(f"[time] {card} | zoo {name} [{ZOO_B}, ...]: forward {fwd_ms:.4f} ms, forward "
              f"and backward {both_ms:.4f} ms (median of {ZOO_ITERS})")
        check(torch.isfinite(out).all().item() and out.shape == ref.shape,
              f"zoo {name}: non-finite or misshapen output")
        check(torch.allclose(out, ref, rtol=1e-3, atol=1e-4),
              f"zoo {name}: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
        check(worst <= 1.0 and gx_worst <= 1.0 and dead_cpu == dead_card == set(),
              f"zoo {name}: gradients card and CPU disagree ({worst}, {gx_worst}) or are "
              f"missing ({sorted(dead_card)})")
        check(relu.flips <= 1e-5 * max(relu.total, 1), f"zoo {name}: the card's forward "
              f"crossed {relu.flips} ReLU kinks")
        del pair, outs, xs, xc, xg, w
    torch.cuda.empty_cache()
    print(f"[tools] (d) in {time.perf_counter() - t0:.1f} s")
    tmp_dir.cleanup()
    return launches


# phase 18: the attention zoo's last 15 classes, the vision blocks and the
# Swin-family backbones, at the JAX classes' default widths. The blocks run
# at batch 50 (NCHW [50, 512, 7, 7] where a class has no default, as phase
# 17; ViP, Outlook and Halo at the shapes their rules demand; MobileViT on
# [50, 3, 49, 49]), the backbones on [B, 3, 224, 224] images at batch 32; the
# card-against-CPU check of the backbones and of MobileViT (4.5 TFLOP a
# forward and backward at batch 50 on the CPU) runs at batch 2
LAST_B, BACKBONE_B, CHECK_B = 50, 32, 2


def last_zoo_classes(torch):
    """name -> (port module from a generator, input on the CPU at the timed
    batch, the batch of the card-against-CPU check, parameters whose
    gradient is None)."""
    from ser_tpu_torch.ops import attention_zoo_transformers as ZT
    from ser_tpu_torch.ops import attention_zoo_vision as ZV

    C = ZOO_C

    def draw(*shape, seed):
        return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))

    nchw = draw(LAST_B, C, ZOO_HW, ZOO_HW, seed=19)
    image = draw(BACKBONE_B, 3, 224, 224, seed=20)
    blocks = {
        "ResidualAttention": (lambda g: ZV.ResidualAttention(C, generator=g), nchw),
        "ParNetAttention": (lambda g: ZV.ParNetAttention(C, generator=g), nchw),
        "CrissCrossAttention": (lambda g: ZV.CrissCrossAttention(C, generator=g), nchw),
        "WeightedPermuteMLP": (lambda g: ZV.WeightedPermuteMLP(C, 8, generator=g),
                               draw(LAST_B, 8, 8, C, seed=21)),
        "OutlookAttention": (lambda g: ZV.OutlookAttention(C, generator=g),
                             draw(LAST_B, 28, 28, C, seed=22)),
        "HaloAttention": (lambda g: ZV.HaloAttention(C, 2, 1, generator=g),
                          draw(LAST_B, C, 8, 8, seed=23)),
        "ACmix": (lambda g: ZV.ACmix(C, C, generator=g), nchw),
        "AxialAttention": (lambda g: ZV.AxialAttention(C, generator=g), nchw),
        "MBConvBlock": (lambda g: ZV.MBConvBlock(3, C, C, generator=g), nchw),
    }
    out = {name: (build, x, LAST_B, set()) for name, (build, x) in blocks.items()}
    out["MobileViTAttention"] = (lambda g: ZV.MobileViTAttention(generator=g),
                                 draw(LAST_B, 3, 49, 49, seed=24), CHECK_B, set())
    out["GFNet"] = (lambda g: ZV.GFNet(generator=g), image, CHECK_B,
                    {"embedding.weight", "embedding.bias"})
    out["CoAtNet"] = (lambda g: ZV.CoAtNet(3, 224, generator=g), image, CHECK_B, set())
    for name in ("CrossFormer", "MOATransformer", "DAT"):
        out[name] = (lambda g, cls=getattr(ZT, name): cls(generator=g), image, CHECK_B, set())
    return out


class PinnedKinks:
    """``PinnedRelu`` for every kink of phase 18's classes: ``torch.relu``,
    the max pools (``F.max_pool2d``, ``F.max_pool1d``, ``torch.amax``) and
    the floors of ``grid_sample_bilinear``'s sample coordinates. The CPU's
    pass records each call's decisions (relu's signs, the pools' argmax,
    the sample cells); ``own()`` lets the card decide for itself and counts
    where it differs; after ``replay()`` the card takes the recorded
    decisions: relu as ``x * mask``, a pool as a gather of the recorded
    elements, and a sample whose cell differs as the bilinear blend of the
    recorded cell's corners (extrapolating a rounding's width), whose
    gradients are the CPU's branch's. ``flips`` and ``total`` count the
    card's own decisions that differ, by kind; a max pool's choice differs
    where the recorded element is not the card's max, and ``max_gap`` is
    the largest such gap over the pool's largest max: near-equal elements
    (rounding) choose either way, where the pooled tokens are near copies
    of each other (CoAtNet's sequence), without moving the gradients."""

    def __init__(self, torch):
        from ser_tpu_torch.ops import attention_zoo_transformers as ZT

        F = torch.nn.functional
        self.torch = torch
        self.sites = [(torch, "relu", self.relu), (torch, "amax", self.amax),
                      (F, "max_pool2d", self.max_pool2d), (F, "max_pool1d", self.max_pool1d),
                      (ZT, "grid_sample_bilinear", self.grid_sample)]
        self.real = {name: getattr(owner, name) for owner, name, _ in self.sites}
        self.records, self.i, self.mode, self.max_gap = [], 0, "record", 0.0
        self.flips = {"relu": 0, "max": 0, "cell": 0}
        self.total = dict.fromkeys(self.flips, 0)

    def __enter__(self):
        for owner, name, fn in self.sites:
            setattr(owner, name, fn)
        return self

    def __exit__(self, *exc):
        for owner, name, _ in self.sites:
            setattr(owner, name, self.real[name])

    def own(self):
        self.mode, self.i, self.max_gap = "own", 0, 0.0
        self.flips = dict.fromkeys(self.flips, 0)
        self.total = dict.fromkeys(self.flips, 0)

    def replay(self):
        self.own()
        self.mode = "replay"

    def _decide(self, kind, mine, differs=None):
        """Record ``mine`` on the CPU pass; else count where it differs from
        the recorded decision (``differs(recorded)``, by default ``!=``)
        and return the one to apply."""
        if self.mode == "record":
            self.records.append(mine.detach().clone())
            return mine
        recorded = self.records[self.i].to(mine.device)
        self.i += 1
        flipped = mine != recorded if differs is None else differs(recorded)
        self.flips[kind] += int(flipped.sum())
        self.total[kind] += flipped.numel()
        return recorded if self.mode == "replay" else mine

    def relu(self, x):
        mask = self._decide("relu", x.detach() > 0)
        return x * mask if self.mode == "replay" else self.real["relu"](x)

    @staticmethod
    def _taken(x, idx):
        """The elements of each plane of ``x`` a pool's indices name."""
        return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    def _max_differs(self, out, taken):
        """Where the recorded element is not the card's max (an element, not
        an index: a tie's indices may differ); the largest gap between the
        two, over the largest max, goes to ``max_gap``."""
        out, taken = out.detach(), taken.detach()
        gap = ((out - taken).abs().max() / out.abs().max().clamp_min(1e-30)).item()
        self.max_gap = max(self.max_gap, gap)
        return taken != out

    def _pool(self, name, x, k):
        out, idx = self.real[name](x, k, return_indices=True)
        idx = self._decide("max", idx, lambda rec: self._max_differs(out, self._taken(x, rec)))
        return self._taken(x, idx) if self.mode == "replay" else out

    def max_pool2d(self, x, k):
        return self._pool("max_pool2d", x, k)

    def max_pool1d(self, x, k):
        return self._pool("max_pool1d", x, k)

    def amax(self, x, dim):
        out = self.real["amax"](x, dim)
        idx = self._decide("max", x.detach().argmax(dim, keepdim=True), lambda rec: (
            self._max_differs(out, x.gather(dim, rec).squeeze(dim))))
        return x.gather(dim, idx).squeeze(dim) if self.mode == "replay" else out

    def grid_sample(self, x, grid):
        torch = self.torch
        B, C, H, W = x.shape
        gx = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
        gy = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
        cells = self._decide("cell", torch.stack([gx.detach().floor(), gy.detach().floor()]))
        out = self.real["grid_sample_bilinear"](x, grid)
        if self.mode != "replay":
            return out
        x0, y0 = cells
        wx, wy = gx - x0, gy - y0

        def tap(yi, xi):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long().reshape(B, 1, -1)
            vals = x.reshape(B, C, H * W).gather(2, flat.expand(B, C, -1))
            return (vals * valid.reshape(B, 1, -1)).reshape(out.shape)

        wx, wy = wx[:, None], wy[:, None]
        pinned = (tap(y0, x0) * (1 - wx) * (1 - wy) + tap(y0, x0 + 1) * wx * (1 - wy)
                  + tap(y0 + 1, x0) * (1 - wx) * wy + tap(y0 + 1, x0 + 1) * wx * wy)
        own = torch.stack([gx.detach().floor(), gy.detach().floor()])
        flipped = (own != cells).any(0)[:, None]
        return torch.where(flipped, pinned, out)


def last_zoo_phase(torch, card):
    """Phase 18 (the module docstring): each class card against CPU at its
    check batch, a forward and a forward with the backward of a fixed
    weighted sum, the card replaying the CPU's kinks (``PinnedKinks``); no
    port kernel; ms a forward and a forward with its backward at the timed
    batch, and the peak memory of each."""
    from ser_tpu_torch.ops.init import generator
    from ser_tpu_torch.ops.kernels import reset_launches

    for name, (build, x_timed, check_b, dead) in last_zoo_classes(torch).items():
        t0 = time.perf_counter()
        pair = {}
        for dev in ("cpu", "cuda"):
            m = build(generator(0))
            randomize_zoo(torch, m, seed=5)
            pair[dev] = m.to(dev).eval()
        x = x_timed[:check_b]
        xs = {"cpu": x.clone().requires_grad_(), "cuda": x.cuda().requires_grad_()}
        reset_launches()
        with PinnedKinks(torch) as kinks:
            out_cpu = pair["cpu"](xs["cpu"])
            w = torch.randn(out_cpu.shape, generator=torch.Generator().manual_seed(6))
            (out_cpu * w).sum().backward()
            # the card's own kinks, reported; then the CPU's, checked
            kinks.own()
            (pair["cuda"](xs["cuda"].detach().clone().requires_grad_()) * w.cuda()).sum() \
                .backward()
            own_worst = grad_check(torch, pair["cpu"], pair["cuda"])[0]
            for p in pair["cuda"].parameters():
                p.grad = None
            kinks.replay()
            out_card = pair["cuda"](xs["cuda"])
            (out_card * w.cuda()).sum().backward()
        no_port_kernel(torch, f"zoo {name}")
        out, ref = out_card.detach().cpu(), out_cpu.detach()
        worst, dead_cpu, dead_card = grad_check(torch, pair["cpu"], pair["cuda"])
        gx, gx_ref = xs["cuda"].grad.cpu(), xs["cpu"].grad
        gx_worst = ((gx - gx_ref).abs().max() / (GRAD_RTOL * gx_ref.abs().max())).item()
        err = (out - ref).abs().max().item()
        flips = {k: f"{kinks.flips[k]} of {kinks.total[k]}" for k in kinks.flips
                 if kinks.total[k]}
        gap = (f", the largest gap of a flipped max {kinks.max_gap:.2e}"
               if kinks.total["max"] else "")
        print(f"[zoo18] {name} {[check_b, *x.shape[1:]]} -> {list(ref.shape)}: max|card - CPU| "
              f"{err:.3e} (max|out| {ref.abs().max().item():.3e}), gradients {worst:.3f} and "
              f"input gradient {gx_worst:.3f} of the tolerance ({own_worst:.3f} on the card's "
              f"own kinks); kinks flipped {flips or 'none'}{gap}; no port kernel")
        check(torch.isfinite(out).all().item() and out.shape == ref.shape,
              f"zoo {name}: non-finite or misshapen output")
        check(torch.allclose(out, ref, rtol=1e-3, atol=1e-4),
              f"zoo {name}: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
        check(worst <= 1.0 and gx_worst <= 1.0 and dead_cpu == dead_card == dead,
              f"zoo {name}: gradients card and CPU disagree ({worst}, {gx_worst}) or the "
              f"parameters without one differ ({sorted(dead_cpu)}, {sorted(dead_card)})")
        check(kinks.flips["relu"] <= 1e-5 * max(kinks.total["relu"], 1)
              and kinks.max_gap <= 1e-4, f"zoo {name}: the card's forward crossed "
              f"{kinks.flips['relu']} ReLU kinks, or chose a max {kinks.max_gap} below another")
        del pair["cpu"], xs, out_cpu, out_card, out, ref, gx, gx_ref
        m = pair.pop("cuda")
        for p in m.parameters():
            p.grad = None
        xc = x_timed.cuda()
        with torch.no_grad():
            out_shape = m(xc[:1]).shape[1:]
        wc = torch.randn(out_shape, generator=torch.Generator().manual_seed(7)).cuda()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            fwd_ms = cuda_ms(torch, lambda: m(xc), warmup=2, iters=ZOO_ITERS)
        fwd_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        xg = xc.clone().requires_grad_()
        torch.cuda.reset_peak_memory_stats()
        both_ms = cuda_ms(torch, lambda: (m(xg) * wc).sum().backward(), warmup=2,
                          iters=ZOO_ITERS)
        both_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        no_port_kernel(torch, f"zoo {name} timed")
        print(f"[time] {card} | zoo {name} {list(x_timed.shape)}: forward {fwd_ms:.4f} ms "
              f"(peak {fwd_gib:.3f} GiB), forward and backward {both_ms:.4f} ms (peak "
              f"{both_gib:.3f} GiB), median of {ZOO_ITERS}; {time.perf_counter() - t0:.1f} s")
        del m, xc, xg, wc
        torch.cuda.empty_cache()


# phase 19: the bench CLIs in this process. ``bench``'s line has the JAX
# script's keys; its times are the port's own (bench.time_calls), whose calls
# are counted here and the kernels' launches held against them
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "noisy", "detail"]
BENCH_DETAIL_KEYS = [
    "seconds_per_pass", "n_utterances", "eval_efficiency", "train_utterances_per_sec",
    "train_seconds_per_step", "train_efficiency", "train_shape",
    "mfcc_frontend_utterances_per_sec", "mfcc_frontend_wav_seconds_per_utt",
    "flagship_vs_zoo_baseline", "backend", "device"]
EFFICIENCY_KEYS = ["flops_per_pass", "tflops_effective", "pct_f32_peak"]
BENCH_TRAIN_T = 110  # synthetic_like_train's padded length: 2T rank-1 launches a step


def run_main(module, argv):
    """``module.main()`` with ``sys.argv`` set to ``argv``, its standard
    output caught: (its exit code, or a ``SystemExit``'s message, and that
    output)."""
    import contextlib
    import io

    saved, buf = sys.argv, io.StringIO()
    sys.argv = [module.__name__] + list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            code = module.main()
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = saved
    return code, buf.getvalue()


def bench_phase(torch, card):
    """Phase 19 (the module docstring). Returns the launches of every kernel
    by path, each counted from 0 just before its run."""
    from ser_tpu_torch import bench, bench_zoo
    from ser_tpu_torch.data.synthetic import synthetic_like_train
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels.lsthm import NAME
    from ser_tpu_torch.ops.kernels.mfcc import NAME as MFCC
    from ser_tpu_torch.ops.kernels.rank1 import NAME as RANK1, NAME_BF16 as RANK1_BF16
    from ser_tpu_torch.train.trainer import ModelTrainer

    launches = {NAME: {}, MFCC: {}, RANK1: {}, RANK1_BF16: {}}
    timed = []  # (the timed function's name, its calls) of every bench.time_calls
    time_calls = bench.time_calls

    def counted(fn, *args, **kwargs):
        t = time_calls(fn, *args, **kwargs)
        timed.append((fn.__name__, t.calls))
        return t

    def run(module, argv):
        timed.clear()
        reset_launches()
        code, out = run_main(module, argv)
        torch.cuda.synchronize()
        return code, out, dict(LAUNCHES), list(timed)

    def positive(x):
        return isinstance(x, (int, float)) and math.isfinite(x) and x > 0

    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_bench_")
    tmp = Path(tmp_dir.name)
    bench.time_calls = counted
    try:
        # (a) python -m ser_tpu_torch.bench, in full
        t0 = time.perf_counter()
        code, out, got, calls = run(bench, [])
        line = json.loads(out.strip().splitlines()[-1])
        detail = line.get("detail", {})
        n = {name: sum(c for f, c in calls if f == name)
             for name in ("eval_pass", "train_step", "frontend_pass")}
        print(f"[bench] {card} | python -m ser_tpu_torch.bench: {json.dumps(line)}")
        print(f"[bench] calls timed {calls}; launches {got}; "
              f"{time.perf_counter() - t0:.1f} s")
        check(code == 0 and list(line) == BENCH_KEYS and list(detail) == BENCH_DETAIL_KEYS,
              f"bench: exit {code}, keys {list(line)}, detail {list(detail)}")
        numbers = [line["value"], line["vs_baseline"], *(detail[k] for k in (
            "seconds_per_pass", "n_utterances", "train_utterances_per_sec",
            "train_seconds_per_step", "mfcc_frontend_utterances_per_sec",
            "mfcc_frontend_wav_seconds_per_utt"))]
        if detail["flagship_vs_zoo_baseline"] is not None:
            numbers.append(detail["flagship_vs_zoo_baseline"])
        for k in ("eval_efficiency", "train_efficiency"):
            check(list(detail[k]) == EFFICIENCY_KEYS, f"bench {k}: {detail[k]}")
            numbers += list(detail[k].values())
        check(all(positive(x) for x in numbers) and detail["backend"] == "cuda"
              and detail["device"] == card and detail["train_shape"] == [BENCH_TRAIN_T, 80]
              and detail["n_utterances"] == 1606,
              f"bench: a value not finite and positive, or the wrong backend, card or "
              f"shape: {line}")
        want = {NAME: n["eval_pass"], RANK1: 2 * BENCH_TRAIN_T * n["train_step"],
                MFCC: n["frontend_pass"]}
        check({k: v for k, v in got.items() if v} == want,
              f"bench launched {got}, want {want} from the calls timed {calls}")
        launches[NAME]["bench, eval passes [82, 31]"] = got[NAME]
        launches[RANK1]["bench, train steps [110, 80]"] = got[RANK1]
        launches[MFCC]["bench, front-end passes [1606, 4000]"] = got[MFCC]

        # the host-to-device copy inside a train step (the step's batch is numpy)
        batch = synthetic_like_train(seed=1)
        trainer = ModelTrainer(model="MARN1_onlysp")

        def copy_in():
            trainer.predictor.batch_inputs(batch)
            torch.as_tensor(batch["label"], device=trainer.device)
            torch.cuda.synchronize()

        copy_ms = []
        for _ in range(12):
            t1 = time.perf_counter()
            copy_in()
            copy_ms.append((time.perf_counter() - t1) * 1e3)
        copy_ms = statistics.median(copy_ms[2:])
        print(f"[time] {card} | the train step's host-to-device copy [110, 80] (x, qmask, "
              f"umask, labels; median of 10): {copy_ms:.4f} ms, of bench's step "
              f"{detail['train_seconds_per_step'] * 1e3:.2f} ms")
        del trainer

        # (b) bench_zoo eval: onlysp and DialogueRNN, saved; (c) checked
        t0 = time.perf_counter()
        saved = tmp / "zoo.json"
        code, out, got, calls = run(bench_zoo, [
            "--models", "MARN1_onlysp", "DialogueRNN", "--iters", "2", "--save", str(saved)])
        doc = json.loads(saved.read_text()) if saved.exists() else {}
        print(f"[bench] {card} | bench_zoo eval: {out.strip().splitlines()[:2]}; calls timed "
              f"{calls}; launches {got}; {time.perf_counter() - t0:.1f} s")
        check(code == 0 and [f for f, _ in calls] == ["eval_pass"] * 2,
              f"bench_zoo eval: exit {code}, calls {calls}")
        check(list(doc) == ["backend", "device", "n_utterances", "dtype", "models"]
              and doc["backend"] == "cuda" and doc["device"] == card
              and doc["dtype"] == "f32" and list(doc["models"]) == ["MARN1_onlysp",
                                                                    "DialogueRNN"]
              and all(list(r) == ["ms_per_pass", "utterances_per_sec", "compile_s",
                                  *EFFICIENCY_KEYS] and all(positive(v) for v in r.values())
                      for r in doc["models"].values()), f"bench_zoo --save: {doc}")
        check({k: v for k, v in got.items() if v} == {NAME: calls[0][1]},
              f"bench_zoo eval launched {got}, want {calls[0][1]} of {NAME} "
              "(onlysp's passes; DialogueRNN runs no port kernel)")
        what = "bench_zoo, MARN1_onlysp eval passes"
        launches[NAME][what] = got[NAME]
        code, out, got, calls = run(bench_zoo, [
            "--models", "MARN1_onlysp", "--iters", "2", "--check", str(saved),
            "--check_threshold", "0.25"])
        ratio = [x for x in out.splitlines() if x.startswith("MARN1_onlysp: ")]
        print(f"[bench] bench_zoo --check of that file: exit {code}, {ratio}; launches {got}")
        check(code == 0 and len(ratio) == 1 and got[NAME] == calls[0][1],
              f"bench_zoo --check round trip: exit {code}, {out}")
        launches[NAME][what] += got[NAME]

        # (d) bench_zoo --train, f32 and bf16
        for dtype, kernel in (("f32", RANK1), ("bf16", RANK1_BF16)):
            t0 = time.perf_counter()
            code, out, got, calls = run(bench_zoo, [
                "--train", "--models", "MARN1_onlysp", "--iters", "2", "--dtype", dtype])
            res = json.loads(out.strip().splitlines()[0])["MARN1_onlysp"]
            print(f"[bench] {card} | bench_zoo --train --dtype {dtype}: {json.dumps(res)}; "
                  f"calls timed {calls}; launches {got}; {time.perf_counter() - t0:.1f} s")
            want = {kernel: 2 * BENCH_TRAIN_T * calls[0][1]}
            check(code == 0 and list(res) == ["ms_per_step", "utterances_per_sec",
                                              "compile_s", *EFFICIENCY_KEYS]
                  and all(positive(v) for v in res.values()),
                  f"bench_zoo --train --dtype {dtype}: exit {code}, {res}")
            check({k: v for k, v in got.items() if v} == want,
                  f"bench_zoo --train --dtype {dtype} launched {got}, want {want}")
            launches[kernel][f"bench_zoo --train --dtype {dtype}, MARN1_onlysp steps"] = \
                got[kernel]

        # (e) a TPU baseline is refused before anything runs
        code, out, got, calls = run(bench_zoo, [
            "--models", "MARN1_onlysp", "--check", str(ROOT / "baselines" / "zoo_r04.json")])
        print(f"[bench] bench_zoo --check baselines/zoo_r04.json: {code}")
        check(isinstance(code, str) and "'tpu'" in code and not calls and not any(
            got.values()), f"bench_zoo took a TPU baseline: {code}, {out}")
    finally:
        bench.time_calls = time_calls
        tmp_dir.cleanup()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "ser_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no ser_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from ser_tpu_torch.compat.from_jax import to_jax_params
    from ser_tpu_torch.data.frontend import MFCCFrontend
    from ser_tpu_torch.data.loaders import get_loaders
    from ser_tpu_torch import predict as predict_cli
    from ser_tpu_torch.data.synthetic import (generate_iemocap_pickles,
                                              generate_meld_pickles,
                                              iemocap_eval_batch,
                                              synthetic_batch)
    from ser_tpu_torch.device import disable_tf32
    from ser_tpu_torch.models import marn_onlysp
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels import mfcc as mfcc_kernel
    from ser_tpu_torch.ops.kernels import rank1 as rank1_kernel
    from ser_tpu_torch.ops.kernels.build import build
    from ser_tpu_torch.ops.kernels.lsthm import (
        CLUSTER, NAME, PARTIES, TILE_ROWS, choose_tiling, launch_exchange_rounds,
        lsthm_onlysp_recurrence_bidir, lsthm_onlysp_recurrence_bidir_ref,
        occupancy)
    from ser_tpu_torch.ops.layers import Dropout
    from ser_tpu_torch.ops.mfcc import MFCCConfig, mfcc, mfcc_ref
    from ser_tpu_torch.serving import Predictor
    from ser_tpu_torch.train import __main__ as train_cli
    from ser_tpu_torch.train.metrics import weighted_accuracy
    from ser_tpu_torch.train.trainer import ModelTrainer

    MFCC, RANK1 = mfcc_kernel.NAME, rank1_kernel.NAME

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    disable_tf32()
    dev = torch.device("cuda:0")

    # 2. build
    t0 = time.perf_counter()
    logs = build([NAME, MFCC, RANK1])
    print(f"[build] {NAME}.cu, {MFCC}.cu, {RANK1}.cu in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in (NAME, MFCC, RANK1):
        for line in ptxas_summary(logs.get(name, "")):
            print(f"[build]   {name}: {line}")
    rec_lines = ptxas_summary(logs[NAME])
    spilled = [line for line in rec_lines if "spill stores 0 B, loads 0 B" not in line]
    check(len(rec_lines) == 2 * len(PARTIES) * len(TILE_ROWS) and not spilled,
          f"{NAME}: {len(rec_lines)} instantiations read, spills in {spilled}")
    cfg = MFCCFrontend().cfg  # the path's 64 mels, 50 coefficients
    mfcc_smem, mfcc_blocks = mfcc_kernel.occupancy(cfg)
    print(f"[build]   {MFCC}: tiles of {mfcc_kernel.TILE_FRAMES} frames, "
          f"{mfcc_smem} B of dynamic shared memory a block, {mfcc_blocks} blocks "
          f"an SM on {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    check(mfcc_blocks >= 1, f"an SM holds no block of the {MFCC} kernel")
    max_clusters = occupancy()[1]
    print(f"[build]   {NAME}: clusters of {CLUSTER} CTAs; dynamic shared memory a CTA "
          "and resident clusters by (parties, rows a cluster): " + ", ".join(
              f"({P}, {rows}): {occupancy(rows, P)[0]} B, {occupancy(rows, P)[1]}"
              for P in PARTIES for rows in TILE_ROWS))
    check(min(occupancy(rows, P)[1] for P in PARTIES for rows in TILE_ROWS) >= 1,
          f"the card holds no cluster of {CLUSTER} CTAs of some instantiation")
    r1_occ = rank1_kernel.occupancy()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for part in ("fwd", "bwd"):
        cap, warps = r1_occ[f"{part}_blocks"], r1_occ[f"{part}_threads"] // 32
        grid = 2 * TRAIN_B * r1_occ[f"{part}_split"]
        busy = min(cap, -(-grid // n_sm))  # the grid's blocks an SM, at most
        print(f"[build]   {RANK1} {part}: blocks of {r1_occ[f'{part}_threads']} "
              f"threads ({warps} warps), {r1_occ[f'{part}_split']} a (row, "
              f"direction), {cap} blocks an SM ({cap * warps} warps) at most"
              + (f", {r1_occ['bwd_smem']} B of dynamic shared memory a block"
                 if part == "bwd" else "")
              + f"; at B = {TRAIN_B} the grid's {grid} blocks on {n_sm} SMs give "
              f"{grid // n_sm * warps}-{busy * warps} resident warps an SM")
        check(grid // n_sm * warps >= 16, f"{RANK1} {part}: fewer than 16 warps "
              f"resident an SM at B = {TRAIN_B}")

    # 3. recurrence kernel against its plain version, atol 1e-4 (110 serial
    #    steps sum in another order than the plain version's matmuls): B on
    #    both sides of every tile height, one step, a fully padded row; every
    #    launch synchronised, so a fault in a cluster write shows here
    def hold(seqs, consts, what):
        """The kernel twice and its plain version on one input: finite,
        within atol 1e-4, bit-equal twice; returns max |kernel - plain|."""
        B, P = seqs[3].shape[2:]
        rows, tiles = choose_tiling(B, occupancy(parties=P)[1])
        got = lsthm_onlysp_recurrence_bidir(seqs, consts)
        torch.cuda.synchronize()
        again = lsthm_onlysp_recurrence_bidir(seqs, consts)
        torch.cuda.synchronize()
        want = lsthm_onlysp_recurrence_bidir_ref(seqs, consts)
        err = (got - want).abs().max().item()
        print(f"[kernel] {what}: {rows} rows a cluster, {2 * tiles} clusters, "
              f"max|kernel-plain| = {err:.3e}, two runs bit-equal: "
              f"{torch.equal(got, again)}")
        check(torch.isfinite(got).all().item(), f"non-finite kernel output, {what}")
        check(err <= 1e-4, f"kernel disagrees with plain version, {what}")
        check(torch.equal(got, again), f"two runs of one input differ, {what}")
        return err

    max_err = 0.0
    for T_k, B, padded_row in ((110, 1, None), (110, 8, None), (110, 9, None),
                               (110, 12, None), (110, 13, None), (110, 31, None),
                               (110, 33, None), (110, 37, None), (110, 80, None),
                               (1, 31, None), (110, 31, 5)):
        seqs, consts = recurrence_inputs(np, torch, T_k, B, seed=B, dev=dev,
                                         padded_row=padded_row)
        max_err = max(max_err, hold(seqs, consts, f"B={B:3d} T={T_k}" + (
            "" if padded_row is None else f" row {padded_row} padded")))

    # 3b. MFCC kernel against its plain version, |err| <= MFCC_ATOL +
    #     MFCC_RTOL*|plain|; every shape twice for bit-equal outputs; all-zero
    #     rows must equal the plain version's bit for bit (they reach the
    #     logits as padding)
    eval_batch, n_utts = iemocap_eval_batch(seed=0)
    wav_batch = wav_request(np, eval_batch, seed=5)
    L, B = eval_batch["qmask"].shape[:2]
    wav_rows = torch.from_numpy(wav_batch["wav"].reshape(L * B, -1)).to(dev)
    rng = np.random.default_rng(3)
    noise = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    bench_wav = noise(n_utts, WAV_T)
    tone = torch.sin(2 * math.pi * 440 / 16000 * torch.arange(
        WAV_BUCKET_T, device=dev, dtype=torch.float64)).float()
    hop200 = MFCCConfig(hop=200, n_mels=cfg.n_mels, n_mfcc=cfg.n_mfcc)
    mfcc_err = 0.0
    for name, x, c in (
            ("iemocap_eval_wav", wav_rows, cfg),
            ("bench_1606x4000", bench_wav, cfg),
            ("one_second", noise(4, 16000), cfg),
            ("unaligned_rows", noise(5, 4001), cfg),
            ("one_frame", noise(1, 400), cfg),
            ("hop_200", noise(37, WAV_BUCKET_T), hop200),
            ("tone_440hz", torch.stack([tone, 1e-3 * tone]), cfg),
            ("all_zero_rows", torch.zeros(64, WAV_BUCKET_T, device=dev), cfg)):
        got = mfcc(x, c)
        torch.cuda.synchronize()
        again = mfcc(x, c)
        torch.cuda.synchronize()
        want = mfcc_ref(x, c)
        err = (got - want).abs()
        worst = (err / (MFCC_ATOL + MFCC_RTOL * want.abs())).max().item()
        mfcc_err = max(mfcc_err, err.max().item())
        print(f"[kernel] {MFCC} {name} {tuple(x.shape)} -> {tuple(got.shape)}: "
              f"max|kernel-plain| = {err.max().item():.3e}, "
              f"{worst:.3f} of the tolerance, two runs bit-equal: "
              f"{torch.equal(got, again)}")
        check(torch.isfinite(got).all().item(), f"non-finite MFCC output, {name}")
        check(got.shape == (x.shape[0], c.n_frames(x.shape[1]), c.n_mfcc),
              f"MFCC output shape, {name}")
        check(worst <= 1.0, f"MFCC kernel disagrees with plain version, {name}")
        check(torch.equal(got, again), f"two MFCC runs of one input differ, {name}")
        if name == "all_zero_rows":
            check(torch.equal(got, want),
                  "all-zero rows differ from the plain version's padded features")

    # 3c. the recurrence kernel at P = 9: random inputs, a fully padded row
    #     and an all-zero qmask mid-sequence; then the MELD request shapes,
    #     the test split collated at batch 80, through a 7-class model
    p9_err = 0.0
    for T_k, B, padded_row in ((32, 1, None), (32, 16, None), (32, 80, None),
                               (110, 31, None), (32, 16, 5)):
        seqs, consts = recurrence_inputs(np, torch, T_k, B, seed=B, dev=dev,
                                         padded_row=padded_row, P=9)
        what = f"P=9 B={B:3d} T={T_k}"
        if padded_row is not None:
            seqs[3][5:9, :, 9] = 0.0
            what += f" row {padded_row} padded, row 9 all-zero at steps 5-8"
        p9_err = max(p9_err, hold(seqs, consts, what))
    meld_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_meld_")
    meld_path = generate_meld_pickles(meld_tmp.name, n_train=MELD_TRAIN,
                                      n_test=MELD_TEST, seed=PREDICT_SEED)
    meld_loaders = lambda n_classes: get_loaders(
        meld_path, dataset="MELD", valid=0.2, batch_size=TRAIN_B,
        n_classes=n_classes, seed=PREDICT_SEED)
    meld_test = meld_loaders(7)[2]
    gpu9 = Predictor(seed=0, device="cuda", n_classes=7)
    meld_shapes = []
    with torch.inference_mode():
        for i, batch in enumerate(meld_test):
            seqs9, consts9 = gpu9.model.recurrence_inputs(*gpu9.batch_inputs(batch))[:2]
            meld_shapes.append(tuple(seqs9[3].shape))
            p9_err = max(p9_err, hold(seqs9, consts9, f"MELD request {i} "
                                      f"{list(batch['qmask'].shape)}"))
        seqs9, consts9 = gpu9.model.recurrence_inputs(
            *gpu9.batch_inputs(next(iter(meld_test))))[:2]
    check(len(meld_shapes) == -(-MELD_TEST // TRAIN_B)
          and all(s[1:] == (2, TRAIN_B, 9) for s in meld_shapes),
          f"MELD request shapes {meld_shapes}")
    max_err = max(max_err, p9_err)

    # 4. the feature path: three requests through the Predictor
    spec = get_model_spec("MARN1_onlysp")
    n0 = int(eval_batch["umask"][0].sum())  # dialogue 0 alone, unpadded
    one = {k: (v[:1, :n0] if k in ("umask", "label") else v[:n0, :1])
           for k, v in eval_batch.items() if k != "vid"}
    train_batch = synthetic_batch(L=110, B=80, seed=1, min_len=20)
    requests = [("iemocap_eval", eval_batch), ("one_dialogue", one),
                ("train_shape", train_batch)]

    gpu = Predictor(seed=0, device="cuda")
    weights = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    cpu = Predictor(state_dict=weights, device="cpu")
    reset_launches()
    per_request = []
    for name, batch in requests:
        x, qmask, umask = spec.make_inputs(batch)
        before = LAUNCHES[NAME]
        logp, labels = gpu.predict(x, qmask, umask)
        torch.cuda.synchronize()
        per_request.append((name, x, qmask, umask, logp.cpu(),
                            LAUNCHES[NAME] - before))
    main_launches = LAUNCHES[NAME]
    check(main_launches > 0, f"{NAME} was never launched on the main path")
    for name, x, qmask, umask, logp, launches in per_request:
        L_, B_ = x.shape[:2]
        ref = cpu.predict(x, qmask, umask)[0]
        err = (logp - ref).abs().max().item()
        ok = torch.allclose(logp, ref, rtol=1e-3, atol=1e-4)
        print(f"[predict] {name}: L={L_} B={B_} logp {tuple(logp.shape)} "
              f"launches={launches} max|gpu-cpu|={err:.3e}")
        check(torch.isfinite(logp).all().item(), f"non-finite logp for {name}")
        check(tuple(logp.shape) == (B_ * L_, 6), f"logp shape for {name}")
        check(launches == 1, f"{name} launched {NAME} {launches} times")
        check(ok, f"{name}: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
    check(gpu.n_requests == 3, "the predictor did not count three requests")

    # 4b. the raw-audio path: one collated wav request, front end on the card
    gpu_wav = Predictor(state_dict=weights, device="cuda", audio_frontend="mfcc")
    cpu_wav = Predictor(state_dict=weights, device="cpu", audio_frontend="mfcc")
    reset_launches()
    logp, _ = gpu_wav.predict_batch(wav_batch)
    torch.cuda.synchronize()
    wav_launches = dict(LAUNCHES)
    logp = logp.cpu()
    ref = cpu_wav.predict_batch(wav_batch)[0]
    err = (logp - ref).abs().max().item()
    print(f"[predict] iemocap_eval_wav: L={L} B={B} T={WAV_BUCKET_T} "
          f"logp {tuple(logp.shape)} launches={wav_launches} "
          f"max|gpu-cpu|={err:.3e}")
    check(torch.isfinite(logp).all().item(), "non-finite logp for the wav request")
    check(wav_launches.get(MFCC, 0) == 1 and wav_launches.get(NAME, 0) == 1,
          f"the wav request launched {wav_launches}, want {MFCC} and {NAME} once")
    check(torch.allclose(logp, ref, rtol=1e-3, atol=1e-4),
          "wav request: card and CPU disagree beyond rtol 1e-3, atol 1e-4")

    # 4c. the entry point on the card and on the CPU, the same pickles
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "marn1_onlysp_seed0.npz"
        np.savez(ckpt, **to_jax_params(weights))
        feature_path = generate_iemocap_pickles(
            str(tmp / "pickles"), seed=PREDICT_SEED, with_wav=True)
        cli = [sys.executable, "-m", "ser_tpu_torch.predict",
               "--audio_frontend", "mfcc", "--initial_model", str(ckpt)]
        runs = {
            "cuda": cli + ["--synthetic", "--res_csv", str(tmp / "cuda.csv")],
            "cpu": cli + ["--feature_path", feature_path, "--device", "cpu",
                          "--res_csv", str(tmp / "cpu.csv")],
        }
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for k, c in runs.items()}
        outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
        print(f"[cli] both runs in {time.perf_counter() - t0:.1f} s")
        reports = {}
        for k, (out, errs) in outs.items():
            check(procs[k].returncode == 0,
                  f"predict CLI ({k}) exited {procs[k].returncode}:\n{errs[-3000:]}")
            check("is not in the model" not in out and "Wrong parameter" not in out,
                  f"predict CLI ({k}) skipped checkpoint names:\n{out[:2000]}")
            reports[k] = json.loads(out[out.index("{"):])
        preds, labels, masks = read_res_csv(tmp / "cuda.csv")
        cpu_preds, cpu_labels, cpu_masks = read_res_csv(tmp / "cpu.csv")
        cli_res = (tmp / "cuda.csv").read_text()  # phase 16 (e) reads it
    rep = cli_report = reports["cuda"]
    print(f"[cli] cuda: {json.dumps(rep)}")
    print(f"[cli] cpu:  {json.dumps(reports['cpu'])}")
    valid = [i for i, m in enumerate(masks) if m > 0]
    flips = sum(preds[i] != cpu_preds[i] for i in valid)
    print(f"[cli] predictions differ on {flips} of {len(valid)} valid utterances")
    check(labels == cpu_labels and masks == cpu_masks,
          "the card and CPU runs read different pickles")
    check(rep["n_examples"] == 31 and len(valid) > 0, "predict CLI test split")
    check(all(math.isfinite(rep[k]) for k in ("weighted_accuracy", "weighted_f1")),
          "non-finite CLI metrics")
    check(rep["weighted_accuracy"] == weighted_accuracy(labels, preds, masks),
          "CLI accuracy does not match its res.csv")
    check(flips <= 0.001 * len(valid), "card and CPU predictions differ on "
          "more than 0.1% of the valid utterances")

    # 4d. the MELD entry point in this process, card against CPU, at 7 and
    #     3 classes on seeded checkpoints; the kernel's launches counted
    meld_launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_meld_cli_") as tmp:
        tmp = Path(tmp)
        for n_classes in (7, 3):
            ckpt = tmp / f"meld{n_classes}.npz"
            np.savez(ckpt, **to_jax_params(Predictor(
                seed=0, device="cpu", n_classes=n_classes).model.state_dict()))
            argv = ["--dataset", "MELD", "--n_classes", str(n_classes),
                    "--feature_path", meld_path, "--initial_model", str(ckpt)]
            reports = {}
            for d in ("cuda", "cpu"):
                reset_launches()
                t0 = time.perf_counter()
                out = run_quiet(predict_cli.main, argv + [
                    "--device", d, "--res_csv", str(tmp / f"{d}.csv")])
                if d == "cuda":
                    torch.cuda.synchronize()
                    meld_launches[n_classes] = LAUNCHES[NAME]
                check("is not in the model" not in out and "Wrong parameter" not in out,
                      f"MELD predict CLI ({d}) skipped checkpoint names:\n{out[:2000]}")
                reports[d] = json.loads(out[out.index("{"):])
                print(f"[cli] MELD, {n_classes} classes, {d}: "
                      f"{time.perf_counter() - t0:.1f} s, {json.dumps(reports[d])}")
            preds, labels, masks = read_res_csv(tmp / "cuda.csv")
            cpu_preds, cpu_labels, cpu_masks = read_res_csv(tmp / "cpu.csv")
            valid = [i for i, m in enumerate(masks) if m > 0]
            flips = sum(preds[i] != cpu_preds[i] for i in valid)
            print(f"[cli] MELD, {n_classes} classes: predictions differ on {flips} of "
                  f"{len(valid)} valid utterances; {NAME} launches on the card "
                  f"{meld_launches[n_classes]}")
            check(labels == cpu_labels and masks == cpu_masks,
                  "the MELD card and CPU runs read different pickles")
            check(reports["cuda"]["n_examples"] == MELD_TEST and len(valid) > 0,
                  "MELD predict CLI test split")
            check(max(labels) < n_classes and max(preds) < n_classes, "MELD labels")
            check(flips <= 0.001 * len(valid), "MELD: card and CPU predictions differ on "
                  "more than 0.1% of the valid utterances")
            check(meld_launches[n_classes] == len(meld_test),
                  f"MELD predict CLI launched {NAME} {meld_launches[n_classes]} times, "
                  f"want one a batch ({len(meld_test)})")

    # 5. timings
    x, qmask, umask = spec.make_inputs(eval_batch)
    xt, qt, ut = (torch.as_tensor(a, device=dev) for a in (x, qmask, umask))
    with torch.inference_mode():
        seqs, consts = gpu.model.recurrence_inputs(xt, qt, ut)[:2]
        out = lsthm_onlysp_recurrence_bidir(seqs, consts)
        err = (out - lsthm_onlysp_recurrence_bidir_ref(seqs, consts)).abs().max().item()
        max_err = max(max_err, err)
        check(err <= 1e-4, "kernel disagrees with plain version at the eval shape")
        kernel_ms = cuda_ms(torch, lambda: lsthm_onlysp_recurrence_bidir(seqs, consts))
        plain_ms = cuda_ms(torch, lambda: lsthm_onlysp_recurrence_bidir_ref(seqs, consts),
                           warmup=1, iters=5)
    predict_ms = cuda_ms(torch, lambda: gpu.predict(x, qmask, umask))
    for B_sweep in (1, 8, 31, 80):  # how the per-step time depends on B
        s_in, c_in = recurrence_inputs(np, torch, 82, B_sweep, seed=7, dev=dev)
        rows, tiles = choose_tiling(B_sweep, max_clusters)
        ms = cuda_ms(torch, lambda: lsthm_onlysp_recurrence_bidir(s_in, c_in))
        print(f"[time] {card} | kernel T=82 B={B_sweep}: {ms:.4f} ms "
              f"({ms / 82 * 1e3:.2f} us/step), {rows} rows a cluster, "
              f"{2 * tiles} clusters of {max_clusters} resident")
    bound_ms, bound_by = recurrence_bound(seqs, consts, out)
    T, _, B_rec = seqs[0].shape[:3]
    # the chain floor, measured: what T steps' cluster exchanges cost with no
    # work between them, on the grid this shape runs on (20 calls' worth a
    # launch); the party select and scatter on the chain are printed apart,
    # estimated from PARTY_CHAIN_INSTR
    rows, tiles = choose_tiling(B_rec, max_clusters)
    floor_ms = cuda_ms(torch, lambda: launch_exchange_rounds(
        20 * T, rows, tiles), warmup=1, iters=5) / 20
    party_ms = lambda T_, P: T_ * PARTY_CHAIN_INSTR * P / SM_CLOCK * 1e3
    print(f"[time] {card} | recurrence T={T} B={B_rec}: kernel {kernel_ms:.4f} ms "
          f"({kernel_ms / T * 1e3:.2f} us/step), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), chain floor {floor_ms:.4f} ms measured "
          f"(T x {floor_ms / T * 1e3:.2f} us of cluster exchanges); party select and "
          f"scatter on the chain {party_ms(T, 2):.4f} ms estimated ({PARTY_CHAIN_INSTR} "
          f"instructions a party a step at {SM_CLOCK / 1e9:g} GHz, not measured)")
    # the P = 9 kernel at the MELD request shape, in turns with P = 2
    T9, _, B9 = seqs9[0].shape[:3]
    with torch.inference_mode():
        turns = []  # (P, ms a wrapper call, ms of device time from a CUDA graph)
        for P_, (s_, c_) in ((2, (seqs, consts)), (9, (seqs9, consts9)),
                             (9, (seqs9, consts9)), (2, (seqs, consts))):
            run = lambda: lsthm_onlysp_recurrence_bidir(s_, c_)
            turns.append((P_, cuda_ms(torch, run), cuda_graph_ms(torch, run)))
        plain9_ms = cuda_ms(torch, lambda: lsthm_onlysp_recurrence_bidir_ref(seqs9, consts9),
                            warmup=1, iters=5)
        out9 = lsthm_onlysp_recurrence_bidir(seqs9, consts9)
    kernel9_ms = statistics.median(ms for P_, ms, _ in turns if P_ == 9)
    kernel9_dev = statistics.median(dev_ms for P_, _, dev_ms in turns if P_ == 9)
    bound9_ms, bound9_by = recurrence_bound(seqs9, consts9, out9)
    rows9, tiles9 = choose_tiling(B9, occupancy(parties=9)[1])
    floor9_ms = cuda_ms(torch, lambda: launch_exchange_rounds(
        20 * T9, rows9, tiles9, parties=9), warmup=1, iters=5) / 20
    print(f"[time] {card} | recurrence in turns P=2 [{T}, {B_rec}], P=9 [{T9}, {B9}] "
          "twice, P=2, ms a wrapper call and of device time: " + ", ".join(
              f"P={P_} {ms:.4f} and {dev_ms:.4f}" for P_, ms, dev_ms in turns))
    print(f"[time] {card} | recurrence P=9 MELD request T={T9} B={B9}: kernel "
          f"{kernel9_ms:.4f} ms a wrapper call, {kernel9_dev:.4f} of device time "
          f"({kernel9_dev / T9 * 1e3:.2f} us/step), 1 launch a request, "
          f"plain {plain9_ms:.4f} ms, bound {bound9_ms:.4f} ms ({bound9_by}), chain floor "
          f"{floor9_ms:.4f} ms measured (the exchanges, {rows9} rows a cluster, "
          f"{2 * tiles9} clusters); party select and scatter on the chain "
          f"{party_ms(T9, 9):.4f} ms estimated ({PARTY_CHAIN_INSTR} instructions a party "
          f"a step at {SM_CLOCK / 1e9:g} GHz, not measured)")
    del seqs9, consts9, out9, gpu9  # freed before phase 8 reads peak memory
    print(f"[time] {card} | predict {n_utts} utterances: {predict_ms:.4f} ms, "
          f"{n_utts / predict_ms * 1e3:.1f} utterances/s")

    # the MFCC kernel a wrapper call (host work before the launch included)
    # and as device time from a CUDA graph, on one input (which the 50 MB L2
    # holds in part from launch to launch) and on three inputs taken in turn
    # (125 MB: every launch finds its waveform in device memory, as a request
    # does); the bytes floor both ways
    mfcc_out = mfcc(wav_rows, cfg)
    turn = [wav_rows, wav_rows.flip(0).contiguous(), wav_rows.roll(1, 0).contiguous()]

    def in_turn(fn):
        calls = iter(range(10 ** 6))
        return lambda: fn(turn[next(calls) % 3], cfg)

    mfcc_ms = cuda_ms(torch, lambda: mfcc(wav_rows, cfg))
    mfcc_turn_ms = cuda_ms(torch, in_turn(mfcc), iters=21)
    mfcc_dev_ms = cuda_graph_ms(torch, lambda: mfcc(wav_rows, cfg))
    mfcc_dev_turn_ms = cuda_graph_ms(torch, in_turn(mfcc))
    floor = mfcc_kernel.launch_bytes_floor
    mfcc_floor_ms = cuda_graph_ms(torch, lambda: floor(wav_rows, cfg))
    mfcc_floor_turn_ms = cuda_graph_ms(torch, in_turn(floor))
    mfcc_plain_ms = cuda_ms(torch, lambda: mfcc_ref(wav_rows, cfg))
    mfcc_bound_ms, mfcc_bound_by, own_ms = mfcc_bound(
        wav_rows, cfg.tensors(dev), mfcc_out, cfg)
    print(f"[time] {card} | {MFCC} {tuple(wav_rows.shape)}: kernel {mfcc_ms:.4f} ms "
          f"a wrapper call, {mfcc_dev_ms:.4f} of device time; three inputs in turn "
          f"{mfcc_turn_ms:.4f} and {mfcc_dev_turn_ms:.4f}; bytes floor "
          f"{mfcc_floor_ms:.4f}, three inputs in turn {mfcc_floor_turn_ms:.4f}; "
          f"plain {mfcc_plain_ms:.4f} ms; bound {mfcc_bound_ms:.4f} ms "
          f"({mfcc_bound_by}), {100 * mfcc_bound_ms / mfcc_ms:.1f}% of the bound "
          f"a wrapper call, {100 * mfcc_bound_ms / mfcc_dev_turn_ms:.1f}% in device "
          f"time in turn; the kernel's own algorithm's operations {own_ms:.4f} ms")
    bench_kernel_ms = cuda_graph_ms(torch, lambda: mfcc(bench_wav, cfg))
    frontend_ms = cuda_ms(torch, lambda: gpu_wav.frontend(bench_wav))
    print(f"[time] {card} | front end {tuple(bench_wav.shape)}: kernel "
          f"{bench_kernel_ms:.4f} ms of device time, with pooling {frontend_ms:.4f} ms, "
          f"{n_utts / frontend_ms * 1e3:.1f} utterances/s")
    wav_predict_ms = cuda_ms(torch, lambda: gpu_wav.predict_batch(wav_batch),
                             warmup=2, iters=10)
    print(f"[time] {card} | wav request {n_utts} utterances [{L}, {B}, "
          f"{WAV_BUCKET_T}]: {wav_predict_ms:.4f} ms, "
          f"{n_utts / wav_predict_ms * 1e3:.1f} utterances/s")

    # 6. where the time of a request goes: device time by kernel and copy,
    #    and the device's busy share of the wall time
    for label, fn, n in (("feature request", lambda: gpu.predict(x, qmask, umask), 5),
                         ("wav request", lambda: gpu_wav.predict_batch(wav_batch), 3)):
        wall_ms, busy_ms, events = device_profile(torch, fn, n)
        print(f"[profile] {card} | {label}, {n} requests: wall {wall_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)")
        split = {"HtoD copy": 0.0, MFCC: 0.0, NAME: 0.0, "rest": 0.0}
        for e in events:
            key = ("HtoD copy" if "HtoD" in e.key else MFCC if "mfcc_kernel" in e.key
                   else NAME if "lsthm_onlysp_cluster" in e.key else "rest")
            split[key] += e.self_device_time_total / n / 1e3
        print("[profile]   ms/request: " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items()))
        for e in sorted(events, key=lambda e: e.self_device_time_total,
                        reverse=True)[:10]:
            if e.self_device_time_total > 0:
                print(f"[profile]   {e.self_device_time_total / n / 1e3:9.4f} "
                      f"ms/request x{e.count // n:<4d} {e.key[:90]}")

    # 7a. the rank-1 attention kernel against autograd through its plain
    #     version, forward and backward, p = 0 and 0.2 on one seed (so one
    #     mask); every launch synchronised; two runs bit-equal
    rank1_seed = torch.tensor([20240611], dtype=torch.int32, device=dev)
    rank1_err, rank1_worst = 0.0, 0.0
    for B in (80, 31, 1, 97, 256):
        *ins, g_out = rank1_inputs(torch, B, dev, seed=B)
        for p in (0.0, 0.2):
            got = rank1_fwd_bwd(torch, rank1_kernel.rank1_attention, ins, g_out,
                                rank1_seed, 3, p)
            again = rank1_fwd_bwd(torch, rank1_kernel.rank1_attention, ins, g_out,
                                  rank1_seed, 3, p)
            want = rank1_fwd_bwd(torch, rank1_kernel.rank1_attention_ref, ins, g_out,
                                 rank1_seed, 3, p)
            fracs = []
            for name, a, b in zip(("z", "dx1", "dx2", "dwq", "dwk"), got, want):
                scale = b.abs().max().item() if name in ("dwq", "dwk") else 1.0
                err = (a - b).abs()
                rank1_err = max(rank1_err, err.max().item())
                frac = (err / (RANK1_ATOL * scale + RANK1_RTOL * b.abs())).max().item()
                fracs.append(f"{name} {frac:.3f}")
                rank1_worst = max(rank1_worst, frac)
                check(torch.isfinite(a).all().item(), f"non-finite {RANK1} {name}, B={B}")
                check(frac <= 1.0, f"{RANK1} {name} disagrees with its plain "
                      f"version, B={B}, p={p}")
            bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"[kernel] {RANK1} [2, {B}, 128] p={p}: fraction of the tolerance "
                  f"{', '.join(fracs)}; two runs bit-equal: {bit_equal}")
            check(bit_equal, f"two {RANK1} runs differ, B={B}, p={p}")
    del ins, g_out, got, again, want  # free before phase 8 reads peak memory
    # the kernel's own mask: with wk = 0 every e is 1, and with x2 = 1
    # z = kept / ((1 - p) D) a row
    ones = torch.ones(2, TRAIN_B, 128, device=dev)
    z = rank1_kernel.rank1_attention(
        torch.randn(2, TRAIN_B, 128, device=dev), ones, torch.ones(2, 128, device=dev),
        torch.zeros(2, 128, device=dev), rank1_seed, 0, 0.2)
    torch.cuda.synchronize()
    kept = int((z * 0.8 * 128).round().sum().item())
    draws = 2 * TRAIN_B * 128 * 128
    plain_kept = int(rank1_kernel.keep_mask(rank1_seed, 0, TRAIN_B, 0.2).sum().item())
    print(f"[kernel] {RANK1} mask: kept {kept} of {draws} draws "
          f"({kept / draws:.6f}, 1 - p = 0.8), plain mask {plain_kept}")
    check(abs(kept / draws - 0.8) <= 0.002, f"{RANK1} keeps {kept / draws} of its draws")
    check(kept == plain_kept, f"{RANK1} mask differs from the plain version's")

    # 7b. one train step at [110, 80], card against CPU, same weights,
    #     dropout off; the CPU side runs the plain version
    train_batch = synthetic_batch(L=TRAIN_L, B=TRAIN_B, seed=1, min_len=20)
    t0 = time.perf_counter()
    conditioning = init_conditioning(torch)
    print("[train] f32 against f64 gradients of one step on the CPU at [64, 16], of a "
          "tensor's largest: " + ", ".join(f"{k} {v:.3e}" for k, v in conditioning.items())
          + f" ({time.perf_counter() - t0:.1f} s)")
    check(conditioning["constants random"] <= 1e-4, "f32 and f64 steps disagree on the CPU")
    trainers = {d: ModelTrainer(device=d, seed=0, lr=TRAIN_LR) for d in ("cpu", "cuda")}
    randomized = randomize_constants(torch, [t.model for t in trainers.values()], seed=1)
    print(f"[train] {len(randomized)} constant-initialised parameters given seeded "
          "random values on both sides")
    step_loss = {}
    for d, t in trainers.items():
        no_dropout(t.model, Dropout)
        reset_launches()
        t0 = time.perf_counter()
        step_loss[d] = t._train_step_impl(train_batch, TRAIN_LR).item()
        if d == "cuda":
            torch.cuda.synchronize()
            step_launches = LAUNCHES[RANK1]
        print(f"[train] one step [{TRAIN_L}, {TRAIN_B}] on {d}: loss {step_loss[d]:.7f} "
              f"in {time.perf_counter() - t0:.1f} s")
    worst, dead_cpu, dead_card = grad_check(torch, trainers["cpu"].model,
                                            trainers["cuda"].model)
    want_dead = {n for n, _ in trainers["cpu"].model.named_parameters() if DEAD.search(n)}
    moved = max((p.detach().cpu() - q.detach()).abs().max().item() for p, q in zip(
        trainers["cuda"].model.parameters(), trainers["cpu"].model.parameters()))
    loss_rel = abs(step_loss["cuda"] - step_loss["cpu"]) / abs(step_loss["cpu"])
    print(f"[train] card vs CPU: |loss| rel {loss_rel:.3e}, "
          f"gradients {worst:.3f} of the tolerance, {len(dead_card)} parameters "
          f"with no gradient, max |param card - CPU| after Adam {moved:.3e} "
          f"({moved / TRAIN_LR:.3f} lr), {RANK1} launches {step_launches}")
    check(loss_rel <= TRAIN_LOSS_RTOL, "train-step loss: card and CPU disagree")
    check(worst <= 1.0, "train-step gradients: card and CPU disagree")
    check(dead_cpu == dead_card == want_dead and len(want_dead) == 38,
          f"dead parameters: CPU {sorted(dead_cpu ^ want_dead)}, card "
          f"{sorted(dead_card ^ want_dead)} differ from the 38 declared-unused")
    check(moved <= 2.05 * TRAIN_LR, "Adam updates: card and CPU differ by more than 2.05 lr")
    check(step_launches == 2 * TRAIN_L, f"{RANK1} launched {step_launches} times "
          f"in a step of T={TRAIN_L}, want {2 * TRAIN_L}")
    del trainers

    # 7c. the train path: the trainer in process, a step with the MFCC front
    #     end, then the train and predict CLIs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        feature_path = generate_iemocap_pickles(str(tmp / "pickles"), seed=PREDICT_SEED,
                                                with_wav=True)
        train_loader, _, test_loader = get_loaders(
            feature_path, valid=0.2, batch_size=TRAIN_B, seed=PREDICT_SEED)
        trainer = ModelTrainer(seed=PREDICT_SEED, res_csv_path=str(tmp / "res.csv"))
        steps_T = []

        def recording(loader):  # the padded T of every train step
            for b in loader:
                steps_T.append(b["qmask"].shape[0])
                yield b

        reset_launches()
        t0 = time.perf_counter()
        history = []
        for epoch in (1, 2):
            lr, loss = trainer.train_network(epoch, recording(train_loader))
            acc, f1, _ = trainer.eval_network(test_loader)
            history.append((loss, acc, f1))
        torch.cuda.synchronize()
        train_launches = dict(LAUNCHES)
        print(f"[train] ModelTrainer, 2 epochs, {len(steps_T)} steps in all at batch "
              f"{TRAIN_B} (T {steps_T}), an eval after each: "
              f"{time.perf_counter() - t0:.1f} s, "
              f"(loss, acc, f1) {history}, launches {train_launches}")
        check(all(math.isfinite(v) for h in history for v in h), "non-finite train loss")
        check(train_launches.get(RANK1, 0) == 2 * sum(steps_T),
              f"{RANK1} launches {train_launches.get(RANK1)}, want 2 per step a T")
        check(train_launches.get(NAME, 0) == 2 * len(test_loader),
              f"{NAME} launches {train_launches.get(NAME)}, want one an eval batch")

        wav_trainer = ModelTrainer(seed=0, audio_frontend="mfcc")
        wav_batch_train = next(iter(get_loaders(
            feature_path, valid=0.2, batch_size=TRAIN_B, seed=PREDICT_SEED,
            wav_path="auto")[0]))
        reset_launches()
        wav_loss = wav_trainer._train_step_impl(wav_batch_train, TRAIN_LR).item()
        torch.cuda.synchronize()
        wav_train_launches = dict(LAUNCHES)
        print(f"[train] one step with the MFCC front end: loss {wav_loss:.5f}, "
              f"launches {wav_train_launches}")
        check(math.isfinite(wav_loss) and wav_train_launches.get(MFCC, 0) == 1,
              f"the wav train step launched {wav_train_launches}, want {MFCC} once")
        del trainer, wav_trainer

        exp = tmp / "exp"
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "ser_tpu_torch.train", "--synthetic", "--epoch", "2",
             "--batch_size", str(TRAIN_B), "--save_path", str(exp)],
            cwd=tmp, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
        print(f"[cli] train CLI, 2 epochs: exit {run.returncode} in "
              f"{time.perf_counter() - t0:.1f} s")
        check(run.returncode == 0, f"train CLI exited {run.returncode}:\n{run.stderr[-3000:]}")
        lines = score_lines(exp / "score.txt")
        for line in lines:
            print(f"[cli]   score.txt: {line}")
        models = sorted(q.name for q in (exp / "model").iterdir())
        params_csv = (tmp / "parameters.csv").read_text().splitlines()
        check(len(lines) == 2 and models == ["model_0001.model", "model_0002.model"],
              f"train CLI wrote {len(lines)} score lines and {models}")
        check(params_csv[0] == "w,v,v1,v2" and len(params_csv) == 3,
              f"parameters.csv: {params_csv}")
        run = subprocess.run(
            [sys.executable, "-m", "ser_tpu_torch.predict", "--synthetic",
             "--initial_model", str(exp / "model" / "model_0002.model"),
             "--res_csv", str(tmp / "predict.csv")],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(run.returncode == 0, f"predict CLI exited {run.returncode}:\n{run.stderr[-3000:]}")
        rep = json.loads(run.stdout[run.stdout.index("{"):])
        scored = re.search(r"Acc ([\d.]+), Fscore ([\d.]+)", lines[1]).groups()
        predicted = (f"{rep['weighted_accuracy']:.2f}", f"{rep['weighted_f1']:.2f}")
        print(f"[cli] predict on model_0002: Acc {predicted[0]}, F1 {predicted[1]}; "
              f"score.txt epoch 2: Acc {scored[0]}, Fscore {scored[1]}")
        check(predicted == scored, "the predict CLI's Acc/F1 differ from score.txt's")

    # 7d. exact resume on MELD through the train CLI in this process: 2
    #     epochs with --save_state, then --resume latest to 3; 3 epochs
    #     without a stop; the state reloaded and saved again; the kernels'
    #     launches of the unstopped run
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        tmp = Path(tmp)

        def train(save, *extra):
            args = train_cli.parser_args(
                ["--dataset", "MELD", "--n_classes", "7", "--feature_path", meld_path,
                 "--batch_size", str(TRAIN_B), "--save_path", str(tmp / save),
                 "--save_state", *extra])
            return run_quiet(in_dir, tmp, train_cli.main, args)

        t0 = time.perf_counter()
        train("stopped", "--epoch", "2")
        snap = tmp / "epoch2.state"
        snap.write_bytes((tmp / "stopped" / "model" / "last.state").read_bytes())
        resumed_out = train("stopped", "--epoch", "3", "--resume", "latest")
        check("resumed at epoch 2!" in resumed_out, "the train CLI did not resume")
        reset_launches()
        train("unstopped", "--epoch", "3")
        torch.cuda.synchronize()
        unstopped_launches = dict(LAUNCHES)
        print(f"[resume] MELD train CLI, 2 + 1 epochs and 3 epochs at batch {TRAIN_B}: "
              f"{time.perf_counter() - t0:.1f} s")
        back = ModelTrainer(seed=0, n_classes=7)
        saved_epoch = back.load_train_state(str(snap))
        back.save_train_state(str(tmp / "again.state"), saved_epoch, back.history)
        saved = state_arrays(np, snap)
        again = state_arrays(np, tmp / "again.state")
        same = sorted(saved) == sorted(again) and all(
            saved[k].dtype == again[k].dtype and np.array_equal(saved[k], again[k])
            for k in saved)
        print(f"[resume] epoch-2 state ({len(saved)} arrays: parameters, Adam moments and "
              f"steps, epoch, generator, history) loaded into a trainer on the card and "
              f"saved again: bit-equal {same}")
        check(saved_epoch == 2 and same, "the reloaded train state differs from the saved one")
        resumed = state_arrays(np, tmp / "stopped" / "model" / "last.state")
        unstopped = state_arrays(np, tmp / "unstopped" / "model" / "last.state")
        diff = {k: float(np.abs(resumed[k].astype(np.float64) - unstopped[k]).max())
                for k in unstopped if k.startswith(("params/", "opt/"))}
        worst = max(diff, key=diff.get)
        param_diff = max(v for k, v in diff.items() if k.startswith("params/"))
        gen_equal = np.array_equal(resumed["extra/generator"], unstopped["extra/generator"])
        lines = {k: [line.split(" —— ", 1)[1] for line in score_lines(tmp / k / "score.txt")]
                 for k in ("stopped", "unstopped")}
        print(f"[resume] resumed against unstopped after epoch 3: largest |parameter "
              f"difference| {param_diff:.3e}, over parameters and Adam state "
              f"{diff[worst]:.3e} ({worst}); generator equal {gen_equal}; score.txt "
              f"epoch lines equal {lines['stopped'] == lines['unstopped']}")
        for line in lines["unstopped"]:
            print(f"[resume]   score.txt: {line}")
        check(len(lines["unstopped"]) == 3, "the unstopped MELD run wrote no 3 score lines")
        meld_train = meld_loaders(7)[0]
        Ts = [b["qmask"].shape[0] for _ in range(3) for b in meld_train]
        print(f"[resume] unstopped run: {len(Ts)} steps (T {Ts}), launches "
              f"{unstopped_launches}")
        check(unstopped_launches.get(RANK1, 0) == 2 * sum(Ts),
              f"{RANK1} launches {unstopped_launches.get(RANK1)}, want 2 a step's T")
        check(unstopped_launches.get(NAME, 0) == 3 * len(meld_test),
              f"{NAME} launches {unstopped_launches.get(NAME)}, want one an eval batch")
    del back

    # 8. train timings: the rank-1 kernel, a whole step with it and with the
    #    plain version swapped in, the recurrence inside a step, a profile
    rank1_ms, r1_plain_ms, rb, sdpa_pair_ms = rank1_timings(
        torch, card, dev, rank1_kernel, rank1_seed)

    spec_x = spec.make_inputs(train_batch)
    step_trainer = ModelTrainer(seed=0, lr=TRAIN_LR)
    step = lambda: step_trainer._train_step_impl(train_batch, TRAIN_LR)
    step_ms, step_peak = {}, {}
    kernel_fn = marn_onlysp.rank1_bind
    for variant, fn in (("plain", rank1_kernel.bind_ref), ("kernel", kernel_fn),
                        ("kernel", kernel_fn), ("plain", rank1_kernel.bind_ref)):
        marn_onlysp.rank1_bind = fn
        try:
            step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(torch, step, warmup=0, iters=5)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            marn_onlysp.rank1_bind = kernel_fn
        step_ms.setdefault(variant, []).append(ms)
        step_peak.setdefault(variant, []).append(peak)
    print(f"[time] {card} | train step [{TRAIN_L}, {TRAIN_B}] (median of 5 after one "
          f"warm-up, in turns plain, kernel, kernel, plain): kernel {step_ms['kernel']} ms, peak "
          f"{step_peak['kernel']} GiB; plain version {step_ms['plain']} ms, peak "
          f"{step_peak['plain']} GiB")

    # the recurrence's share: its forward and its backward inside a step,
    # with the inputs cut from the graph so the backward stops there
    model = step_trainer.model.train()
    xt, qt, ut = (torch.as_tensor(a, device=dev) for a in spec_x)
    gen = step_trainer.generator
    rec_seqs, rec_consts = model.recurrence_inputs(xt, qt, ut, gen)[:2]
    rec_seqs = [t.detach().requires_grad_() for t in rec_seqs[:3]] + [rec_seqs[3].detach()]
    rec_consts = [t.detach().requires_grad_() for t in rec_consts]
    run_rec = lambda: marn_onlysp.train_recurrence(rec_seqs, rec_consts, gen)
    rec_fwd_ms = cuda_ms(torch, run_rec, warmup=2, iters=5)
    ys = run_rec()
    gy = torch.randn_like(ys)
    rec_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        ys, rec_seqs[:3] + rec_consts, gy, retain_graph=True), warmup=1, iters=5)
    print(f"[time] {card} | the train recurrence at [{TRAIN_L}, {TRAIN_B}]: forward "
          f"{rec_fwd_ms:.4f} ms, backward {rec_bwd_ms:.4f} ms, "
          f"{100 * (rec_fwd_ms + rec_bwd_ms) / step_ms['kernel'][0]:.1f}% of a step")
    del ys, rec_seqs, rec_consts

    wall_ms, busy_ms, events = device_profile(torch, step, 1)
    n_kernels = sum(e.count for e in events if "Memcpy" not in e.key
                    and "Memset" not in e.key)
    print(f"[profile] {card} | train step [{TRAIN_L}, {TRAIN_B}], one step: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{n_kernels:.0f} kernel launches a step")
    split = {RANK1: 0.0, "gemm": 0.0, "copies": 0.0, "rest": 0.0}
    for e in events:
        key = (RANK1 if "rank1_" in e.key else "copies" if "Memcpy" in e.key
               or "Memset" in e.key else "gemm" if "gemm" in e.key.lower() else "rest")
        split[key] += e.self_device_time_total / 1e3
    print("[profile]   device ms/step: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        if e.self_device_time_total > 0:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.4f} "
                  f"ms/step x{e.count:<5d} {e.key[:90]}")

    # what the port's Adam adds to torch's to restore parameters whose
    # gradient is all zero: CUDA launches of one step on the step's gradients
    params = [p for p in step_trainer.model.parameters() if p.grad is not None]
    opt_launches = []
    for opt in (torch.optim.Adam(params, lr=TRAIN_LR, weight_decay=2e-5),
                step_trainer.optimizer):
        opt.step()
        _, _, events = device_profile(torch, opt.step, 1)
        opt_launches.append(sum(e.count for e in events))
    print(f"[profile] {card} | one optimizer step over {len(params)} parameters: "
          f"torch.optim.Adam {opt_launches[0]} CUDA launches, the port's Adam "
          f"{opt_launches[1]}; the restore adds {opt_launches[1] - opt_launches[0]}")

    # a MELD train step at [32, 80], P = 9: median of 5, peak memory, launches
    del step_trainer, step, model, params, opt
    meld_batch = next(iter(meld_loaders(7)[0]))
    check(meld_batch["qmask"].shape == (32, TRAIN_B, 9), "MELD train batch shape")
    meld_trainer = ModelTrainer(seed=0, lr=TRAIN_LR, n_classes=7)
    meld_step = lambda: meld_trainer._train_step_impl(meld_batch, TRAIN_LR)
    meld_step()
    torch.cuda.synchronize()
    reset_launches()
    meld_step()
    torch.cuda.synchronize()
    meld_step_launches = dict(LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    meld_step_ms = [cuda_ms(torch, meld_step, warmup=0, iters=5) for _ in range(2)]
    print(f"[time] {card} | MELD train step [32, {TRAIN_B}], P=9, 7 classes (median of 5, "
          f"twice): {meld_step_ms} ms, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.4f} "
          f"GiB, launches a step {meld_step_launches}")
    check(meld_step_launches.get(RANK1, 0) == 2 * 32,
          f"a MELD step launched {RANK1} {meld_step_launches.get(RANK1)} times, want 64")
    del meld_trainer, meld_step

    # 9. the rank-1 MARN1 variants, served and trained on the card
    t0 = time.perf_counter()
    variant_launches = variant_phase(torch, card, eval_batch, meld_test, VARIANTS)
    print(f"[variant] phase 9 in {time.perf_counter() - t0:.1f} s; {RANK1} launches by "
          f"path: {variant_launches}")

    # 10. mf, la and newz, served, trained and streamed on the card
    t0 = time.perf_counter()
    rest_phase(torch, card, eval_batch, meld_test, REST)
    print(f"[rest] phase 10 in {time.perf_counter() - t0:.1f} s")

    # 11. DialogueRNN, BiLSTM, MARN, MARN_AT and MARN_ATV on the card
    t0 = time.perf_counter()
    drnn_wav_launches = baseline_phase(torch, card, eval_batch, meld_test, BASELINES)
    print(f"[baseline] phase 11 in {time.perf_counter() - t0:.1f} s")

    # 12. the serving artifacts: export, bucket graphs, run and bench
    t0 = time.perf_counter()
    artifacts_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_artifacts_")
    serve_launches = serving_phase(torch, card, eval_batch, meld_path, artifacts_tmp.name)
    print(f"[serve] phase 12 in {time.perf_counter() - t0:.1f} s; launches by path: "
          f"{serve_launches}")

    # 13. the five zoo kinds of --encoder_attention, --infonce, --debug_nans
    t0 = time.perf_counter()
    zoo_launches = zoo_phase(torch, card, eval_batch)
    print(f"[zoo] phase 13 in {time.perf_counter() - t0:.1f} s; launches by path: "
          f"{zoo_launches}")

    # 14. --compute_dtype bf16 through the bf16 rank-1 kernel, and --dp
    t0 = time.perf_counter()
    bf16_record, dp_launches, dp_steps = bf16_dp_phase(torch, card, dev, logs)
    print(f"[bf16] phase 14 in {time.perf_counter() - t0:.1f} s; {bf16_record['name']} "
          f"launches by path: {bf16_record['launches_by_path']}")

    # 15. --tp: tp 2 and the (2, 2) grid in processes sharing the card
    t0 = time.perf_counter()
    tp_launches = tp_phase(torch, card, dp_steps)
    print(f"[tp] phase 15 in {time.perf_counter() - t0:.1f} s; launches by path: "
          f"{tp_launches}")

    # 16. the DialogueRNN suite's extras, the C collate, FLOPs, analyze_res
    t0 = time.perf_counter()
    extras_phase(torch, card, cli_res, cli_report, predict_ms, step_ms["kernel"], eval_batch,
                 meld_path)
    print(f"[extras] phase 16 in {time.perf_counter() - t0:.1f} s")
    meld_tmp.cleanup()

    # 17. train --eval's score.txt, h.csv, the two scripts, the zoo's 20 classes
    t0 = time.perf_counter()
    tools_launches = tools_zoo_phase(torch, card, weights, [
        str(Path(artifacts_tmp.name) / f"onlysp_{d}.ser") for d in ("f32", "bf16", "int8")])
    artifacts_tmp.cleanup()
    print(f"[tools] phase 17 in {time.perf_counter() - t0:.1f} s; launches by path: "
          f"{tools_launches}")

    # 18. the attention zoo's last 15 classes: the vision blocks, the backbones
    t0 = time.perf_counter()
    last_zoo_phase(torch, card)
    print(f"[zoo18] phase 18 in {time.perf_counter() - t0:.1f} s")

    # 19. python -m ser_tpu_torch.bench and bench_zoo, in this process
    t0 = time.perf_counter()
    bench_launches = bench_phase(torch, card)
    print(f"[bench] phase 19 in {time.perf_counter() - t0:.1f} s; launches by path: "
          f"{bench_launches}")
    bf16_record["launches_by_path"].update(tools_launches[rank1_kernel.NAME_BF16])
    bf16_record["launches_by_path"].update(bench_launches[rank1_kernel.NAME_BF16])
    bf16_record["launches"] = sum(bf16_record["launches_by_path"].values())
    mfcc_launches = {"MARN1_onlysp wav request": wav_launches[MFCC],
                     "DialogueRNN predict CLI --audio_frontend mfcc": drnn_wav_launches,
                     **bench_launches[MFCC]}
    rank1_launches = {"MARN1_onlysp ModelTrainer, 2 epochs": train_launches[RANK1],
                      **variant_launches, **serve_launches[RANK1], **zoo_launches[RANK1],
                      **dp_launches[RANK1], **tp_launches[RANK1], **tools_launches[RANK1],
                      **bench_launches[RANK1]}
    lsthm_launches = {"MARN1_onlysp Predictor, three requests": main_launches,
                      **serve_launches[NAME], **zoo_launches[NAME], **dp_launches[NAME],
                      **tp_launches[NAME], **tools_launches[NAME], **bench_launches[NAME]}

    print(json.dumps({"kernels": [{
        "name": NAME, "route": "cuda",
        "source": "ser_tpu_torch/csrc/lsthm_onlysp.cu",
        "replaces": "ser_tpu/ops/pallas/lsthm.py:296",
        "launches": sum(lsthm_launches.values()), "launches_by_path": lsthm_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "p9_launches": meld_launches[7], "p9_max_abs_err": p9_err,
        "p9_ms": kernel9_ms, "p9_device_ms": kernel9_dev, "p9_plain_ms": plain9_ms,
        "p9_bound_ms": bound9_ms,
        "p9_bound_by": bound9_by}, {
        "name": MFCC, "route": "cuda",
        "source": "ser_tpu_torch/csrc/mfcc.cu",
        "replaces": "ser_tpu/ops/pallas/mfcc.py:152",
        "launches": sum(mfcc_launches.values()), "launches_by_path": mfcc_launches,
        "max_abs_err": mfcc_err,
        "ms": mfcc_ms, "plain_ms": mfcc_plain_ms, "bound_ms": mfcc_bound_ms,
        "bound_by": mfcc_bound_by, "library_ms": None}, {
        "name": RANK1, "route": "cuda",
        "source": "ser_tpu_torch/csrc/rank1_attention.cu",
        "replaces": "ser_tpu/ops/attention.py:41",
        "launches": sum(rank1_launches.values()), "launches_by_path": rank1_launches,
        "max_abs_err": rank1_err,
        "ms": rank1_ms, "plain_ms": r1_plain_ms, "bound_ms": rb["both"][0],
        "bound_by": rb["both"][1], "library_ms": sdpa_pair_ms}, bf16_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp_worker"]:  # phase 14e's processes
        sys.exit(dp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--tp_worker"]:  # phase 15's processes
        sys.exit(tp_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
