#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``torecsys_tpu_torch``).

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0] [--steps 20] [--out DIR] [--profile] [--auto-sweep]

Phases (any failure raises and the exit code is not 0):

1. Build the port's CUDA kernels from ``torecsys_tpu_torch/csrc`` with nvcc,
   one compiler per source, all started together, and beside them the row
   gather's sweep build (``embedding.cu`` with ``TRS_ROW_GATHER_SWEEP``).
2. Hold each of the six kernels against its plain PyTorch version on the
   card, at the shapes of the main path: one Criteo-scale batch (the
   workload of ``bench.py``: 28 Zipf(1.2) id fields over 32.9M fused rows,
   batch 4096, E=16), presorted by the port's ``Presorter`` or sorted on
   the card.  Prints each kernel's time, its plain version's time, the time
   of one PyTorch call computing the same function where there is one, and
   its bound; each time is the device's own (the kernels' durations in a
   torch.profiler window), with CUDA events around the same calls beside it,
   and again with the L2 cache flushed before each call (``cold_ms``).
   Then sweeps both segment sums over skewed and tile-edge streams (the
   bench stream, one segment, M distinct segments, segments on tile edges,
   M = 1): grid grads bit-identical to the plain version, real-valued grads
   within the float64 rounding bound, two launches bit-identical; sweeps
   ``fused_sorted_dedup_update`` over the same streams as stored rows and a
   sentinel tail, at P = 8 and P = 1, each rule on real-valued grads: table
   and slots bit-identical to the default combine's, two launches
   bit-identical, untouched rows unchanged; sweeps ``unique_stored_gather``
   over valid prefixes of several lengths, each bit-identical to
   ``index_select``; holds ``row_gather`` to its plain version bit for bit
   on the lookup, the stored rows and the grad permute (int32 and int64
   order), times the sweep build's chunks (8, 16, 32 ids a warp) and reads
   in flight (2, 4, 8 a lane) on the lookup, and sweeps it over edge streams
   (M distinct ids, one id, chunk edges, NaN rows, width 13, an offset
   pointer); and holds the lookup's backward (``table_grad``) to the
   ``index_add_`` form it replaced, timing both.
3. Train the full-width DeepFM (tower 400-400-400, Adam 1e-3, sparse
   presorted embedding route) through the port's ``Trainer`` for ``--steps``
   steps; every kernel of the route must launch once per step, the row
   gather twice (the lookup and the grad permute).  Then take 3 more steps,
   each from the kernels' state both with the kernels and with their plain
   versions, and compare.
4. Evaluate the trained model on 8 held-out batches (``Trainer.evaluate``:
   one ``row_gather`` per batch) and predict one batch with the kernel and
   with its plain version: the scores must be bit-identical.
5. Train the same model on the on-device sparse route
   (``Trainer(presort=False)``) on phase 3's batches, ``--steps`` steps on
   the default combine and ``--steps`` with ``TORECSYS_TPU_FUSED_DEDUP=1``;
   then 3 steps, each from the default combine's state, of each variant
   with the kernels and with their plain versions and of the presorted
   route, all compared (the fused kernel's losses, table and slots to the
   bit).
6. Train the same model on the dense-table route (Adam over every
   parameter, the table included) for ``--steps`` steps; take 3 steps twice
   with the kernels from one state (losses, table and Adam moments must be
   the same bits), then compare 3 steps with the kernels and with their
   plain versions, as in phase 3.
7. Train the ``pack == 1`` sparse route: the same DeepFM with E=128 on the
   bench id streams, each field capped at 1,000,000 rows, for 5 steps.
8. (Run after phase 2.)  The C++ presort (``data/native``, built with
   ``g++`` beside the nvcc builds of phase 1) against the numpy presort on
   8 bench batches, bit for bit, with each one's host ms a batch; the
   ``Presorter`` must be on the C++ route.  Phase 2 also holds
   ``row_gather`` on the bench table stored in bf16 to its plain version,
   bit for bit (``[gather-bf16]``).
9. Each of the four training routes (presorted, on-device default combine,
   on-device fused, dense) at 8 steps a dispatch, with the bf16 tower: the
   first dispatch warms up and captures a CUDA graph of the 8 steps (the
   launch counters tick there, and not in a replay); then, from one state,
   one replay against 8 eager steps (losses, table, slots, Adam state and
   parameters must be the same bits); one replay under
   ``torch.cuda.set_sync_debug_mode("error")``; eager against graphed
   examples/sec, host ms a step and peak memory on the same batches; and
   one traced replay, whose device events give each kernel's launches per
   replay and the device busy time a step.
10. The headline configuration of ``bench.py`` through the entry points:
    ``set_sparse_embeddings(None)``, ``set_compute_dtype("bfloat16")`` and
    ``Trainer(steps_per_execution=8)`` (prefetch 4, presort None), two
    epochs of ``fit`` over 96 batches; the automatic choice must take the
    sparse route, on the card the on-device one (presort None does not
    presort there).  Its launches are the
    counters' (warm-up and capture) plus the replays times a traced
    replay's.
11. bench.py's file-fed configuration (bench.py:314-393) and the port's
    CLI, on a Criteo DAC TSV of about 256 MB written with numpy into a
    temporary directory (Zipf(1.2) tokens capped at the bench's first 26
    field sizes) and deleted at the end: the C++ parser must be the route
    taken and bit-identical to the Python route on the file's first 4 MB
    (then its rows/sec on one 64 MB chunk); the ``CriteoFileIterable``
    alone over 400 batches (examples/sec, no card in the loop); two epochs
    of ``Trainer.fit`` over the stream in 64 MB chunks (automatic route,
    which must be the on-device one; bf16 tower; 8 steps a dispatch;
    prefetch 8): launches as phase 10's, each step's kernels, the second
    epoch's examples/sec, host ms per stage, device busy share and peak
    memory; then the CLI in this process through ``cli.main`` at full
    width (``train --stream on --criteo_hash_size 1264800``, 64 steps with
    a checkpoint; a trainer restored from it holds the saved state to the
    bit, restored twice in place, and saves it again to the bit; the same
    train command again resumes and takes 16 more steps; ``evaluate
    --load_from`` the last checkpoint), with the save and restore seconds
    and the checkpoint's GB.

12. (Phases 12-14 run after phase 10, before phase 11.)  xDeepFM
    (BASELINE.md configuration 4) at full width on the bench's
    workload: CIN (200, 200, 200) split-half with BatchNorm, DNN (400, 400),
    bf16 tower, ``set_sparse_embeddings(None)``,
    ``Trainer(steps_per_execution=8)``: one eager step from one state with
    the kernels against their plain versions (losses, touched rows and the
    running statistics), two epochs of ``fit`` over 96 batches (launches as
    phase 10's; the loss finite and falling), a replay against 8 eager
    steps to the bit with the running statistics, ``evaluate`` in ``eval()``
    mode, and the CIN's and the GEMMs' device time a step.
13. DCN (the JAX package's defaults: 3 cross layers, deep (64, 64), deep
    output 16) at the same fingerprint, eager: timed steps, then steps each
    from one state with the kernels against their plain versions.
14. FFM (BASELINE.md configuration 2) over the field-aware table, E = 4 on
    the 28 fields: 3,211,264 ids a batch at pack 32.  (a) With each field
    capped at 1M rows: 3 on-device steps on the default combine and 3 with
    the fused dedup, and one presorted step, each from one state with the
    kernels against their plain versions, and a replay against 8 eager
    steps to the bit.  (b) At the full vocabulary (a 14.73 GB table and
    29.46 GB of slots): two epochs of ``fit`` over 32 batches at 8 steps a
    dispatch, then a second capture with ``TORECSYS_TPU_FUSED_DEDUP=1``;
    each kernel's in-graph time beside its bound.
15. (Run after phase 14, before phase 11.)  NCF + BPR (BASELINE.md
    configuration 5) at the MovieLens-20M vocabulary (138,493 users, 26,744
    items; E = 64, tower (256, 128, 64), the NCF paper's) on 4M implicit
    interactions written with numpy (a planted user→item preference, Zipf
    item popularity; 95% trained, 5% held out): ``set_objective("ltr")``
    with ``UniformBatchMiner(num_negs=4)``, batch 1024, Adam 1e-3, float32,
    ``Trainer(steps_per_execution=8)``, one epoch of ``fit``.  The miner's
    draws on the card equal the CPU's; one step from one state with the
    kernels against their plain versions (losses, every parameter and its
    Adam moments); NDCG@10 on the held-out batches must rise by more than
    0.05 over the epoch; launches (4 row gathers and 2 table-gradient sums a
    step, the dense route's two applications) from the counters and a
    traced replay; a replay against 8 eager steps to the bit and one under
    ``set_sync_debug_mode("error")``; positive examples a second, step ms,
    host ms, device busy and peak GB.  Then MF with ListNet and a
    regularizer on its table, and StarSpace on ``emb``, at E = 16: steps
    each from one state against the plain versions.

16. (Phases 16-18 run after phase 15, before phase 11.)  FAT-DeepFFM (and
    DeepFFM) under Adagrad, as the FFM paper trains FFM, on FFM's shape
    (E = 4, pack 32, 3,211,264 ids a batch): RowAdagrad on the table, the
    optax-exact Adagrad on the tower (400, 400, 400), on the on-device
    route.  (a) With each field capped at 1M rows: one step of each model
    from one state on the default combine and on the fused dedup, with the
    kernels against their plain versions (losses, the table, its ``v``
    slot, the tower and its accumulators, each by its change over the step;
    the table first scaled to a trained table's magnitude, which the check
    needs to see the step at all, as in phases 17 and 18); a replay of 8 FAT-DeepFFM steps
    against 8 eager steps to the bit, and one under
    ``set_sync_debug_mode("error")``.  (b) At the full vocabulary (a 14.73
    GB table and a 14.73 GB slot): two epochs of ``fit`` over 32 batches at
    8 steps a dispatch, then the fused dedup captured; each kernel's
    in-graph time beside its bound.
17. FiBiNET at the FiBiNET paper's Criteo settings (E = 10, SENET reduction
    3, DNN (400, 400, 400), Adam 1e-4, bilinear "all", no dropout) over the
    bench's fields: E = 10 packs 8 rows into a stored row of 80 floats, so
    the segment sum and the fused dedup take their scalar instantiations and
    the grad permute moves 40-byte rows.  One step from one state with the
    kernels against their plain versions on the on-device route (both
    dedup settings) and the presorted one, and for the "each" and
    "interaction" types with fields capped at 1M rows; a replay against 8
    eager steps to the bit and one under ``set_sync_debug_mode("error")``;
    two epochs of ``fit`` (48 batches) on the route the automatic choice
    takes, then the fused dedup captured; each kernel's in-graph time
    beside its bound.  Phase 2's segment-sum and dedup sweeps also run
    their streams at E = 10.
18. The bench DeepFM with fields capped at 100,000 rows under each of the
    twelve optimizers on the dense route, and under Adam, AdamW, Adagrad and
    SGD (their row rules) on the on-device route with both dedup settings:
    3 steps each from one state with the kernels against their plain
    versions; a replay against 8 eager steps to the bit and one under
    ``set_sync_debug_mode("error")``; graphed examples/sec and a traced
    replay; then one step of an opaque optimizer factory and of Lamb under
    the automatic choice, both on the dense route.  The kernels line gives
    the row rules each path launched the two row-update kernels under, and
    each path's launches (``launches_by_path``; the held steps' and replay
    checks' of phases 16-22 in ``check_launches``).  Then the same for
    optax's other names that the JAX Trainer can train with (one held step
    each; rprop's after its first step, whose update is 0) and for Adam
    under ``warmup_cosine_decay_schedule``, whose 16 replayed steps each
    take the schedule at its own count.

19. (Phases 19-20 run after phase 18, before phase 11.)  MMoE on bench.py's
    workload (the MMoE paper's model, Ma et al., KDD 2018, at DeepCTR's
    ``MMOE`` defaults: 3 experts of (256,) → 128, towers (64,) → 1, the gate
    one Dense) with two tasks on ``(B, 2)`` labels drawn from ``--seed``,
    Adam 1e-3, ``set_sparse_embeddings(None)``, bf16 tower,
    ``Trainer(steps_per_execution=8)``: one step from one state with the
    kernels against their plain versions on the on-device route (both dedup
    settings) and the presorted one, the table scaled first; a replay
    against 8 eager steps to the bit and one under
    ``set_sync_debug_mode("error")``; two epochs of ``fit`` over 48 batches
    on the route the automatic choice takes (examples/sec, step ms, host ms
    per stage, device busy share, peak GB), then the fused dedup captured,
    each kernel's in-graph time beside its bound; ``evaluate`` on 8
    held-out batches and ``predict``.
20. The other new models, each at a stated size: ESMM at E = 18 with an
    MLP (360, 200, 80) per head (Ma et al., SIGIR 2018, section 4.2) over
    the bench's fields capped at 1M rows, trained on (click, conversion)
    labels with ``BCE(pCTR, click) + BCE(pCTR·pCVR, conversion)`` given as a
    callable: E = 18 packs 4 rows into stored rows of 72 floats, so the
    segment sum, the fused dedup and the 72-byte grad permute take their
    scalar instantiations; ESM2, DeepMoE with two MoE layers and DeepMCP
    (four tables, the dense route) at the JAX defaults; PAL around the
    bench DeepFM through nested inputs; PRM at the JAX defaults over lists
    of 30 of phase 15's 26,744 items at E = 64, 1024 lists a batch, on the
    dense route.  One step of each from one state with the kernels against
    their plain versions (losses, tables, every parameter and its Adam
    moments, PRM's running statistics), ESMM's on both dedup settings; a
    replay against 8 eager steps to the bit and one under
    ``set_sync_debug_mode("error")`` for ESMM and PRM; ESMM's graphed steps
    traced, each kernel's in-graph time beside its bound.  Phase 2's
    segment-sum and dedup sweeps also run their streams at E = 18.
21. (Run after phase 20, before phase 11.)  DSIN (Feng et al., IJCAI 2019)
    at DeepCTR's defaults (E = 8: 8 heads of depth 1, a BiLSTM of 8 units,
    5 sessions) over sessions of 10 behaviours from the 846,811 ad groups of
    the Taobao display-ad dataset, batch 4096, Adam 1e-3, float32, through
    ``Pipeline(...).set_inputs(Inputs({...})).set_model("DSIN")`` and
    ``Trainer(steps_per_execution=8)`` on the dense route (the list input's
    lookup is ``row_gather``, its gradient ``table_grad``): one step from
    one state with the kernels against their plain versions at float32 and
    at bf16 compute; a replay against 8 eager steps to the bit and one under
    ``set_sync_debug_mode("error")``; one epoch of ``fit`` over 48 batches,
    graphed steps timed and traced (each kernel's in-graph time beside its
    bound at DSIN's 32-byte rows), ``evaluate`` and ``predict``.  Then the
    bench DeepFM with fields capped at 1M rows on the on-device route over a
    ``StackedInput`` of its table, a 2-layer bidirectional
    ``SequenceIndicesEmbedding`` and a ``ListIndicesEmbedding`` with
    attention: one step each with LSTM, GRU and simple cells from one state
    against the plain versions (the bench table on the row kernels, the
    history tables on Adam through ``table_grad``), and a replay of the
    LSTM's against 8 eager steps to the bit.
22. (Run after phase 21, before phase 11.)  The bench DeepFM whose
    ``emb_inputs`` stacks its table and an ``ImageInput(16, 3)`` at the
    JAX package's default tower, over 64x64 RGB uint8 thumbnails from a
    pool of 8,192 made from ``--seed``, float32, the automatic sparse route,
    ``Trainer(steps_per_execution=8)``: one step from fresh Adam moments
    with the kernels against their plain versions; a replay against 8 eager
    steps to the bit and one under ``set_sync_debug_mode("error")``; one
    epoch of ``fit`` over 48 batches, graphed steps timed and traced (the
    convolutions', unfold and fold's, GEMMs', max pool's and the port's
    kernels' device time apart); the fitted tower saved with
    ``save_tower_weights`` and a DeepFM over a ``PretrainedImageInput`` of
    it held the same way, its tower unmoved; ``embedding_lookup`` and
    ``fused_offset_lookup`` (one ``row_gather`` each, equal to
    ``index_select``) and ``not_jittable`` under a real capture.
23. (Run after phase 22, before phase 11.)  Parallelism: four ranks of
    this script (``--parallel-rank``, spawned after the build) share the
    card over gloo (collectives staged through the host), each the bench
    DeepFM at full width on a ``(data, table)`` mesh: (2, 2) under psum,
    alltoall and auto (the table row-sharded) and (1, 4) under psum (the
    table replicated by the rule, its lookups still collective); each run
    two steps held on rank 0 against the single-device Trainer's plain step
    from one state (the touched rows, their moments, the dense parameters
    and their Adam state), then a ``fit`` of 6 batches, every rank's
    launches counted; then a planted all-to-all overflow (NaN, the error,
    the recovery to a capacity factor of 4).  With two cards or more the
    runs again one rank a card over NCCL, timed (examples/sec, step ms,
    busy share, NCCL ms by kind, MB a step against ``modeled_comm_mb``),
    and a graphed ``fit`` at 4 steps a dispatch with a replay held to its
    eager steps to the bit.
24. (Run after phase 11.)  Quality at convergence: the bench DeepFM's
    table and tower at full width (28 fields, 32.9M rows, E = 16, tower
    400-400-400, batch 4096, 8 steps a dispatch, the automatic choice: the
    on-device sparse route) trained for 5 epochs on planted-interaction
    data (``make_synthetic_ctr``: 1,048,576 rows, 13 dense fields, pair
    scale 2.0, from ``--seed``), 917,504 rows to train on and two held-out
    halves of 65,536: the epoch is chosen on the first half's logloss, and
    its model judged on the second.  Its first order is a 1-wide table of
    the fields, as PARITY.md's protocol takes it (the bench pipeline's is
    the unweighted sum of the 13 raw dense values: that arm is trained and
    printed beside, not judged).  Pass: at bf16 and at float32 compute the
    DeepFM beats the port's LR over the same 1-wide table by 0.005 AUC with
    logloss under ln 2, and the bf16 AUC lies within 0.003 of float32's.
25. The parity protocol's cut (``parity/run_parity_torch.py``): one seed of
    each of PARITY.md's rows on the default (dense) and the sparse
    (on-device) route at 8 steps a dispatch; each CTR row but xDeepFM with
    BatchNorm must lie within the larger of two seed bands of the JAX
    package's mean (``PARITY.json``), the JAX column's and the port's own
    on the card (PARITY_TORCH.json's, from the whole protocol), and NCF +
    BPR's NDCG@10 within the JAX column's range.  ``--phases parity`` runs the
    whole protocol (5 seeds, 4 for NCF + BPR) and writes PARITY_TORCH.json
    into ``--out``, the CPU columns of the repository's copy kept.
26. The dense optimizer's multi-tensor Adam (``csrc/adam.cu``, after phase
    8): on the dense parameter lists of the benchmark's DeepFM and xDeepFM
    (26 fields, E = 10), 100 steps of a quadratic loss under torch's
    capturable single-tensor Adam, the port's Adam eager and the port's
    Adam replayed in a CUDA graph, and AdamW with a parameter that never
    has a gradient: losses, p, m, v and counts held (``ADAM_ULPS``), the
    eager and replayed kernels to the bit; sizes off the 4-element unit,
    tensors off the 16-byte boundary, 130 tensors (three launches) and a
    tensor past 2^31 elements against torch's step to the bit (the
    ``ADAM_EDGE_*``, ``ADAM_HUGE`` constants); two launches a step; the kernel
    timed warm, cold and in a graph beside its bound (28 bytes an element),
    the per-op path and torch's ``fused=True`` Adam (a yardstick the port
    never calls); ``adam_update.launches`` counted through a DeepFM fit.
    ``--phases adam`` runs it alone.
27. DLRM-DCNv2's multi-hot input (``--phases dlrm`` only; the four-card
    part needs four cards, and ``--phases dlrm_mesh`` runs it alone): the
    pooled gather
    (``pooled_row_gather_kernel``, ``csrc/embedding.cu``) against its twin
    to the bit on a shard of 17M rows of 128 floats (element offsets past
    2^31) serving its own rows with ids spilling past both ends, int32 and
    int64 ids, a width of 10 and a table off the 16-byte boundary; two
    planted faults (the served range off by one, a bag's last slot
    dropped) that the comparison must refuse; the kernel timed warm, cold
    and in a graph at rank 0's shape of the bench cell beside its bound, its
    twin and ``F.embedding_bag`` (a yardstick).  On four cards over NCCL:
    the bench model over fields capped at 1M rows, a graphed fit at K = 2
    against eager steps from the same seed, every rank's state to the bit
    (``--dlrm-rank``), and on each side the launches of the pooled gather
    (one a forward step outside a replay) and of the cross's combine
    kernels (3 forward and 3 backward a step); then the bench cell's
    compared steps at published widths (``h100_bench``'s mesh run) held to
    the plain reference by the cell's limits.
28. The low-rank cross's combine kernels (``csrc/cross.cu``, after phase
    26): each of the layer's routes (float32 ``x0`` with a bf16 product and
    bias, float32 throughout, bf16 throughout), as a first, a middle and a
    last layer, at the bench DLRM cell's shape (16,384 x 3,456) and four odd
    shapes (``CROSS_ODD``), the kernels against their twins: the forward,
    dx0, dx and dy to the bit, the bias gradient within its reordered sum's
    bound; three planted faults (the bias add dropped, the copy's gradient
    ignored, the later layers' gradient of x0 ignored) that the comparison
    must refuse; the cell's cross (3 layers at rank 512, bf16 products)
    against the composition of ATen's ops it replaced: the forward to the
    bit, the gradients within ``CROSS_X0_TOL`` and ``CROSS_PARAM_TOL``, a
    CUDA-graph replay against eager steps to the bit, 3 + 3 launches; the
    cross's forward and backward in a graph, both ways, split into GEMMs and
    the rest; the two kernels warm, cold and in a graph beside their bounds.
    ``--phases cross`` runs it alone.
29. The CIN's kernels (``csrc/cin.cu``, after phase 28): the forward and
    both backward kernels against their plain versions (the composition the
    port ran before, and autograd's backward through it) at the benchmark
    xDeepFM cell's layer shapes (B 4096, N 26, E 10, O 200; H 26 with xk =
    x0, H 100 strided) and the odd shapes (``CIN_ODD``), each output within
    the bound of its float32 sum reordered (``CIN_UNIT``), which a 1% error
    exceeds, each kernel run twice to the same bits; a graphed xDeepFM fit's
    launches (3 forward and 3 backward a step it ran eagerly or captured)
    and one replay's kernels by name (3 of each CIN kernel a step, no
    float32 library GEMM), a replay against eager steps to the bit; the
    middle layer's calls warm, cold and in a graph, each kernel beside its
    FFMA bound and the composition it replaced.  ``--phases cin`` runs it
    alone.

The held steps (phases 15-23) hold each kept tensor's change over the step:
2 ulps of the value and 1e-3 of the tensor's largest change, where a table
element's rule is Adam's the larger of that and its update's sensitivity
to the summation order of its gradient (``adam_sensitivity``).

Every path is driven with all launch counts set to 0 just before it and
read just after.  ``--profile`` traces 3 steps of each training route and
prints each kernel's device time in the step.  The second-to-last lines are
a JSON object of the kernels exercised and the card's name and power limit;
the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--auto-sweep`` runs phase 1 and then only the sweep behind the automatic
dense/sparse choice (``train/trainer.py``): the dense route against the
presorted and the on-device sparse routes at 10 table sizes from 62.5k to
16M logical rows (E = 16, the bench's field proportions, batch 4096, bf16
tower), each at 8 steps a dispatch and at 1, printing examples/sec and the
size from which each sparse route beats the dense one.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import itertools
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np

# The main-path workload, as bench.py builds it (bench.py:43-71).
BATCH = 4096
EMBED = 16
FIELD_SIZES = tuple(
    [10_000_000, 5_000_000, 4_000_000, 3_000_000, 2_000_000, 2_000_000]
    + [1_000_000] * 6 + [200_000] * 4 + [20_000] * 4 + [1_000] * 4 + [100] * 4
)
NUM_DENSE = 13
TOWER = (400, 400, 400)
# Phase 7: E=128 packs one logical row per stored row.  28 fields of 32.9M
# rows at E=128 would need 50 GB before the copied state, so each field is
# capped at 1M rows (12,884,400 rows); the cap is the only cut.
EMBED_WIDE = 128
ROWS_CAP = 1_000_000
# FiBiNET's Criteo embedding (phase 17; Huang et al., RecSys 2019): 8 rows of
# 10 floats a stored row of 80
FIBINET_EMBED = 10
PACK1_STEPS = 5
EVAL_BATCHES = 8

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SEGSUM_ATOL = 1e-5   # g is drawn on a 2^-10 grid: every partial sum is exact
UPDATE_ATOL = 1e-6
TRAIN_LOSS_RTOL = 1e-5
TRAIN_ROWS_ATOL = 1e-6
# Dense route, kernels vs plain versions over 3 steps: the forward gathers
# are bit-identical, and the kernels' backward gives the same bits from run
# to run (phase 6 holds two runs to the bit), but the plain twin of its
# per-row sum is index_add_, which on the card sums duplicate ids with
# atomics in an order that changes from run to run, so the two table
# gradients differ in their last bits where an id occurs 3 or more times.
# Adam turns a gradient difference dg into a step difference of at most
# lr * (1 - b1) / (1 - b1^t) * dg / eps, about 1e-8 for the rounding of
# sums of 1e-5-sized cotangents; 1e-6 (1e-3 of lr) leaves a wide margin.
DENSE_LOSS_RTOL = 1e-5
DENSE_TABLE_ATOL = 1e-6
COMPARE_STEPS = 3
DEVICE = "cuda"
# (source, macros): the port's two libraries, and the row gather's sweep
# build (other chunks and reads in flight, for phase 2's [gather-config])
SWEEP_BUILD = ("embedding.cu", ("TRS_ROW_GATHER_SWEEP",))
BUILDS = (("sparse_update.cu", ()), ("embedding.cu", ()), SWEEP_BUILD, ("adam.cu", ()),
          ("cross.cu", ()), ("cin.cu", ()))


def make_batches(seed: int, n_batches: int, field_sizes=None):
    """Host batches exactly as ``bench.py:59-71`` makes them (ids capped at
    each field's size; ``field_sizes`` defaults to the bench's)."""
    field_sizes = FIELD_SIZES if field_sizes is None else field_sizes
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        b = {}
        for i, v in enumerate(field_sizes):
            raw = rng.zipf(1.2, size=BATCH)
            b[f"cat_{i}"] = np.minimum(raw - 1, v - 1).astype(np.int32)
        for j in range(NUM_DENSE):
            b[f"dense_{j}"] = rng.normal(size=BATCH).astype(np.float32)
        b["label"] = (rng.uniform(size=BATCH) < 0.5).astype(np.float32)
        batches.append(b)
    return batches


def log(*parts):
    print(*parts, flush=True)


PROFILE_LEAD_CYCLES = 100_000_000  # about 50 ms of the card's clock


@contextlib.contextmanager
def card_profile():
    """A torch.profiler window over the block, the card's events included.
    The profiler starts recording the card's events some milliseconds into
    its window and loses those before: a spin kernel, waited for, first puts
    the block's launches, copies and kernels after that
    (:func:`device_events` leaves it out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PROFILE_LEAD_CYCLES)
        torch.cuda.synchronize()
        yield prof


def device_events(prof):
    """The kernels and copies the card ran in a :func:`card_profile`
    window, its lead spin kernel left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Optimizer.", "ProfilerStep"))
            and "spin_kernel" not in e.name]


def device_ms(fn, iters: int, before=None) -> float:
    """Device ms per call of ``fn`` over ``iters`` calls: the sum of the
    durations of the kernels and copies the calls ran, from a torch.profiler
    window, the card's own time.  ``before``, where given, runs before each
    call, and its kernels are left out by name."""
    import torch

    skip = set()
    for _ in range(3 if before is not None else 0):  # as below: retried
        with card_profile() as prof:
            before()
            torch.cuda.synchronize()
        skip = {e.name for e in device_events(prof)}
        if skip:
            break
    if before is not None and not skip:
        raise AssertionError("torch.profiler recorded no kernel of the call before")
    for _ in range(3):  # a window now and then comes back without its kernels
        with card_profile() as prof:
            for _ in range(iters):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        events = [e for e in device_events(prof) if e.name not in skip]
        if len(events) >= iters:  # every call launches at least one kernel
            busy_us = sum(e.time_range.end - e.time_range.start for e in events)
            return busy_us / 1e3 / iters
    raise AssertionError(f"torch.profiler recorded {len(events)} kernels for {iters} calls")


def time_ms(fn, iters: int):
    """(device ms, event ms) per call of ``fn``, each over ``iters`` calls
    after 3 warm-up calls (:func:`device_ms`).  Event ms is CUDA events
    around back-to-back calls: for a kernel shorter than the host's work per
    call it measures the host's call rate instead."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return device_ms(fn, iters), start.elapsed_time(end) / iters


L2_FLUSH_BYTES = 256 << 20  # over five times the H100's 50 MB L2


def cold_time_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` with the L2 cache flushed before each
    call (a 256 MB buffer written between calls), after 3 warm-up calls."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=DEVICE)
    for _ in range(3):
        flush.fill_(1.0)
        fn()
    return device_ms(fn, iters, before=lambda: flush.fill_(1.0))


def times_text(label: str, t) -> str:
    return f"{label}={t[0]:.4f} (events {t[1]:.4f})"


def time_keys(prefix: str, t):
    """A record's keys for a (device ms, event ms) pair."""
    return {prefix: t[0], f"{prefix}_events": t[1]}


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the card's float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---- the kernels and their counters ----------------------------------------

KERNEL_NAMES = ("widen_segment_sum", "fused_rowwise_update", "row_gather", "segment_sum_wide",
                "unique_stored_gather", "fused_sorted_dedup_update")


def _kernel_module(name: str):
    from torecsys_tpu_torch.ops.kernels import embedding as KE
    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    return KE if name in ("row_gather", "unique_stored_gather") else K


def expect(**counts):
    """Expected launches of every kernel: those named, 0 for the others."""
    return {name: counts.get(name, 0) for name in KERNEL_NAMES}


def kernels():
    """The kernel wrappers as the port's modules hold them now."""
    return {name: getattr(_kernel_module(name), name) for name in KERNEL_NAMES}


def reset_counts(fns) -> None:
    for fn in fns.values():
        fn.launches = 0


def read_counts(fns):
    return {name: fn.launches for name, fn in fns.items()}


@contextlib.contextmanager
def plain_versions(fns):
    """Put every kernel's plain version in its wrapper's place."""
    for name in fns:
        mod = _kernel_module(name)
        setattr(mod, name, getattr(mod, f"{name}_plain"))
    try:
        yield
    finally:
        for name, fn in fns.items():
            setattr(_kernel_module(name), name, fn)


@contextlib.contextmanager
def fused_dedup(flag: str):
    """Set ``TORECSYS_TPU_FUSED_DEDUP`` in this process for the block."""
    from torecsys_tpu_torch.ops.sparse import FUSED_DEDUP_ENV

    before = os.environ.get(FUSED_DEDUP_ENV)
    os.environ[FUSED_DEDUP_ENV] = flag
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(FUSED_DEDUP_ENV)
        else:
            os.environ[FUSED_DEDUP_ENV] = before


def check_counts(path: str, counts, want) -> None:
    log(f"[{path}] launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"{path}: kernel launches {counts}, expected {want}")


# ---- phase 1 ---------------------------------------------------------------

def phase_build():
    from torecsys_tpu_torch.ops import kernels as build

    from torecsys_tpu_torch.data import native

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(BUILDS) + 1) as pool:
        futures = {b: pool.submit(build.build, *b) for b in BUILDS}
        presort = pool.submit(native.presort_lib)
        results = {b: f.result() for b, f in futures.items()}
        if presort.result() is None:
            raise AssertionError("the C++ presort did not build (g++ on the card's host)")
    log(f"[build] {len(BUILDS)} nvcc builds and the g++ presort in parallel in "
        f"{time.perf_counter() - t0:.2f} s; presort -> {native.library_path().name}")
    for (src, defines), (path, report) in results.items():
        log(f"[build] {src} {' '.join('-D' + d for d in defines)} -> {path.name}")
        kernel = ""
        for line in report.splitlines():
            if "Function properties for" in line:
                kernel = demangle(line.split("Function properties for")[-1].strip())
            elif "registers" in line or "spill" in line:
                log(f"[build] {kernel}: {line.strip()}")


def demangle(name: str) -> str:
    """A kernel's C++ name without its parameters (``c++filt``), its mangled
    name where that tool is missing."""
    try:
        out = subprocess.run(["c++filt", name], capture_output=True, text=True, timeout=10)
    except OSError:
        return name
    return out.stdout.replace("(anonymous namespace)::", "").split("(")[0].strip() or name


# ---- phase 2 ---------------------------------------------------------------

def bench_spec(pack: int):
    """The presort spec of the bench's fused id stream at ``pack``."""
    from torecsys_tpu_torch.data.presort import PresortSpec
    from torecsys_tpu_torch.ops.embedding import field_offsets, packed_shape

    fields = tuple(f"cat_{i}" for i in range(len(FIELD_SIZES)))
    vp, _ = packed_shape(sum(FIELD_SIZES), EMBED, pack)
    return PresortSpec(fields, tuple(int(o) for o in field_offsets(FIELD_SIZES)), pack, vp,
                       sum(FIELD_SIZES))


def presorted_stream(batch, pack: int):
    """Presort one batch's fused id stream with the port's Presorter; returns
    (spec, aux dict of numpy arrays)."""
    from torecsys_tpu_torch.data.presort import AUX_NAMES, Presorter

    spec = bench_spec(pack)
    out = Presorter([spec])(batch)
    return spec, {n: out[spec.aux_key(n)] for n in AUX_NAMES}


def grid_randn(shape, gen, dev):
    """Random values on a 2^-10 grid: every partial sum of a segment is exact
    in float32, so a kernel and its plain version must agree to the bit
    whatever order they sum in."""
    import torch

    return torch.randn(*shape, device=dev, generator=gen).mul_(1024).round_().div_(1024)


def phase_kernels(batch, seed: int):
    import torch

    from torecsys_tpu_torch.ops.embedding import field_offsets, packed_shape
    from torecsys_tpu_torch.ops.kernels import embedding as KE
    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = BATCH * len(FIELD_SIZES)
    g = grid_randn((m, EMBED), gen, dev)
    records = {}

    # -- widened segment-sum, pack 8 (main path) and pack 1 --
    seg_err = 0.0
    bench_streams = {}
    for pack in (8, 1):
        spec, aux = presorted_stream(batch, pack)
        order = torch.from_numpy(aux["order"]).to(dev)
        lo = torch.from_numpy(aux["lo"]).to(dev)
        seg = torch.from_numpy(aux["seg"]).to(dev)
        g_sorted = g.index_select(0, order)
        got = K.widen_segment_sum(g_sorted, lo, seg, pack)
        ref = K.widen_segment_sum_plain(g_sorted, lo, seg, pack)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        n_unique = int(aux["n_unique"][0])
        longest = int(np.bincount(aux["seg"]).max())
        log(f"[segsum] pack={pack} M={m} n_unique={n_unique} longest segment={longest} "
            f"max_abs_err={err:.3g} (atol {SEGSUM_ATOL})")
        if not err <= SEGSUM_ATOL:
            raise AssertionError(f"widen_segment_sum pack={pack} disagrees: {err}")
        seg_err = max(seg_err, err)
        bench_streams[pack] = (lo, seg)
        if pack == 1:
            records["segment_sum_wide"] = check_segment_sum_wide(seg, n_unique, longest,
                                                                 gen, dev)
            continue
        w = pack * EMBED
        kernel_t = time_ms(lambda: K.widen_segment_sum(g_sorted, lo, seg, pack), 50)
        cold = cold_time_ms(lambda: K.widen_segment_sum(g_sorted, lo, seg, pack), COLD_ITERS)
        plain_t = time_ms(lambda: K.widen_segment_sum_plain(g_sorted, lo, seg, pack), 20)
        wide = torch.zeros(m, pack, EMBED, device=dev)
        wide[torch.arange(m, device=dev), lo.long()] = g_sorted
        wide = wide.reshape(m, w)
        seg64 = seg.long()
        library_t = time_ms(
            lambda: torch.zeros(m, w, device=dev).index_add_(0, seg64, wide), 50)
        bound_ms, bound_by = bound(m * EMBED * 4 + 2 * m * 4 + m * w * 4, m * EMBED)
        log(f"[segsum] {times_text('kernel_ms', kernel_t)} cold_ms={cold:.4f} "
            f"{times_text('plain_ms', plain_t)} "
            f"{times_text('library_ms', library_t)} (torch.zeros(M,W).index_add_ on a "
            f"pre-widened stream, a near-yardstick) bound_us={bound_ms * 1e3:.2f} "
            f"({bound_by}) n_unique={n_unique}")
        records["widen_segment_sum"] = dict(
            name="widen_segment_sum", route="cuda",
            source="torecsys_tpu_torch/csrc/sparse_update.cu",
            replaces="torecsys_tpu/ops/pallas/sparse_update.py:248",
            max_abs_err=seg_err, **time_keys("ms", kernel_t), cold_ms=cold,
            **time_keys("plain_ms", plain_t), bound_ms=bound_ms, bound_by=bound_by,
            **time_keys("library_ms", library_t))
        gsum, uids = got, torch.from_numpy(aux["uids"]).to(dev)
        n_valid = n_unique
        del wide, seg64
    records["widen_segment_sum"]["max_abs_err"] = seg_err
    # ESMM's E = 18 packs P = 4: the bench ids' stream at that pack, for the
    # sweeps' scalar instantiation at W = 72
    _, aux4 = presorted_stream(batch, 4)
    bench_streams[4] = tuple(torch.from_numpy(aux4[n]).to(dev) for n in ("lo", "seg"))
    sweep = sweep_segment_sums(bench_streams, gen, dev)
    for name, by_stream in sweep.items():
        records[name]["sweep"] = by_stream

    # -- fused row-wise update, each rule, on a full-size table --
    rows, w = packed_shape(sum(FIELD_SIZES), EMBED)
    table0 = torch.empty(rows, w, device=dev).normal_(0.0, 0.01, generator=gen)
    touched = torch.zeros(rows, dtype=torch.bool, device=dev)
    touched[uids[:n_valid].long()] = True
    cases = [("adam", 0.0), ("adam", 1e-2), ("adagrad", 0.0), ("sgd", 0.0)]
    upd_err = 0.0
    for rule, wd in cases:
        slots0, hyper = rule_state(rule, wd, rows, w, gen, dev)
        tk, sk = table0.clone(), [s.clone() for s in slots0]
        tp, sp = table0.clone(), [s.clone() for s in slots0]
        K.fused_rowwise_update(uids, gsum, tk, sk, hyper, rule, n_valid)
        K.fused_rowwise_update_plain(uids, gsum, tp, sp, hyper, rule, n_valid)
        torch.cuda.synchronize()
        err = 0.0
        for got, ref, orig in [(tk, tp, table0)] + list(zip(sk, sp, slots0)):
            err = max(err, (got - ref).abs().max().item())
            changed = (got != orig).reshape(rows, -1).any(dim=1)
            if bool((changed & ~touched).any()):
                raise AssertionError(f"fused_rowwise_update {rule}: an untouched row changed")
        log(f"[update] rule={rule} wd={wd} n_valid={n_valid} max_abs_err={err:.3g} "
            f"(atol {UPDATE_ATOL}); untouched rows bit-identical")
        if not err <= UPDATE_ATOL:
            raise AssertionError(f"fused_rowwise_update {rule} disagrees: {err}")
        upd_err = max(upd_err, err)
        if rule == "adam" and wd == 0.0:
            kernel_t = time_ms(
                lambda: K.fused_rowwise_update(uids, gsum, tk, sk, hyper, rule, n_valid), 50)
            cold = cold_time_ms(
                lambda: K.fused_rowwise_update(uids, gsum, tk, sk, hyper, rule, n_valid),
                COLD_ITERS)
            plain_t = time_ms(
                lambda: K.fused_rowwise_update_plain(uids, gsum, tp, sp, hyper, rule, n_valid),
                20)
            # per touched row: read uid, gsum, table and m||v; write table and m||v
            n_bytes = n_valid * (4 + w * 4 + 2 * (w * 4 + 2 * w * 4))
            bound_ms, bound_by = bound(n_bytes, n_valid * w * 14)
            log(f"[update] {times_text('kernel_ms', kernel_t)} cold_ms={cold:.4f} "
                f"{times_text('plain_ms', plain_t)} "
                f"library_ms=null (no single PyTorch call computes a row-wise Adam "
                f"update) bound_us={bound_ms * 1e3:.2f} ({bound_by}) n_unique={n_valid}")
            records["fused_rowwise_update"] = dict(
                name="fused_rowwise_update", route="cuda",
                source="torecsys_tpu_torch/csrc/sparse_update.cu",
                replaces="torecsys_tpu/ops/pallas/sparse_update.py:50",
                **time_keys("ms", kernel_t), cold_ms=cold, **time_keys("plain_ms", plain_t),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        del tk, sk, tp, sp, slots0
    records["fused_rowwise_update"]["max_abs_err"] = upd_err
    del touched, gsum

    ids = np.stack([batch[f"cat_{i}"] for i in range(len(FIELD_SIZES))], axis=1)
    shifted = torch.from_numpy((ids.astype(np.int64) + field_offsets(FIELD_SIZES)).reshape(-1))
    shifted = shifted.to(dev)
    records["fused_sorted_dedup_update"] = check_fused_dedup(shifted, table0, gen, dev)
    combine_ms = records["widen_segment_sum"]["ms"] + records["fused_rowwise_update"]["ms"]
    log(f"[dedup] adam kernel_ms={records['fused_sorted_dedup_update']['ms']:.4f} against "
        f"widen_segment_sum + fused_rowwise_update = {combine_ms:.4f} (the default "
        f"combine's two kernels, this run)")
    records["fused_sorted_dedup_update"]["sweep"] = sweep_fused_dedup(bench_streams, gen, dev)
    records["unique_stored_gather"] = check_unique_gather(shifted, table0)
    records["unique_stored_gather"]["sweep"] = sweep_unique_gather(shifted, table0)

    records["row_gather"] = check_row_gather(table0, shifted, gen)
    records["row_gather"]["bf16"] = check_row_gather_bf16(table0, shifted)
    records["row_gather"]["table_grad"] = check_table_grad(table0, shifted, gen)
    del table0, shifted
    torch.cuda.empty_cache()
    return records


def same_bits(a, b) -> bool:
    """Bit-identical float32 tensors (NaN rows included)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def gather_bound(src, idx):
    """(bound_ms, bound_by) of one row gather: each id read once, each
    distinct row (of the ids inside ``[-rows, rows)``, wrapped) read once,
    each output row written once."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    rows, width = src.shape
    row, valid = KE.wrap_ids(idx, rows)
    distinct = torch.unique(row[valid]).numel()
    num = idx.shape[0]
    return bound(num * idx.element_size() + distinct * width * 4 + num * width * 4, 0)


def gather_times(src, idx, gather=None, library=False):
    """Warm and cold device times of ``gather`` (``row_gather`` where None),
    and where asked the plain version's and ``index_select``'s."""
    from torecsys_tpu_torch.ops.kernels import embedding as KE

    gather = KE.row_gather if gather is None else gather
    out = {"ms": time_ms(lambda: gather(src, idx), 200),
           "cold_ms": cold_time_ms(lambda: gather(src, idx), COLD_ITERS)}
    if library:
        out["plain_ms"] = time_ms(lambda: KE.row_gather_plain(src, idx), 100)
        out["library_ms"] = time_ms(lambda: src.index_select(0, idx), 200)
    return out


def check_row_gather(table0, shifted, gen):
    """``row_gather`` at the main path's shapes, each result bit-identical to
    its plain version: the bench batch's shifted ids into the logical view
    (the lookup), their stored rows into the stored table, and the permute of
    an (M, E) grad stream into id order (int32 and int64 order); then the
    sweep of chunks and reads in flight on the bench lookup and the sweep of
    edge streams.  Returns the lookup's record with ``permute``, ``configs``
    and ``sweep``."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    dev = table0.device
    w = table0.shape[1]
    m = shifted.shape[0]
    logical = table0.view(-1, EMBED)
    grads = torch.randn(m, EMBED, device=dev, generator=gen)
    order = torch.sort(shifted.to(torch.int32), stable=True).indices
    cases = [("logical view", logical, shifted), ("stored rows", table0, shifted // (w // EMBED)),
             ("permute int64", grads, order), ("permute int32", grads, order.to(torch.int32))]
    record = None
    permute = {}
    for label, src, idx in cases:
        got, ref = KE.row_gather(src, idx), KE.row_gather_plain(src, idx)
        torch.cuda.synchronize()
        if not same_bits(got, ref):
            raise AssertionError(f"row_gather on the {label} is not bit-identical")
        t = gather_times(src, idx, library=True)
        bound_ms, bound_by = gather_bound(src, idx)
        log(f"[gather] {label} {tuple(src.shape)} num={idx.shape[0]} {idx.dtype}: bit-identical "
            f"to the plain version; kernel_ms={t['ms'][0]:.4f} (events {t['ms'][1]:.4f}) "
            f"cold_ms={t['cold_ms']:.4f} {times_text('plain_ms', t['plain_ms'])} "
            f"{times_text('library_ms', t['library_ms'])} (index_select on the same src) "
            f"bound_us={bound_ms * 1e3:.2f} ({bound_by}); cold {bound_ms / t['cold_ms']:.2f} "
            f"of the bound")
        keys = dict(**time_keys("ms", t["ms"]), cold_ms=t["cold_ms"],
                    **time_keys("plain_ms", t["plain_ms"]), bound_ms=bound_ms,
                    bound_by=bound_by, **time_keys("library_ms", t["library_ms"]))
        if label == "logical view":
            record = dict(name="row_gather", route="cuda",
                          source="torecsys_tpu_torch/csrc/embedding.cu",
                          replaces="torecsys_tpu/ops/pallas/embedding.py:40", max_abs_err=0.0,
                          **keys)
        elif label.startswith("permute"):
            permute[label.split()[1]] = keys
    record["permute"] = permute
    record["configs"] = sweep_gather_configs(logical, shifted)
    record["sweep"] = sweep_row_gather(logical, shifted, gen)
    del grads, order
    return record


def check_row_gather_bf16(table0, shifted):
    """``row_gather`` on the bench table stored in bf16 (the dense route's
    ``set_table_dtype("bfloat16")``): the lookup of the bench batch's ids in
    its logical view, bit-identical to the plain version, warm and cold
    beside its bound and ``index_select``'s time on the same table."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    logical = table0.to(torch.bfloat16).view(-1, EMBED)
    got, ref = KE.row_gather(logical, shifted), KE.row_gather_plain(logical, shifted)
    torch.cuda.synchronize()
    if not (got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                        ref.view(torch.int16))):
        raise AssertionError("row_gather on the bf16 table is not bit-identical")
    t = gather_times(logical, shifted, library=True)
    row, valid = KE.wrap_ids(shifted, logical.shape[0])
    distinct = torch.unique(row[valid]).numel()
    num = shifted.shape[0]
    bound_ms, bound_by = bound(num * 8 + distinct * EMBED * 2 + num * EMBED * 2, 0)
    log(f"[gather-bf16] logical view {tuple(logical.shape)} bf16, num={num} int64: "
        f"bit-identical to the plain version; {times_text('kernel_ms', t['ms'])} "
        f"cold_ms={t['cold_ms']:.4f} {times_text('plain_ms', t['plain_ms'])} "
        f"{times_text('library_ms', t['library_ms'])} (index_select on the bf16 table) "
        f"bound_us={bound_ms * 1e3:.2f} ({bound_by}); cold {bound_ms / t['cold_ms']:.2f} of "
        f"the bound")
    del logical, got, ref
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, **time_keys("ms", t["ms"]), cold_ms=t["cold_ms"],
                **time_keys("plain_ms", t["plain_ms"]), bound_ms=bound_ms, bound_by=bound_by,
                **time_keys("library_ms", t["library_ms"]))


# The row gather's (chunk, reads in flight) swept on the bench lookup, and
# the pair embedding.cu launches (kChunk, kInFlight)
GATHER_SWEEP = tuple((c, k) for c in (8, 16, 32) for k in (2, 4, 8))
GATHER_DEFAULT = (32, 4)


def sweep_gather(src, idx, chunk: int, in_flight: int):
    """The row gather at another chunk and reads in flight: the sweep build's
    ``trs_row_gather_sweep`` (float4 rows, int64 ids); no launch counted."""
    import ctypes

    import torch

    from torecsys_tpu_torch.ops import kernels as K

    lib = K.load_library(*SWEEP_BUILD)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.trs_row_gather_sweep.argtypes = [p, p, p, i64, i64, i, i, i, p]
    lib.trs_row_gather_sweep.restype = i
    out = torch.empty(idx.shape[0], src.shape[1], dtype=torch.float32, device=src.device)
    status = lib.trs_row_gather_sweep(K.ptr(src), K.ptr(idx), K.ptr(out), idx.shape[0],
                                      src.shape[0], src.shape[1], chunk, in_flight,
                                      K.current_stream(src.device))
    K.check_status(status, "row_gather sweep")
    return out


def sweep_gather_configs(logical, shifted):
    """The row gather at chunks of 8, 16 and 32 ids a warp and 2, 4 and 8
    reads in flight a lane on the bench lookup: each bit-identical to the
    plain version, warm and cold device times; prints the fastest cold."""
    import functools

    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    assert shifted.dtype == torch.int64
    ref = KE.row_gather_plain(logical, shifted)
    bound_ms, _ = gather_bound(logical, shifted)
    results = {}
    for chunk, in_flight in GATHER_SWEEP:
        gather = functools.partial(sweep_gather, chunk=chunk, in_flight=in_flight)
        if not same_bits(gather(logical, shifted), ref):
            raise AssertionError(f"row_gather chunk {chunk} x {in_flight}: not bit-identical")
        t = gather_times(logical, shifted, gather)
        label = f"{chunk}x{in_flight}"
        default = " (the one row_gather launches)" if (chunk, in_flight) == GATHER_DEFAULT else ""
        log(f"[gather-config] {label}: chunk {chunk} ids, {in_flight} reads in flight a "
            f"lane{default}: bit-identical; {times_text('kernel_ms', t['ms'])} "
            f"cold_ms={t['cold_ms']:.4f} ({bound_ms / t['cold_ms']:.2f} of the "
            f"{bound_ms * 1e3:.2f} us bound)")
        results[label] = {**time_keys("ms", t["ms"]), "cold_ms": t["cold_ms"]}
    best = min(results, key=lambda k: results[k]["cold_ms"])
    log(f"[gather-config] fastest cold: {best} ({results[best]['cold_ms']:.4f} ms); row_gather "
        f"launches {GATHER_DEFAULT[0]}x{GATHER_DEFAULT[1]}")
    return results


def sweep_row_gather(logical, shifted, gen):
    """``row_gather`` on edge streams, each bit-identical to its plain version
    (int64 and int32 ids) and timed warm and cold beside its bound: M distinct
    ids, one id M times, M in {1, 31, 32, 33, 255, 256, 257} (chunk edges),
    negative ids and ids past the table (NaN rows), width 13 (the 4-byte
    path) and a src offset by one float (misaligned for 16-byte vectors)."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    dev = logical.device
    rows = logical.shape[0]
    m = shifted.shape[0]

    def ids(n):
        return torch.randint(0, rows, (n,), device=dev, generator=gen)

    spread = torch.arange(m, device=dev) * (rows // m)
    past = torch.randint(-2 * rows, 2 * rows, (m,), device=dev, generator=gen)
    narrow = torch.randn(1 << 20, 13, device=dev, generator=gen)
    flat = torch.randn((1 << 20) * EMBED + 1, device=dev, generator=gen)
    streams = {"distinct": (logical, spread), "one id": (logical, torch.full_like(shifted, 7)),
               **{f"M={n}": (logical, ids(n)) for n in (1, 31, 32, 33, 255, 256, 257)},
               "NaN rows": (logical, past),
               "width 13": (narrow, torch.randint(0, narrow.shape[0], (m,), device=dev,
                                                  generator=gen)),
               "offset pointer": (flat[1:].view(-1, EMBED),
                                  torch.randint(0, 1 << 20, (m,), device=dev, generator=gen))}
    results = {}
    for label, (src, idx) in streams.items():
        for index in (idx, idx.to(torch.int32)):
            if not same_bits(KE.row_gather(src, index), KE.row_gather_plain(src, index)):
                raise AssertionError(f"row_gather sweep {label} {index.dtype}: not bit-identical")
        t = gather_times(src, idx)
        bound_ms, _ = gather_bound(src, idx)
        log(f"[sweep] row_gather {label}: src {tuple(src.shape)} num={idx.shape[0]}; int64 and "
            f"int32 ids bit-identical to the plain version; {times_text('kernel_ms', t['ms'])} "
            f"cold_ms={t['cold_ms']:.4f} bound_us={bound_ms * 1e3:.3f}")
        results[label] = {"num": idx.shape[0], "bound_ms": bound_ms,
                          **time_keys("ms", t["ms"]), "cold_ms": t["cold_ms"]}
    return results


def index_add_table_grad(ids, grad, table_shape):
    """The lookup's backward before: one ``index_add_`` of the wrapped ids
    into a zero logical view (atomics on the card)."""
    from torecsys_tpu_torch.ops.kernels import embedding as KE

    vp, w = table_shape
    rows = vp * (w // grad.shape[1])
    row, valid = KE.wrap_ids(ids, rows)
    grad = grad.masked_fill(~valid[:, None], 0.0)
    return grad.new_zeros(rows, grad.shape[1]).index_add_(0, row, grad).reshape(vp, w)


def check_table_grad(table0, shifted, gen):
    """The lookup's backward (``table_grad``: zero fill, sort, permute, fused
    dedup) at the dense route's shapes: bit-identical to the ``index_add_``
    form on grid cotangents (every partial sum exact), two calls
    bit-identical on real-valued ones; device time of each form (the zero
    fill of the 2.1 GB table included in both)."""
    import torch

    from torecsys_tpu_torch.ops.embedding import table_grad

    shape = table0.shape
    grid = grid_randn((shifted.shape[0], EMBED), gen, table0.device)
    if not torch.equal(table_grad(shifted, grid, shape), index_add_table_grad(shifted, grid, shape)):
        raise AssertionError("table_grad differs from index_add_ on grid cotangents")
    real = torch.randn(shifted.shape[0], EMBED, device=table0.device, generator=gen)
    if not torch.equal(table_grad(shifted, real, shape), table_grad(shifted, real, shape)):
        raise AssertionError("table_grad: two calls differ")
    t = time_ms(lambda: table_grad(shifted, real, shape), 10)
    parent = time_ms(lambda: index_add_table_grad(shifted, real, shape), 10)
    log(f"[table-grad] lookup backward at {tuple(shape)}, M={shifted.shape[0]}: bit-identical to "
        f"index_add_ on grid cotangents, two calls bit-identical; sort + permute + dedup + zero "
        f"fill {times_text('device_ms', t)} vs the index_add_ form "
        f"{times_text('device_ms', parent)}")
    torch.cuda.empty_cache()
    return {**time_keys("ms", t), **time_keys("index_add_ms", parent)}


def rule_state(rule: str, wd: float, rows: int, w: int, gen, dev):
    """Random slots of ``rule`` for a (rows, w) table, and its hyper vector
    (bias correction of step 11)."""
    import torch

    t = 11
    if rule == "adam":
        slot0 = torch.empty(rows, 2, w, device=dev)
        slot0[:, 0].normal_(0.0, 1e-3, generator=gen)
        slot0[:, 1].uniform_(0.0, 1e-5, generator=gen)
        hyper = [1e-3, 0.9, 0.999, 1e-8, wd, 1.0 / (1.0 - 0.9 ** t), 1.0 / (1.0 - 0.999 ** t)]
        return [slot0], torch.tensor(hyper, dtype=torch.float32, device=dev)
    if rule == "adagrad":
        slots0 = [torch.empty(rows, w, device=dev).uniform_(0.1, 1.0, generator=gen)]
        return slots0, torch.tensor([1e-3, 0, 0, 1e-7, 0, 1, 1], dtype=torch.float32, device=dev)
    return [], torch.tensor([1e-3, 0, 0, 0, 0, 1, 1], dtype=torch.float32, device=dev)


def check_fused_dedup(shifted, table0, gen, dev):
    """fused_sorted_dedup_update on the bench batch's ids, sorted on the card
    as the on-device route sorts them, with grid grads: each rule from one
    copied table and slot state, against its plain version."""
    import torch

    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    rows, w = table0.shape
    pack = w // EMBED
    sorted_ids, _ = torch.sort(shifted.to(torch.int32), stable=True)
    m = sorted_ids.shape[0]
    g_sorted = grid_randn((m, EMBED), gen, dev)
    stored = torch.unique(sorted_ids // pack).long()
    n_stored = stored.numel()
    touched = torch.zeros(rows, dtype=torch.bool, device=dev)
    touched[stored] = True
    err_all, record = 0.0, None
    for rule in ("adam", "adagrad", "sgd"):
        slots0, hyper = rule_state(rule, 0.0, rows, w, gen, dev)
        tk, sk = table0.clone(), [s.clone() for s in slots0]
        tp, sp = table0.clone(), [s.clone() for s in slots0]
        K.fused_sorted_dedup_update(sorted_ids, g_sorted, tk, sk, hyper, pack, rule)
        K.fused_sorted_dedup_update_plain(sorted_ids, g_sorted, tp, sp, hyper, pack, rule)
        torch.cuda.synchronize()
        err = 0.0
        for got, ref, orig in [(tk, tp, table0)] + list(zip(sk, sp, slots0)):
            err = max(err, (got - ref).abs().max().item())
            changed = (got != orig).reshape(rows, -1).any(dim=1)
            if bool((changed & ~touched).any()):
                raise AssertionError(f"fused_sorted_dedup_update {rule}: an untouched row changed")
        log(f"[dedup] rule={rule} M={m} stored rows={n_stored} max_abs_err={err:.3g} "
            f"(atol {UPDATE_ATOL}); untouched rows bit-identical")
        if not err <= UPDATE_ATOL:
            raise AssertionError(f"fused_sorted_dedup_update {rule} disagrees: {err}")
        err_all = max(err_all, err)
        if rule == "adam":
            kernel_t = time_ms(lambda: K.fused_sorted_dedup_update(
                sorted_ids, g_sorted, tk, sk, hyper, pack, rule), 50)
            cold = cold_time_ms(lambda: K.fused_sorted_dedup_update(
                sorted_ids, g_sorted, tk, sk, hyper, pack, rule), COLD_ITERS)
            plain_t = time_ms(lambda: K.fused_sorted_dedup_update_plain(
                sorted_ids, g_sorted, tp, sp, hyper, pack, rule), 20)
            # read the sorted ids and narrow grads once; read and write each
            # touched stored row and its m||v once; ~14 float operations per
            # updated element
            bound_ms, bound_by = bound(
                m * 4 + m * EMBED * 4 + n_stored * 2 * (w * 4 + 2 * w * 4), n_stored * w * 14)
            longest = int(torch.unique_consecutive(sorted_ids // pack,
                                                   return_counts=True)[1].max())
            log(f"[dedup] {times_text('kernel_ms', kernel_t)} cold_ms={cold:.4f} "
                f"{times_text('plain_ms', plain_t)} library_ms=null "
                f"(no single PyTorch call dedups and updates) bound_us={bound_ms * 1e3:.3f} "
                f"({bound_by}) longest stored-row group={longest}")
            record = dict(name="fused_sorted_dedup_update", route="cuda",
                          source="torecsys_tpu_torch/csrc/sparse_update.cu",
                          replaces="torecsys_tpu/ops/pallas/sparse_update.py:561",
                          **time_keys("ms", kernel_t), cold_ms=cold,
                          **time_keys("plain_ms", plain_t),
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        del tk, sk, tp, sp, slots0
    record["max_abs_err"] = err_all
    return record


def check_unique_gather(shifted, table0):
    """unique_stored_gather on the bench batch's unique ids (``torch.unique``,
    sorted, padded with the sentinel): the valid prefix must be
    bit-identical to the plain version's."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    rows, w = table0.shape
    pack = w // EMBED
    m = shifted.shape[0]
    uniq = torch.unique(shifted.to(torch.int32), sorted=True)
    n = uniq.numel()
    uids = torch.full((m,), rows * pack, dtype=torch.int32, device=shifted.device)
    uids[:n] = uniq
    got = KE.unique_stored_gather(table0, uids, EMBED)
    ref = KE.unique_stored_gather_plain(table0, uids, EMBED)
    torch.cuda.synchronize()
    err = (got[:n] - ref[:n]).abs().max().item()
    if not torch.equal(got[:n], ref[:n]):
        raise AssertionError(f"unique_stored_gather is not bit-identical: {err}")
    kernel_t = time_ms(lambda: KE.unique_stored_gather(table0, uids, EMBED), 200)
    cold = cold_time_ms(lambda: KE.unique_stored_gather(table0, uids, EMBED), COLD_ITERS)
    plain_t = time_ms(lambda: KE.unique_stored_gather_plain(table0, uids, EMBED), 100)
    library_t = time_ms(lambda: table0.index_select(0, uids[:n] // pack), 200)
    n_stored = torch.unique(uniq // pack).numel()
    # read the valid ids and each distinct stored row once, write one stored
    # row per valid id
    bound_ms, bound_by = bound(n * 4 + n_stored * w * 4 + n * w * 4, 0)
    log(f"[unique-gather] M={m} valid ids={n} stored rows={n_stored} width={w}: valid prefix "
        f"bit-identical to the plain version; {times_text('kernel_ms', kernel_t)} "
        f"cold_ms={cold:.4f} {times_text('plain_ms', plain_t)} "
        f"{times_text('library_ms', library_t)} (table.index_select(0, "
        f"uids[:n] // P)) bound_us={bound_ms * 1e3:.3f} ({bound_by})")
    return dict(name="unique_stored_gather", route="cuda",
                source="torecsys_tpu_torch/csrc/embedding.cu",
                replaces="torecsys_tpu/ops/pallas/embedding.py:136",
                max_abs_err=err, **time_keys("ms", kernel_t), cold_ms=cold,
                **time_keys("plain_ms", plain_t),
                bound_ms=bound_ms, bound_by=bound_by, **time_keys("library_ms", library_t))


def check_segment_sum_wide(seg, n_unique: int, longest: int, gen, dev):
    """segment_sum_wide on the bench batch's pack-1 presorted segments with a
    W = 128 stream (the E = 128 route's width)."""
    import torch

    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    m, w = seg.shape[0], EMBED_WIDE
    wide = grid_randn((m, w), gen, dev)
    got = K.segment_sum_wide(wide, seg)
    ref = K.segment_sum_wide_plain(wide, seg)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not torch.equal(got, ref):
        raise AssertionError(f"segment_sum_wide is not bit-identical: {err}")
    seg64 = seg.long()
    kernel_t = time_ms(lambda: K.segment_sum_wide(wide, seg), 50)
    cold = cold_time_ms(lambda: K.segment_sum_wide(wide, seg), COLD_ITERS)
    plain_t = time_ms(lambda: K.segment_sum_wide_plain(wide, seg), 20)
    library_t = time_ms(lambda: torch.zeros(m, w, device=dev).index_add_(0, seg64, wide), 50)
    bound_ms, bound_by = bound(m * w * 4 + m * 4 + m * w * 4, m * w)
    log(f"[segsum-wide] M={m} W={w} n_unique={n_unique} longest segment={longest}: "
        f"bit-identical to the plain version; {times_text('kernel_ms', kernel_t)} "
        f"cold_ms={cold:.4f} {times_text('plain_ms', plain_t)} "
        f"{times_text('library_ms', library_t)} (torch.zeros(M,W).index_add_) "
        f"bound_us={bound_ms * 1e3:.2f} ({bound_by})")
    return dict(name="segment_sum_wide", route="cuda",
                source="torecsys_tpu_torch/csrc/sparse_update.cu",
                replaces="torecsys_tpu/ops/pallas/sparse_update.py:389",
                max_abs_err=err, **time_keys("ms", kernel_t), cold_ms=cold,
                **time_keys("plain_ms", plain_t),
                bound_ms=bound_ms, bound_by=bound_by, **time_keys("library_ms", library_t))


SWEEP_ITERS = 20
COLD_ITERS = 20


def sweep_streams(bench_seg):
    """The sweep's segment-id streams, int32 on the card, of the bench
    stream's length M (``M = 1`` apart): the bench stream; one segment over
    all M; M distinct segments; tile edges, where segments of T-1, T, T+1 and
    2T+1 positions each start on a warp-tile edge (T = SEGSUM_TILE) and of
    the same lengths in block tiles on a block-tile edge, fillers between;
    and M = 1."""
    import torch

    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    m, dev = bench_seg.shape[0], bench_seg.device
    t = K.SEGSUM_TILE
    bt = t * K.SEGSUM_WARPS
    edges = [t - 1, 1, t, t + 1, t - 1, 2 * t + 1, t - 1, t,
             bt - 1, 1, bt, bt + 1, bt - 1, 2 * bt + 1, bt - 1, bt]
    lens = np.tile(edges, -(-m // sum(edges)))
    tiled = np.repeat(np.arange(lens.size), lens)[:m].astype(np.int32)
    return {"bench": bench_seg,
            "one segment": torch.zeros(m, dtype=torch.int32, device=dev),
            "distinct": torch.arange(m, dtype=torch.int32, device=dev),
            "tile edges": torch.from_numpy(tiled).to(dev),
            "M=1": torch.zeros(1, dtype=torch.int32, device=dev)}


def sweep_segment_sums(bench_streams, gen, dev):
    """Both segment sums on every sweep stream (``widen_segment_sum`` at
    P = 8, E = 16 on the bench's pack-8 stream, at P = 8, E = 10, the
    FiBiNET width, and at P = 4, E = 18 on the pack-4 stream, ESMM's, whose
    rows of 10 and 18 floats take the kernel's scalar instantiation;
    ``segment_sum_wide`` at W = 128 on its pack-1 stream):
    grid grads bit-identical to the plain version; real-valued grads within
    (L_s - 1) * 2^-24 * sum|g| of a float64 sum over each segment of L_s
    positions; two launches bit-identical.  Returns each kernel's time and
    longest segment per stream (the E = 10 and E = 18 streams labelled so)."""
    import torch

    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    results = {"widen_segment_sum": {}, "segment_sum_wide": {}}
    for name, bench_pack, e in (("widen_segment_sum", 8, EMBED),
                                ("widen_segment_sum", 8, FIBINET_EMBED),
                                ("widen_segment_sum", 4, ESMM_EMBED),
                                ("segment_sum_wide", 1, EMBED_WIDE)):
        bench_lo, bench_seg = bench_streams[bench_pack]
        pack = bench_pack
        suffix = "" if e in (EMBED, EMBED_WIDE) else f" E={e}"
        for stream, seg in sweep_streams(bench_seg).items():
            label = stream + suffix
            m = seg.shape[0]
            if name == "widen_segment_sum":
                if stream == "bench":
                    lo = bench_lo
                else:  # slots ascending inside each stored row, as ids sort
                    ids = seg.long() * pack + torch.randint(0, pack, (m,), device=dev,
                                                            generator=gen)
                    lo = (torch.sort(ids).values % pack).to(torch.int32)
                kernel = lambda x: K.widen_segment_sum(x, lo, seg, pack)  # noqa: E731
                plain = lambda x: K.widen_segment_sum_plain(x, lo, seg, pack)  # noqa: E731
            else:
                kernel = lambda x: K.segment_sum_wide(x, seg)  # noqa: E731
                plain = lambda x: K.segment_sum_wide_plain(x, seg)  # noqa: E731
            width = e
            grid = grid_randn((m, width), gen, dev)
            if not torch.equal(kernel(grid), plain(grid)):
                raise AssertionError(f"{name} on the {label} stream: grid grads differ "
                                     f"from the plain version")
            real = torch.randn(m, width, device=dev, generator=gen)
            got = kernel(real)
            if not torch.equal(got, kernel(real)):
                raise AssertionError(f"{name} on the {label} stream: two launches differ")
            err = (got.double() - plain(real.double())).abs()
            lengths = torch.bincount(seg.long(), minlength=got.shape[0]).double()
            limit = (lengths - 1).clamp(min=0)[:, None] * 2.0**-24 * plain(real.abs().double())
            if not bool((err <= limit).all()):
                raise AssertionError(f"{name} on the {label} stream: real-valued grads "
                                     f"outside the float64 bound")
            share = float((err / limit.clamp(min=1e-300)).max())
            longest = int(lengths.max())
            t = time_ms(lambda: kernel(real), SWEEP_ITERS)
            log(f"[sweep] {name} {label}: M={m} longest segment={longest}; grid grads "
                f"bit-identical, two launches bit-identical, real-valued max err "
                f"{float(err.max()):.3g} = {share:.3g} of the float64 bound; "
                f"{times_text('kernel_ms', t)}")
            results[name][label] = {"M": m, "longest": longest, "err_share_of_bound": share,
                                    **time_keys("ms", t)}
        one, bench = (results[name][f"one segment{suffix}"]["ms"],
                      results[name][f"bench{suffix}"]["ms"])
        log(f"[sweep] {name}{suffix}: one segment over all M takes {one / bench:.3f}x the bench "
            f"stream's device time")
    return results


def dedup_sweep_ids(seg, lo, pack: int, label: str, dev):
    """A sweep stream of logical ids for ``fused_sorted_dedup_update``, and the
    table rows R it addresses: group s of ``seg`` becomes stored row 2s + 1
    (the even rows stay untouched) and ``lo`` its in-row slots.  "sentinel
    tail" takes the bench stream and turns its last M/4 positions into
    sentinel ids >= R*P, three to a logical id: groups of 3*P positions past
    the table, crossing tile edges."""
    import torch

    m = seg.shape[0]
    rows = 2 * m + 2
    ids = (2 * seg.long() + 1) * pack + lo.long()
    if label == "sentinel tail":
        tail = m // 4
        ids[m - tail:] = rows * pack + torch.arange(tail, device=dev) // 3
    return ids.to(torch.int32), rows


def sweep_fused_dedup(bench_streams, gen, dev):
    """``fused_sorted_dedup_update`` on every sweep stream of the segment sums
    and a sentinel tail, at P = 8, E = 16, at P = 8, E = 10 and P = 4, E = 18
    (FiBiNET's and ESMM's widths: the kernel's scalar instantiation) and at
    P = 1, W = 128, each rule from
    one copied state, on real-valued grads: table and slots bit-identical to
    the default combine (``_combine_sorted_stored``: the segment sum, then
    ``fused_rowwise_update`` with the device count); two launches
    bit-identical; untouched rows, and guard rows past R where the sentinel
    groups' rows would lie, unchanged.  Times adam on each stream beside the
    stream's own bound.  Returns {"P=<pack>": {stream: record}}."""
    import torch

    from torecsys_tpu_torch.ops.kernels import sparse_update as K
    from torecsys_tpu_torch.ops.sparse import _combine_sorted_stored

    results = {}
    for pack, e in ((8, EMBED), (8, FIBINET_EMBED), (4, ESMM_EMBED), (1, EMBED_WIDE)):
        key = f"P={pack}" if e in (EMBED, EMBED_WIDE) else f"P={pack} E={e}"
        bench_lo, bench_seg = bench_streams[pack]
        streams = sweep_streams(bench_seg)
        streams["sentinel tail"] = bench_seg
        by_stream = {}
        for label, seg in streams.items():
            m = seg.shape[0]
            if seg is bench_seg:
                lo = bench_lo
            else:  # slots ascending inside each stored row, as ids sort
                slots_of = torch.randint(0, pack, (m,), device=dev, generator=gen)
                lo = (torch.sort(seg.long() * pack + slots_of).values % pack).to(torch.int32)
            ids, rows = dedup_sweep_ids(seg, lo, pack, label, dev)
            w = pack * e
            guard = m // 4 + 8
            g = torch.randn(m, e, device=dev, generator=gen)
            hi = ids.long().div(pack, rounding_mode="floor")
            stored = torch.unique(hi[(hi >= 0) & (hi < rows)])
            touched = torch.zeros(rows + guard, dtype=torch.bool, device=dev)
            touched[stored] = True
            table0 = torch.empty(rows + guard, w, device=dev).normal_(0.0, 0.01, generator=gen)
            for rule in ("adam", "adagrad", "sgd"):
                slots0, hyper = rule_state(rule, 0.0, rows + guard, w, gen, dev)

                def run(fn):
                    t, sl = table0.clone(), [s.clone() for s in slots0]
                    fn(t[:rows], [s[:rows] for s in sl])
                    return [t] + sl

                def fused(t, sl):
                    K.fused_sorted_dedup_update(ids, g, t, sl, hyper, pack, rule)

                def combine(t, sl):
                    uids, gsum, n = _combine_sorted_stored(ids, g, pack, rows)
                    K.fused_rowwise_update(uids, gsum, t, sl, hyper, rule, n)

                got, again, ref = run(fused), run(fused), run(combine)
                where = f"fused_sorted_dedup_update P={pack} E={e} {label} {rule}"
                for a, b, c, orig in zip(got, again, ref, [table0] + slots0):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{where}: two launches differ")
                    if not torch.equal(a, c):
                        err = (a - c).abs().max().item()
                        raise AssertionError(f"{where}: differs from the default combine "
                                             f"by {err:.3g}")
                    changed = (a != orig).reshape(rows + guard, -1).any(dim=1)
                    if bool((changed & ~touched).any()):
                        raise AssertionError(f"{where}: an untouched or guard row changed")
                del got, again, ref, slots0
            slots0, hyper = rule_state("adam", 0.0, rows, w, gen, dev)
            t = table0[:rows].clone()
            t_ms = time_ms(lambda: K.fused_sorted_dedup_update(ids, g, t, slots0, hyper, pack,
                                                               "adam"), SWEEP_ITERS)
            n_stored = stored.numel()
            bound_ms, bound_by = bound(m * 4 + m * e * 4 + n_stored * 2 * (w * 4 + 2 * w * 4),
                                       n_stored * w * 14)
            longest = int(torch.unique_consecutive(hi, return_counts=True)[1].max())
            log(f"[sweep] fused_sorted_dedup_update P={pack} E={e} {label}: M={m} stored rows "
                f"in the table={n_stored} longest group={longest}; adam, adagrad, sgd: table "
                f"and slots bit-identical to the default combine, two launches "
                f"bit-identical, untouched and guard rows unchanged; adam "
                f"{times_text('kernel_ms', t_ms)} bound_us={bound_ms * 1e3:.3f} ({bound_by}), "
                f"{t_ms[0] / bound_ms:.2f}x the bound")
            by_stream[label] = {"M": m, "stored_rows": n_stored, "longest": longest,
                                "bound_ms": bound_ms, **time_keys("ms", t_ms)}
            del table0, slots0, t, g, touched
        one, bench = by_stream["one segment"]["ms"], by_stream["bench"]["ms"]
        log(f"[sweep] fused_sorted_dedup_update {key}: one stored row over all M takes "
            f"{one / bench:.3f}x the bench stream's device time")
        results[key] = by_stream
    torch.cuda.empty_cache()
    return results


def sweep_unique_gather(shifted, table0):
    """``unique_stored_gather`` on the bench batch's unique ids, on M ids all
    valid, on a single valid id and on a valid prefix that ends inside a
    block's share of ids: the valid prefix bit-identical to
    ``table.index_select(0, uids[:n] // P)``, each stream timed beside its
    bound."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    rows, w = table0.shape
    pack = w // EMBED
    m, dev = shifted.shape[0], shifted.device
    uniq = torch.unique(shifted.to(torch.int32), sorted=True)
    spread = torch.arange(m, device=dev, dtype=torch.int64) * (rows * pack // m)
    streams = {"bench": uniq, "all valid": spread.to(torch.int32), "single valid": uniq[:1],
               "prefix ends mid-block": uniq[:1013]}
    results = {}
    for label, valid in streams.items():
        n = valid.numel()
        uids = torch.full((m,), rows * pack, dtype=torch.int32, device=dev)
        uids[:n] = valid
        got = KE.unique_stored_gather(table0, uids, EMBED)
        ref = table0.index_select(0, uids[:n].long() // pack)
        if not torch.equal(got[:n], ref):
            raise AssertionError(f"unique_stored_gather {label}: the valid prefix differs "
                                 f"from index_select")
        t = time_ms(lambda: KE.unique_stored_gather(table0, uids, EMBED), 50)
        n_stored = torch.unique(valid.long() // pack).numel()
        bound_ms, _ = bound(n * 4 + n_stored * w * 4 + n * w * 4, 0)
        log(f"[sweep] unique_stored_gather {label}: M={m} valid ids={n} stored rows={n_stored}; "
            f"valid prefix bit-identical to index_select; {times_text('kernel_ms', t)} "
            f"bound_us={bound_ms * 1e3:.3f}, {t[0] / bound_ms:.2f}x the bound")
        results[label] = {"valid": n, "stored_rows": n_stored, "bound_ms": bound_ms,
                          **time_keys("ms", t)}
    return results


# ---- phases 3-7: the trainer's paths ----------------------------------------

# the models whose only input is their table
TABLE_ONLY_MODELS = ("DCN", "FiBiNET", "DeepFFM", "FATDeepFFM", "MMoE", "DeepMoE", "ESMM",
                     "ESM2")


def ctr_pipeline(model: str, model_kwargs, field_sizes=None, sparse=None, compute=None,
                 embed: int = EMBED, table: str = "emb_inputs", optimizer=("Adam", 1e-3),
                 criterion="BCEWithLogitsLoss"):
    """A CTR pipeline over the bench's fields: 13 dense values (but for the
    models whose only input is the table) and one table of the fields, fused
    (``emb_inputs``) or field-aware (``field_emb_inputs``), trained by the
    named ``optimizer`` (name, lr) under ``criterion`` (a registry name or a
    callable over the model's outputs and the label)."""
    from torecsys_tpu_torch import Inputs, Pipeline, ValueInput
    from torecsys_tpu_torch.inputs import MultiIndicesEmbedding, MultiIndicesFieldAwareEmbedding

    field_sizes = FIELD_SIZES if field_sizes is None else field_sizes
    cls = MultiIndicesFieldAwareEmbedding if table == "field_emb_inputs" else MultiIndicesEmbedding
    schema = {} if model in TABLE_ONLY_MODELS else {
        "feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(NUM_DENSE)))}
    schema[table] = cls(embed, field_sizes, tuple(f"cat_{i}" for i in range(len(field_sizes))),
                        device=DEVICE)
    name, lr = optimizer
    return (Pipeline(device=DEVICE).set_objective("ctr").set_inputs(Inputs(schema))
            .set_model(model, **model_kwargs).set_criterion(criterion)
            .set_optimizer(name, lr=lr).set_sparse_embeddings(sparse)
            .set_compute_dtype(compute).set_target_fields("label"))


def bench_pipeline(field_sizes=None, sparse=None, compute=None, embed: int = EMBED):
    """The bench DeepFM's pipeline (bench.py:81-95) as the port spells it;
    ``bench_pipeline(sparse=None, compute="bfloat16")`` is bench.py's
    headline configuration (bench.py:444-448)."""
    return ctr_pipeline("DeepFM", {"deep_layer_sizes": TOWER}, field_sizes, sparse, compute,
                        embed)


def build_trainer(seed: int, sparse=True, embed: int = EMBED, field_sizes=None,
                  presort=True, spe: int = 1, compute=None):
    from torecsys_tpu_torch import Trainer

    trainer = Trainer(bench_pipeline(field_sizes, sparse, compute, embed), log_every=10**9,
                      seed=seed, presort=presort, steps_per_execution=spe)
    trainer.init_state()
    return trainer


def release() -> None:
    """Hand the memory of a trainer the caller has deleted back to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _optimizers(trainer):
    """(dense torch optimizer, row-wise slots or {}) of either route."""
    opt = trainer.state.opt_state
    return (opt["dense"], opt["sparse"]) if isinstance(opt, dict) else (opt, {})


def snapshot(trainer):
    """Clones of the trainer's state: parameters, running statistics, the
    dense optimizer's ``state_dict()`` (any optimizer's), the row slots and
    the step and loss accumulators."""
    from torecsys_tpu_torch.train.state import batch_stats

    seq = trainer.pipeline.sequential
    dense_opt, slots = _optimizers(trainer)
    return {
        "params": {n: p.detach().clone() for n, p in seq.named_parameters()},
        "buffers": {n: b.clone() for n, b in batch_stats(seq).items()},
        "dense_opt": copy.deepcopy(dense_opt.state_dict()),
        "slots": {k: {n: v.clone() for n, v in s.items()} for k, s in slots.items()},
        "step": trainer.state.step.clone(),
        "loss_sum": trainer.state.loss_sum.clone(),
    }


def restore(trainer, snap):
    """Copy a snapshot back into the trainer's own tensors, in place (the
    running statistics too): a captured CUDA graph holds the parameters and
    the optimizer state by address (``load_state_dict`` would replace the
    optimizer's tensors and make the trainer capture again)."""
    import torch

    from torecsys_tpu_torch.train.state import batch_stats

    seq = trainer.pipeline.sequential
    dense_opt, slots = _optimizers(trainer)
    with torch.no_grad():
        for n, p in seq.named_parameters():
            p.copy_(snap["params"][n])
        for n, b in batch_stats(seq).items():
            b.copy_(snap["buffers"][n])
        for k, s in slots.items():
            for n, v in s.items():
                v.copy_(snap["slots"][k][n])
        trainer.state.step.copy_(snap["step"])
        trainer.state.loss_sum.copy_(snap["loss_sum"])
        live = dense_opt.state_dict()["state"]  # the optimizer's own tensors
        saved = snap["dense_opt"]["state"]
        if {i: set(s) for i, s in live.items()} != {i: set(s) for i, s in saved.items()}:
            dense_opt.load_state_dict(copy.deepcopy(snap["dense_opt"]))
            return
        for i, state in saved.items():
            for k, v in state.items():
                if isinstance(v, torch.Tensor):
                    live[i][k].copy_(v)
                else:
                    live[i][k] = v


def timed_steps(trainer, batches, fns, path: str):
    """Counts to 0, 3 warm-up steps, the rest timed, counts read: returns
    (launch counts, per-step losses, examples/sec, host ms per step)."""
    import torch

    warm = min(3, len(batches) - 1)
    reset_counts(fns)
    losses = trainer.train_steps(batches[:warm])
    torch.cuda.synchronize()
    trainer.host_ms = dict.fromkeys(trainer.host_ms, 0.0)
    t0 = time.perf_counter()
    losses += trainer.train_steps(batches[warm:])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts(fns)
    loss_vals = torch.stack(losses).tolist()
    n_timed = len(batches) - warm
    host = {k: v / n_timed for k, v in trainer.host_ms.items()}
    eps = BATCH * n_timed / elapsed
    log(f"[{path}] {len(batches)} steps, losses first {loss_vals[0]:.6f} "
        f"last {loss_vals[-1]:.6f}")
    log(f"[{path}] steady-state examples/sec={eps:.1f} step_ms={elapsed / n_timed * 1e3:.3f} "
        f"host ms/step: " + " ".join(f"{k}={v:.3f}" for k, v in host.items())
        + "; peak_memory_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"{path}: non-finite training loss: {loss_vals}")
    return counts, loss_vals, eps, host


def compare_with_plain(trainer, batches, fns, path: str, rows_of, loss_rtol, rows_atol):
    """Take ``batches`` one step at a time along the kernels' trajectory: from
    the kernels' state before each step, one step with the kernels and one
    with their plain versions; compare the step's loss and the table rows
    ``rows_of`` after it.

    Two runs left to go on alone for several steps are not held: any change
    in the order of a float sum (atomics, tiles) moves the tables by ~1e-9 in
    the first step, and a ReLU whose input lies that close to 0 then flips
    in the next forward, which changes a cotangent by percents and the row it
    updates by up to ~1e-5.  Their divergence is printed as a measurement."""
    import torch

    from torecsys_tpu_torch.train.state import batch_stats

    table = table_module(trainer).table_view()
    stats = batch_stats(trainer.pipeline.sequential)
    start = snapshot(trainer)
    loss_k, loss_p, row_err, stat_err = [], [], 0.0, 0.0
    for batch in batches:
        before = snapshot(trainer)
        with plain_versions(fns):
            loss_p += trainer.train_steps([batch])
        rows_p = rows_of(table)
        stats_p = {n: b.clone() for n, b in stats.items()}
        restore(trainer, before)
        del before
        loss_k += trainer.train_steps([batch])
        row_err = max(row_err, (rows_of(table) - rows_p).abs().max().item())
        stat_err = max([stat_err] + [(b - stats_p[n]).abs().max().item()
                                     for n, b in stats.items()])
    loss_k, loss_p = torch.stack(loss_k).tolist(), torch.stack(loss_p).tolist()
    rows_k = rows_of(table)
    restore(trainer, start)
    del start
    with plain_versions(fns):
        trainer.train_steps(batches)
    free_err = (rows_of(table) - rows_k).abs().max().item()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_k, loss_p))
    log(f"[{path}] kernels vs plain, {len(batches)} steps each from the kernels' state: losses "
        f"{loss_k} vs {loss_p} (max rel diff {loss_rel:.3g}, rtol {loss_rtol}); "
        f"{rows_k.shape[0]} table rows max_abs_err={row_err:.3g} (atol {rows_atol})"
        + (f"; {len(stats)} running statistics max_abs_err={stat_err:.3g} (atol {rows_atol})"
           if stats else "")
        + f"; left to run alone for {len(batches)} steps the two differ by {free_err:.3g} "
        "(not held)")
    if not loss_rel <= loss_rtol:
        raise AssertionError(f"{path}: losses with kernels and plain versions disagree")
    if not row_err <= rows_atol:
        raise AssertionError(f"{path}: table rows with kernels and plain versions disagree")
    if not stat_err <= rows_atol:
        raise AssertionError(f"{path}: running statistics with kernels and plain versions "
                             "disagree")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "row_max_abs_err": row_err,
            "stats_max_abs_err": stat_err, "free_running_row_max_abs_err": free_err}


def table_module(trainer):
    """The trainer's one embedding table module."""
    from torecsys_tpu_torch.train.sparse import sparse_modules

    (module,) = sparse_modules(trainer.pipeline.sequential).values()
    return module


def phase_train(seed: int, steps: int, out_dir, profile: bool):
    """Phase 3: the sparse main path.  Returns (trainer, record)."""
    import torch

    fns = kernels()
    batches = make_batches(seed + 1, steps + COMPARE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(seed)
    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    log(f"[train] table {tuple(table.shape)}, m||v {(table.shape[0], 2, table.shape[1])}, "
        f"{sum(FIELD_SIZES)} logical rows")
    counts, loss_vals, eps, host = timed_steps(trainer, batches[:steps], fns, "train")
    # row_gather twice a step: the lookup and the grad permute into id order
    check_counts("train", counts, expect(widen_segment_sum=steps, fused_rowwise_update=steps,
                                         row_gather=2 * steps))
    peak = torch.cuda.max_memory_allocated() / 1e9

    prof_info = None
    if profile:
        prof_info = profile_steps(trainer, batches[:3], out_dir, "train")

    cmp_batches = batches[steps:steps + COMPARE_STEPS]
    touched = stored_rows(trainer, cmp_batches)
    compare = compare_with_plain(trainer, cmp_batches, fns, "train",
                                 lambda t: t.index_select(0, touched),
                                 TRAIN_LOSS_RTOL, TRAIN_ROWS_ATOL)
    return trainer, {"launches": counts, "examples_per_sec": eps,
                     "step_ms": BATCH / eps * 1e3, "host_ms_per_step": host,
                     "peak_memory_gb": peak, "losses": loss_vals, "compare": compare,
                     "profile": prof_info}


def phase_eval(trainer, seed: int):
    """Phase 4: evaluate and predict on the trained main-path model."""
    import torch

    fns = kernels()
    val = make_batches(seed + 2, EVAL_BATCHES)
    reset_counts(fns)
    t0 = time.perf_counter()
    metrics = trainer.evaluate(val)  # reads the metrics: waits for the device
    first_s = time.perf_counter() - t0
    counts = read_counts(fns)
    check_counts("eval", counts, expect(row_gather=EVAL_BATCHES))
    t0 = time.perf_counter()
    again = trainer.evaluate(val)
    second_s = time.perf_counter() - t0
    eps = BATCH * EVAL_BATCHES / second_s
    log(f"[eval] {EVAL_BATCHES} held-out batches: val_auc={metrics['val_auc']:.6f} "
        f"val_logloss={metrics['val_logloss']:.6f} (random labels: val_auc near 0.5 is "
        f"right); examples/sec={eps:.1f} (second pass; first pass "
        f"{BATCH * EVAL_BATCHES / first_s:.1f})")
    if not (np.isfinite(metrics["val_auc"]) and np.isfinite(metrics["val_logloss"])):
        raise AssertionError(f"eval: non-finite metrics {metrics}")
    if again != metrics:
        raise AssertionError(f"eval: a second pass gave {again}, the first {metrics}")

    scores_k = trainer.predict(val[0])
    with plain_versions(fns):
        scores_p = trainer.predict(val[0])
    torch.cuda.synchronize()
    if scores_k.shape != (BATCH, 1) or not torch.isfinite(scores_k).all():
        raise AssertionError(f"predict: bad scores {tuple(scores_k.shape)}")
    if not torch.equal(scores_k, scores_p):
        raise AssertionError("predict: scores with the kernel and the plain gather differ")
    log(f"[predict] {BATCH} scores in (0, 1), mean {scores_k.mean().item():.6f}; "
        f"bit-identical with the plain gather")
    return {"launches": counts, "metrics": metrics, "examples_per_sec": eps,
            "first_pass_examples_per_sec": BATCH * EVAL_BATCHES / first_s}


def phase_ondevice(seed: int, steps: int, presorted_eps: float, out_dir, profile: bool):
    """Phase 5: the on-device sparse route (no host presort), on the default
    combine and on the one-pass fused dedup, on phase 3's batches; then both
    variants with kernels and with plain versions, and the presorted route,
    each step from the on-device kernels' state."""
    import torch

    from torecsys_tpu_torch.data.presort import Presorter, build_presort_specs

    fns = kernels()
    batches = make_batches(seed + 1, steps + COMPARE_STEPS)
    trainer = build_trainer(seed, presort=False)
    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    variants = {
        "ondevice": ("0", expect(widen_segment_sum=steps, fused_rowwise_update=steps,
                                 row_gather=2 * steps)),
        "ondevice_fused": ("1", expect(fused_sorted_dedup_update=steps, row_gather=2 * steps)),
    }
    records = {}
    for path, (flag, want) in variants.items():
        torch.cuda.reset_peak_memory_stats()
        with fused_dedup(flag):
            counts, loss_vals, eps, host = timed_steps(trainer, batches[:steps], fns, path)
            peak = torch.cuda.max_memory_allocated() / 1e9
            check_counts(path, counts, want)
            prof_info = profile_steps(trainer, batches[:3], out_dir, path) if profile else None
            if path == "ondevice":  # the same steps, packed by 4 worker threads
                with input_workers(trainer, 4):
                    _, _, eps4, _ = timed_steps(trainer, batches[:steps], fns, f"{path}_4workers")
                log(f"[{path}] examples/sec packed on the loop's thread {eps:.1f}, by 4 worker "
                    f"threads {eps4:.1f}")
        log(f"[{path}] examples/sec {eps:.1f} (TORECSYS_TPU_FUSED_DEDUP={flag}) vs the presorted "
            f"route {presorted_eps:.1f} (phase 3), the same model and batches; "
            f"peak_memory_gb={peak:.3f}")
        records[path] = {"launches": counts, "examples_per_sec": eps, "step_ms": BATCH / eps * 1e3,
                         "host_ms_per_step": host, "peak_memory_gb": peak, "losses": loss_vals,
                         "profile": prof_info}

    cmp_batches = batches[steps:]
    presorter = Presorter(build_presort_specs(trainer.pipeline.inputs))
    touched = stored_rows(trainer, cmp_batches)
    # One step at a time along the reference's trajectory (compare_with_plain
    # says why runs left to go on alone are not held); the reference runs
    # last, so the trainer goes on from its state.  The fused kernel sums
    # each stored row in the default combine's order and updates it with the
    # same arithmetic, so its losses, table and slots are held to the bit.
    reference = "on-device, kernels"
    bit_equal = "fused, kernels"
    variants = (("on-device, plain", "0", True, False), (bit_equal, "1", False, False),
                ("fused, plain", "1", True, False), ("presorted, kernels", "0", False, True),
                (reference, "0", False, False))

    def state_rows():
        """The touched rows of the table and of its row-wise slots, side by
        side."""
        parts = [table.detach().index_select(0, touched)]
        for slots in _optimizers(trainer)[1].values():
            parts += [v.detach().index_select(0, touched).reshape(touched.numel(), -1)
                      for v in slots.values()]
        return torch.cat(parts, dim=1)

    def step(flag, plain, presorted, feed):
        feed = [presorter(b) for b in feed] if presorted else feed
        with fused_dedup(flag), (plain_versions(fns) if plain else contextlib.nullcontext()):
            losses = torch.stack(trainer.train_steps(feed)).tolist()
        return losses, state_rows()

    start = snapshot(trainer)
    runs = {label: ([], 0.0, True) for label, *_ in variants}
    for batch in cmp_batches:
        before = snapshot(trainer)
        rows, losses = {}, {}
        for label, *how in variants:
            restore(trainer, before)
            losses[label], rows[label] = step(*how, [batch])
        del before
        for label in runs:
            err = (rows[label] - rows[reference]).abs().max().item()
            same = losses[label] == losses[reference] and torch.equal(rows[label],
                                                                      rows[reference])
            runs[label] = (runs[label][0] + losses[label], max(runs[label][1], err),
                           runs[label][2] and same)
        del rows
    free = {}
    for label, *how in variants[::-1]:  # the reference first
        restore(trainer, start)
        free[label] = step(*how, cmp_batches)[1]
    del start
    loss_ref = runs[reference][0]
    compare = {}
    for label, (losses, row_err, same) in runs.items():
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, loss_ref))
        free_err = (free[label] - free[reference]).abs().max().item()
        held = ("held to the bit: " + ("bit-identical" if same else "NOT bit-identical")
                if label == bit_equal else
                f"max rel diff {loss_rel:.3g}, rtol {TRAIN_LOSS_RTOL}; atol {TRAIN_ROWS_ATOL}")
        log(f"[ondevice] {label} vs {reference}, {COMPARE_STEPS} steps each from the "
            f"reference's state: losses {losses}; {touched.numel()} rows of the table and "
            f"its slots max_abs_err={row_err:.3g} ({held}); left to run alone the two "
            f"differ by {free_err:.3g} (not held)")
        if label == bit_equal and not same:
            raise AssertionError(f"ondevice: {label} is not bit-identical to {reference}")
        if not (loss_rel <= TRAIN_LOSS_RTOL and row_err <= TRAIN_ROWS_ATOL):
            raise AssertionError(f"ondevice: {label} disagrees with the on-device kernels")
        compare[label] = {"losses": losses, "loss_max_rel_diff": loss_rel,
                          "row_max_abs_err": row_err, "bit_identical": same,
                          "free_running_row_max_abs_err": free_err}
    del free
    del trainer, table, runs
    release()
    records["ondevice"]["compare"] = compare
    return records


def phase_dense(seed: int, steps: int, sparse_eps: float, out_dir, profile: bool):
    """Phase 6: the dense-table route at full width."""
    import torch

    fns = kernels()
    batches = make_batches(seed + 1, steps + COMPARE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(seed, sparse=False)
    counts, loss_vals, eps, host = timed_steps(trainer, batches[:steps], fns, "dense")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the lookup and its backward's permute; the backward's per-row sum
    check_counts("dense", counts, expect(row_gather=2 * steps, fused_sorted_dedup_update=steps))
    log(f"[dense] examples/sec dense route {eps:.1f} vs sparse route {sparse_eps:.1f} "
        f"(phase 3), the same model and batches; peak_memory_gb={peak:.3f}")
    prof_info = profile_steps(trainer, batches[:3], out_dir, "dense") if profile else None
    repeat = check_repeatable(trainer, batches[steps:], "dense")
    compare = compare_with_plain(trainer, batches[steps:], fns, "dense", lambda t: t.clone(),
                                 DENSE_LOSS_RTOL, DENSE_TABLE_ATOL)
    del trainer
    release()
    return {"launches": counts, "examples_per_sec": eps, "host_ms_per_step": host,
            "peak_memory_gb": peak, "losses": loss_vals, "repeat": repeat, "compare": compare,
            "profile": prof_info}


def check_repeatable(trainer, batches, path: str):
    """Take ``batches`` twice with the kernels from one state: the losses, the
    table and the table's optimizer state must be the same bits (the
    lookup's backward sums each row with one writer, in a fixed order)."""
    import torch

    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    dense_opt, _ = _optimizers(trainer)

    def state():
        return [table.detach()] + [v for v in dense_opt.state[table].values()
                                   if isinstance(v, torch.Tensor)]

    start = snapshot(trainer)
    first = torch.stack(trainer.train_steps(batches)).tolist()
    first_state = [t.clone() for t in state()]
    restore(trainer, start)
    second = torch.stack(trainer.train_steps(batches)).tolist()
    same = first == second and all(torch.equal(a, b) for a, b in zip(first_state, state()))
    restore(trainer, start)
    del start, first_state
    log(f"[{path}] two runs of {len(batches)} steps with the kernels from one state: losses "
        f"{first} and {second}; table and its optimizer state "
        f"{'bit-identical' if same else 'NOT bit-identical'}")
    if not same:
        raise AssertionError(f"{path}: two runs from one state differ")
    return {"losses": first, "bit_identical": same}


def phase_pack1(seed: int, out_dir, profile: bool):
    """Phase 7: the pack == 1 sparse route (E = 128, fields capped)."""
    import torch

    fns = kernels()
    field_sizes = tuple(min(v, ROWS_CAP) for v in FIELD_SIZES)
    batches = make_batches(seed + 3, PACK1_STEPS, field_sizes)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(seed, embed=EMBED_WIDE, field_sizes=field_sizes)
    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    log(f"[pack1] table {tuple(table.shape)} ({table.numel() * 4 / 1e9:.2f} GB), "
        f"{sum(field_sizes)} rows, pack {trainer.pipeline.inputs.schema['emb_inputs'].pack}")
    counts, loss_vals, eps, host = timed_steps(trainer, batches, fns, "pack1")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts("pack1", counts, expect(fused_rowwise_update=PACK1_STEPS,
                                         row_gather=2 * PACK1_STEPS,
                                         segment_sum_wide=PACK1_STEPS))
    prof_info = profile_steps(trainer, batches[:3], out_dir, "pack1") if profile else None
    del trainer, table
    release()
    return {"launches": counts, "examples_per_sec": eps, "host_ms_per_step": host,
            "peak_memory_gb": peak, "losses": loss_vals, "profile": prof_info}


def profile_steps(trainer, batches, out_dir, path: str):
    """torch.profiler over a few steady steps of ``path``: device time by
    kernel, and the device's busy time as the union of its kernel and copy
    intervals."""
    import torch

    with card_profile() as prof:
        t0 = time.perf_counter()
        trainer.train_steps(batches)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    n = len(batches)
    device = device_events(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    lines = [f"{us / n:10.1f} us/step  {name[:110]}" for name, us in top]
    by_kernel = {}
    for name, us in by_name.items():
        kernel = port_kernel(name) or aten_gather(name)
        if kernel:
            by_kernel[kernel] = by_kernel.get(kernel, 0.0) + us / n
    log(f"[profile] {path}, {n} steps: wall {wall_us / n:.1f} us/step (profiler on), "
        f"device busy {busy_us / n:.1f} us/step ({busy_us / wall_us:.3f} of the window)")
    log(f"[profile] {path} in-step device us/step by kernel: "
        + ", ".join(f"{k} {us:.1f}" for k, us in sorted(by_kernel.items()))
        + ("" if "ATen index_select" in by_kernel else "; no ATen index_select gather"))
    for line in lines:
        log(f"[profile] {path} {line}")
    if out_dir:
        attr = ("self_device_time_total"
                if hasattr(prof.key_averages()[0], "self_device_time_total")
                else "self_cuda_time_total")
        with open(os.path.join(out_dir, f"chip_smoke_profile_{path}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=attr, row_limit=60))
    return {"wall_us_per_step": wall_us / n, "device_busy_us_per_step": busy_us / n,
            "kernel_us_per_step": by_kernel, "top": lines}


def port_kernel(event: str):
    """The port's kernel that a device event of that name belongs to (its
    CUDA function and template arguments), or None."""
    if "row_gather_kernel" in event:
        return "row_gather"
    if "unique_stored_gather_kernel" in event:
        return "unique_stored_gather"
    if "rowwise_update_kernel" in event:
        return "fused_rowwise_update"
    if "tile_kernel" in event or "fixup_kernel" in event:  # the three tiled kernels
        if "UpdateSink" in event:
            return "fused_sorted_dedup_update"
        return "widen_segment_sum" if "SegKeys<true>" in event else "segment_sum_wide"
    return None


def aten_gather(event: str):
    """The ATen gather kernels a step may run: ``index_select``'s (the grad
    permute before the row gather took it) and the elementwise scatter /
    gather kernel (``_combine_sorted_stored``'s uids ``scatter_``); else
    None."""
    if "vectorized_gather_kernel" in event or "indexSelect" in event:
        return "ATen index_select"
    if "_scatter_gather_elementwise_kernel" in event:
        return "ATen scatter_/gather"
    return None


# ---- phases 8-10: the C++ presort, the K-step graph, the headline ----------

PRESORT_BATCHES = 8
GRAPH_K = 8          # steps a dispatch, as bench.py's SCAN_STEPS
TIMED_DISPATCHES = 4
HEADLINE_DISPATCHES = 12
# device kernels one wrapper launch runs: the tiled kernels' tile pass and
# fix-up pass
DEVICE_KERNELS_PER_LAUNCH = {"widen_segment_sum": 2, "segment_sum_wide": 2,
                             "fused_sorted_dedup_update": 2}


def phase_presort(seed: int):
    """Phase 8: the C++ presort against numpy's on the bench batches, bit for
    bit, with each one's host ms a batch (one thread), and the C++ presort's
    batches a second on 4 threads (the prefetch workers' count)."""
    from torecsys_tpu_torch.data.presort import Presorter

    batches = make_batches(seed + 5, PRESORT_BATCHES)
    spec = bench_spec(8)
    native, numpy_ = Presorter([spec]), Presorter([spec], force_numpy=True)
    if not native.native:
        raise AssertionError("the card's host presorts with numpy: the C++ presort did not load")
    for i, b in enumerate(batches):
        got, want = native(b), numpy_(b)
        for k in want:
            if not np.array_equal(got[k], want[k]) or got[k].dtype != want[k].dtype:
                raise AssertionError(f"C++ presort differs from numpy on batch {i} at {k}")

    def per_batch_ms(fn):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for b in batches:
                fn(b)
            best = min(best, (time.perf_counter() - t0) / len(batches) * 1e3)
        return best

    native_ms, numpy_ms = per_batch_ms(native), per_batch_ms(numpy_)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        list(pool.map(native, batches))
        t0 = time.perf_counter()
        list(pool.map(native, batches * 4))
        threads_per_s = 4 * len(batches) / (time.perf_counter() - t0)
    log(f"[presort] {len(batches)} bench batches (M={BATCH * len(FIELD_SIZES)} ids, pack 8): "
        f"C++ bit-identical to numpy; host ms a batch, best of 3 passes: C++ {native_ms:.3f}, "
        f"numpy {numpy_ms:.3f} ({numpy_ms / native_ms:.1f}x); C++ on 4 threads "
        f"{threads_per_s:.1f} batches/s")
    return {"native_ms": native_ms, "numpy_ms": numpy_ms,
            "native_4_threads_batches_per_s": threads_per_s}


def bits(t):
    """A tensor's bits as integers of its width (NaN and -0.0 included)."""
    import torch

    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.view(width)


def kept_tensors(trainer):
    """``{name: tensor}`` of everything a train step keeps, the tensors
    themselves: parameters (the tables among them), running statistics,
    every tensor of the dense optimizer's state (any optimizer's keys), the
    row slots and the step."""
    import torch

    from torecsys_tpu_torch.train.state import batch_stats

    seq = trainer.pipeline.sequential
    dense_opt, slots = _optimizers(trainer)
    out = {n: p.detach() for n, p in seq.named_parameters()}
    out.update({f"{n} (buffer)": b for n, b in batch_stats(seq).items()})
    for n, p in seq.named_parameters():
        for key, v in dense_opt.state.get(p, {}).items():
            if isinstance(v, torch.Tensor):
                out[f"{n}:{key}"] = v
    for table, table_slots in slots.items():
        out.update({f"{table}:{key}": v for key, v in table_slots.items()})
    out["step"] = trainer.state.step
    return out


def held_state(trainer):
    """Clones of everything a train step keeps: parameters, optimizer state,
    row-wise slots, the step and loss accumulators."""
    from torecsys_tpu_torch.train.steps import _held_tensors

    return [t.detach().clone() for t in _held_tensors(trainer.pipeline.sequential,
                                                      trainer.state)]


def replay_vs_eager(trainer, group, start, path: str):
    """From the snapshot ``start``: one replay of the captured graph over
    ``group`` against its K steps taken eagerly; the losses and every kept
    tensor (table, slots, optimizer state, parameters, running statistics) must be
    the same bits.  The graphed state is cloned; the eager one is compared
    where it lies.  Returns (graphed losses, eager losses, same)."""
    import torch

    from torecsys_tpu_torch.train.steps import _held_tensors

    k = trainer.steps_per_execution
    restore(trainer, start)
    graphed = torch.stack(trainer.train_steps(group)).tolist()
    graphed_state = held_state(trainer)
    restore(trainer, start)
    trainer.steps_per_execution = 1
    eager = torch.stack(trainer.train_steps(group)).tolist()
    eager_state = _held_tensors(trainer.pipeline.sequential, trainer.state)
    trainer.steps_per_execution = k
    same = graphed == eager and all(torch.equal(bits(a), bits(b))
                                    for a, b in zip(graphed_state, eager_state))
    log(f"[{path}] one replay vs {k} eager steps from one state: losses {graphed} vs "
        f"{eager}; {len(graphed_state)} kept tensors (table, slots, optimizer state, parameters, "
        f"running statistics) {'bit-identical' if same else 'NOT bit-identical'}")
    if not same:
        # one temporary the size of a tensor at a time: the slots of a large
        # table take a third of the card
        worst = max(torch.sub(a.float(), b.float()).abs_().max().item()
                    for a, b in zip(graphed_state, eager_state))
        raise AssertionError(f"{path}: graphed and eager steps differ, by up to {worst:.3g}")
    return graphed, eager, same


REPLAY_MARK_CYCLES = PROFILE_LEAD_CYCLES // 10  # about 5 ms of the card's clock
REPLAY_MARK_MAX_US = 20_000  # the mark is shorter, the lead (about 50 ms) longer
REPLAY_WINDOWS = 4


def marked_events(prof):
    """The card's events of a :func:`replay_profile` window that come after
    its mark, the short spin kernel between its two replays; None where the
    window holds no mark.  The profiler loses a prefix of a window's
    events now and then, the lead spin kernel and 50 ms and more after it
    with it (a traced replay once held 15 row gathers of 16): a window
    whose mark was recorded lost nothing after it."""
    from torch.autograd import DeviceType

    spins = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                    and "spin_kernel" in e.name), key=lambda e: e.time_range.start)
    if not spins:
        return None
    last = spins[-1].time_range
    if last.end - last.start > REPLAY_MARK_MAX_US:
        return None  # the lead alone: the mark was lost
    return [e for e in device_events(prof) if e.time_range.start >= last.end]


def replay_profile(trainer, batches, out_dir, path: str):
    """torch.profiler over one dispatch of ``batches`` (one graph replay):
    the port's kernels the card ran in it, per wrapper launch, and the
    device busy time (union of kernel and copy intervals) per step.  Each
    window replays twice, with a short spin kernel between: the second
    replay is the one read (:func:`marked_events`), and a window without
    its mark, or with a port kernel's count that the steps do not divide,
    is taken again, up to ``REPLAY_WINDOWS`` windows."""
    import torch

    n = len(batches)
    for window in range(1, REPLAY_WINDOWS + 1):
        torch.cuda.synchronize()
        before = trainer.graph_stats["replays"]
        with card_profile() as prof:
            trainer.train_steps(batches)
            torch.cuda.synchronize()
            torch.cuda._sleep(REPLAY_MARK_CYCLES)
            torch.cuda.synchronize()
            trainer.train_steps(batches)
            torch.cuda.synchronize()
        if trainer.graph_stats["replays"] != before + 2:
            raise AssertionError(f"{path}: the traced dispatches were not two replays")
        device = marked_events(prof)
        # every step launches each port kernel as often as the others: a
        # count that the steps do not divide lost events after the mark
        # (an image-tower replay of 1.1 s once held 15 row gathers of 16)
        if device is not None and all(c % n == 0 for c in Counter(
                k for k in map(port_kernel, (e.name for e in device)) if k).values()):
            break
    else:
        raise AssertionError(f"{path}: torch.profiler lost the mark or events after it in "
                             f"{REPLAY_WINDOWS} traced windows in a row")
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    seen, us, by_name = {}, {}, {}
    for e in device:
        dur = (e.time_range.end - e.time_range.start) / n
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
        kernel = port_kernel(e.name)
        if kernel:
            seen[kernel] = seen.get(kernel, 0) + 1
            us[kernel] = us.get(kernel, 0.0) + dur
    per_replay = {k: v // DEVICE_KERNELS_PER_LAUNCH.get(k, 1) for k, v in seen.items()}
    log(f"[{path}] traced replay of {n} steps (window {window}): device busy "
        f"{busy_us / n / 1e3:.4f} ms/step; port kernels launched in it {per_replay} "
        f"({', '.join(f'{k} {v:.1f} us/step' for k, v in sorted(us.items()))})")
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"chip_smoke_replay_{path}.json"))
    return {"launches_per_replay": per_replay, "device_busy_ms_per_step": busy_us / n / 1e3,
            "kernel_us_per_step": us, "device_us_per_step_by_name": by_name, "windows": window}


@contextlib.contextmanager
def input_workers(trainer, n: int):
    """The host input path with ``n`` worker threads (0: the loop's own
    thread) on any route: the alternative to the Trainer's own choice (4
    workers where it presorts, none elsewhere), timed beside it."""
    from torecsys_tpu_torch.data.packed import group_batches
    from torecsys_tpu_torch.data.prefetch import prefetch_map

    trainer._prepared = lambda batches: prefetch_map(
        group_batches(batches, trainer.steps_per_execution), trainer._prepare,
        num_workers=n, depth=max(n, trainer.prefetch))
    try:
        yield
    finally:
        del trainer._prepared


def timed_dispatches(trainer, batches, path: str, steps_per_execution: int,
                     batch_size: int = BATCH):
    """Train on ``batches`` at ``steps_per_execution`` steps a dispatch with
    the host counters set to 0: (examples/sec, host ms a step per stage)."""
    import torch

    trainer.steps_per_execution = steps_per_execution
    trainer.host_ms = dict.fromkeys(trainer.host_ms, 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.train_steps(batches)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    eps = batch_size * len(batches) / elapsed
    host = {k: v / len(batches) for k, v in trainer.host_ms.items()}
    loss_vals = torch.stack(losses).tolist()
    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"{path}: non-finite loss")
    log(f"[{path}] K={steps_per_execution}: {len(batches)} steps, examples/sec={eps:.1f} "
        f"step_ms={elapsed / len(batches) * 1e3:.3f} host ms/step: "
        + " ".join(f"{k}={v:.3f}" for k, v in host.items()))
    return eps, host


GRAPH_ROUTES = {
    # route: (sparse, presort, TORECSYS_TPU_FUSED_DEDUP, launches a step)
    "presorted": (True, True, "0", dict(widen_segment_sum=1, fused_rowwise_update=1,
                                        row_gather=2)),
    "ondevice": (True, False, "0", dict(widen_segment_sum=1, fused_rowwise_update=1,
                                        row_gather=2)),
    "ondevice_fused": (True, False, "1", dict(fused_sorted_dedup_update=1, row_gather=2)),
    "dense": (False, None, "0", dict(row_gather=2, fused_sorted_dedup_update=1)),
}


def phase_graph(seed: int, out_dir):
    """Phase 9: each training route at K = 8 steps a dispatch with the bf16
    tower (the headline's settings).  The first dispatch warms up and
    captures; the counters show the wrappers launched 2K steps' kernels
    (warm-up and capture) and nothing in a replay.  Then, from one state,
    one replay and K eager steps: losses and every kept tensor (table,
    slots, Adam state, parameters) must be the same bits.  A replay under
    ``torch.cuda.set_sync_debug_mode("error")``.  Then eager against graphed
    on the same batches from the same state, and one traced replay."""
    import torch

    fns = kernels()
    k = GRAPH_K
    batches = make_batches(seed + 4, (3 + TIMED_DISPATCHES) * k)
    warm, first, cmp_group = batches[:k], batches[k:2 * k], batches[2 * k:3 * k]
    timed = batches[3 * k:]
    records = {}
    for route, (sparse, presort, flag, per_step) in GRAPH_ROUTES.items():
        path = f"graph_{route}"
        with fused_dedup(flag):
            # peak memory: of two eager steps, then also through the warm-up,
            # the capture and a replay (the graph's private pool included)
            torch.cuda.reset_peak_memory_stats()
            trainer = build_trainer(seed, sparse=sparse, presort=presort, spe=1,
                                    compute="bfloat16")
            trainer.train_steps(warm[:2])
            torch.cuda.synchronize()
            eager_peak = torch.cuda.max_memory_allocated() / 1e9
            trainer.steps_per_execution = k
            reset_counts(fns)
            trainer.train_steps(warm)
            counts = read_counts(fns)
            check_counts(f"{path} warm-up + capture", counts,
                         expect(**{n: 2 * k * c for n, c in per_step.items()}))
            trainer.train_steps(first)
            if read_counts(fns) != counts or trainer.graph_stats != {"captures": 1, "replays": 1}:
                raise AssertionError(f"{path}: a replay called a wrapper or captured again: "
                                     f"{read_counts(fns)} {trainer.graph_stats}")
            torch.cuda.synchronize()
            graph_peak = torch.cuda.max_memory_allocated() / 1e9
            reserved = torch.cuda.memory_reserved() / 1e9
            start = snapshot(trainer)
            graphed, eager, same = replay_vs_eager(trainer, cmp_group, start, path)
            restore(trainer, start)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                trainer.train_steps(cmp_group)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            log(f"[{path}] a replay with the host input path under "
                f"set_sync_debug_mode('error'): no synchronising call")
            restore(trainer, start)
            eager_eps, eager_host = timed_dispatches(trainer, timed, path, 1)
            eager_prof = profile_steps(trainer, timed[:3], out_dir, f"{path}_eager")
            restore(trainer, start)
            graph_eps, graph_host = timed_dispatches(trainer, timed, path, k)
            alt = 0 if presort else 4  # the other input path: see input_workers
            with input_workers(trainer, alt):
                alt_eps, alt_host = timed_dispatches(trainer, timed, f"{path}_{alt}workers", k)
            if trainer.graph_stats["captures"] != 1:
                raise AssertionError(f"{path}: captured again: {trainer.graph_stats}")
            traced = replay_profile(trainer, cmp_group, out_dir, path)
            want = {n: k * c for n, c in per_step.items()}
            if traced["launches_per_replay"] != want:
                raise AssertionError(f"{path}: traced replay launched "
                                     f"{traced['launches_per_replay']}, expected {want}")
            log(f"[{path}] examples/sec eager {eager_eps:.1f} vs graphed {graph_eps:.1f} "
                f"({graph_eps / eager_eps:.2f}x); device busy ms/step eager "
                f"{eager_prof['device_busy_us_per_step'] / 1e3:.4f} vs graphed "
                f"{traced['device_busy_ms_per_step']:.4f}; peak allocated GB: 2 eager steps "
                f"{eager_peak:.3f}, through warm-up, capture and a replay {graph_peak:.3f} "
                f"(reserved {reserved:.3f})")
            records[path] = {
                "launches": counts, "graph_stats": trainer.graph_stats, "bit_identical": same,
                "losses_graphed": graphed, "losses_eager": eager,
                "eager": {"examples_per_sec": eager_eps, "host_ms_per_step": eager_host,
                          "peak_memory_gb": eager_peak, "profile": eager_prof},
                f"graphed_{alt}workers": {"examples_per_sec": alt_eps,
                                          "host_ms_per_step": alt_host},
                "graphed": {"examples_per_sec": graph_eps, "host_ms_per_step": graph_host,
                            "peak_memory_gb": graph_peak, "reserved_gb": reserved,
                            "profile": traced},
            }
            del trainer, start
            release()
    return records


def graphed_fit(trainer, batches, fns, path: str, out_dir, route: str = "ondevice",
                epochs: int = 2):
    """``epochs`` epochs of ``fit`` over ``batches`` at the trainer's K steps
    a dispatch, the last timed, then a traced replay; the route must be
    ``route`` (a :data:`GRAPH_ROUTES` key: the on-device one by default).
    Launches: the wrappers' counts over the epochs (warm-up and capture),
    and the replays' from the trace, replays x per replay; each step must
    launch the route's kernels."""
    import torch

    k = trainer.steps_per_execution
    reset_counts(fns)
    first = second = trainer.fit(batches, max_epochs=1)
    if epochs == 2:
        trainer.host_ms = dict.fromkeys(trainer.host_ms, 0.0)
        second = trainer.fit(batches, max_epochs=1)
    counts = read_counts(fns)
    sparse, presort = GRAPH_ROUTES[route][:2]
    if trainer.sparse != sparse or (trainer._presorter is not None) != bool(presort):
        raise AssertionError(f"{path}: the trainer did not take the {route} route")
    per_step = GRAPH_ROUTES[route][3]
    check_counts(f"{path} warm-up + capture", counts,
                 expect(**{n: 2 * k * c for n, c in per_step.items()}))
    stats = dict(trainer.graph_stats)
    host = {n: v / len(batches) for n, v in trainer.host_ms.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    reserved = torch.cuda.memory_reserved() / 1e9
    traced = replay_profile(trainer, batches[:k], out_dir, path)
    per_replay = traced["launches_per_replay"]
    if DEVICE == "cuda" and not per_replay:
        raise AssertionError(f"{path}: the trace of a replay shows none of the port's kernels")
    # launches that ran: the wrappers counted the warm-up's eager steps and
    # the capture's records; a capture runs nothing, each replay runs what
    # the traced replay shows
    ran = stats["replays"] - stats["captures"]
    total = {n: counts[n] + ran * per_replay.get(n, 0) for n in counts}
    steps = epochs * len(batches)
    if total != expect(**{n: steps * c for n, c in per_step.items()}):
        raise AssertionError(f"{path}: launches {total} over {steps} steps, expected "
                             f"{per_step} a step")
    for epoch in (first, second):
        if not np.isfinite(epoch["train_loss"]):
            raise AssertionError(f"{path}: non-finite loss {epoch}")
    step_ms = BATCH / second["examples_per_sec"] * 1e3
    busy = traced["device_busy_ms_per_step"]
    epoch_text = (f"first epoch {first['examples_per_sec']:.1f} examples/sec (warm-up and "
                  f"capture), second {second['examples_per_sec']:.1f}; train_loss "
                  f"{first['train_loss']:.6f} then {second['train_loss']:.6f}; host ms/step "
                  "(second epoch): " if epochs == 2 else
                  f"one epoch {first['examples_per_sec']:.1f} examples/sec (warm-up and capture "
                  f"included); train_loss {first['train_loss']:.6f}; host ms/step: ")
    log(f"[{path}] {stats['captures']} capture, {stats['replays']} replays; {epoch_text}"
        + " ".join(f"{n}={v:.3f}" for n, v in host.items())
        + f"; device busy {busy:.4f} of a {step_ms:.4f} ms step ({busy / step_ms:.3f}); peak "
        f"allocated {peak:.3f} GB, reserved {reserved:.3f} GB; launches: wrappers (warm-up and "
        f"capture) {counts}; run, the warm-up's and the replays' (a traced replay's x replays) "
        f"{total}")
    return {"launches": total, "launches_counted": counts, "graph_stats": stats,
            "examples_per_sec": second["examples_per_sec"],
            "first_epoch_examples_per_sec": first["examples_per_sec"],
            "train_loss": second["train_loss"], "first_epoch_train_loss": first["train_loss"],
            "host_ms_per_step": host, "step_ms": step_ms, "device_busy_share": busy / step_ms,
            "peak_memory_gb": peak, "reserved_gb": reserved, "profile": traced}


def phase_headline(seed: int, out_dir):
    """Phase 10: the headline configuration through the entry points a user
    calls: ``Pipeline(...).set_sparse_embeddings(None)
    .set_compute_dtype("bfloat16")`` and ``Trainer(pipeline,
    steps_per_execution=8)`` (prefetch 4 and presort None, the defaults),
    two epochs of ``fit`` over 96 batches, the second timed; then a traced
    replay (:func:`graphed_fit`).  At the bench size the automatic choice
    takes the sparse route, and on the card presort None takes the on-device
    route."""
    import torch

    from torecsys_tpu_torch import Trainer

    fns = kernels()
    k = GRAPH_K
    batches = make_batches(seed + 6, HEADLINE_DISPATCHES * k)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(bench_pipeline(sparse=None, compute="bfloat16"), log_every=10**9,
                      seed=seed, steps_per_execution=k)
    record = graphed_fit(trainer, batches, fns, "headline", out_dir)
    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    log(f"[headline] auto choice: sparse, on-device (presort None on the card), table "
        f"{tuple(table.shape)} {table.dtype}, tower bf16")
    scores = trainer.predict(batches[0])
    if scores.dtype != torch.float32 or not torch.isfinite(scores).all():
        raise AssertionError("headline: predict gave non-finite or non-float32 scores")
    del trainer, table
    release()
    return record


# ---- phases 12-14: xDeepFM, DCN and FFM at the bench's fingerprint ----------

# xDeepFM (BASELINE.md configuration 4): the CIN (200, 200, 200) split-half
# with BatchNorm, 200 feature maps a layer as the xDeepFM paper (Lian et al.,
# KDD 2018, section 4) takes on Criteo, and the DNN (400, 400), the DeepFM
# headline's tower width; bf16 tower, 8 steps a dispatch, as the headline.
XDEEPFM = {"cin_layer_sizes": (200, 200, 200), "deep_layer_sizes": (400, 400),
           "cin_is_direct": False, "use_batchnorm": True}
XDEEPFM_DISPATCHES = 12   # two epochs of 96 batches, as the headline
CIN_ITERS = 5
# DCN (BASELINE.md configuration 4's other model): the JAX package's defaults.
DCN = {"cross_num_layers": 3, "deep_layer_sizes": (64, 64), "deep_output_size": 16}
DCN_STEPS = 5
# FFM (BASELINE.md configuration 2) over the field-aware table: E = 4, the
# latent size of the FFM paper (Juan et al., RecSys 2016) on Criteo, on the
# bench's 28 fields: 28 x 28 = 784 ids an example, pack 32.
FFM_EMBED = 4
FFM_HELD_STEPS = 3
FFM_DISPATCHES = 4        # two epochs of 32 batches
# cuBLAS's and CUTLASS's GEMM kernels, by name
GEMM_MARKS = ("gemm", "xmma", "nvjet", "cutlass")


def stored_rows(trainer, batches):
    """The stored rows of the trainer's table that ``batches`` touch (its own
    presort spec), as int64 on the card."""
    import torch

    from torecsys_tpu_torch.data.presort import Presorter, spec_for_module

    spec = spec_for_module(table_module(trainer))
    presorter = Presorter([spec])
    touched = []
    for b in batches:
        out = presorter(b)
        n = int(out[spec.aux_key("n_unique")][0])
        touched.append(torch.from_numpy(out[spec.aux_key("uids")][:n]))
    return torch.unique(torch.cat(touched)).to(DEVICE).long()


def cin_device_ms(cin, gen):
    """Device ms of the CIN's forward and backward on one batch of random
    ``(B, N, E)`` rows, in training mode (its batch norm moves its running
    statistics: run it last)."""
    import torch

    n = cin.conv_0.shape[2]
    x = torch.randn(BATCH, n, EMBED, device=DEVICE, generator=gen).mul_(0.01)
    x.requires_grad_(True)
    cin.train()

    def fwd_bwd():
        cin(x).sum().backward()

    return time_ms(fwd_bwd, CIN_ITERS)


def cin_flops(cin, num_fields: int) -> float:
    """Multiply-adds x 2 of the CIN's compressions in one forward."""
    total, h_prev = 0, num_fields
    last = len(cin.layer_sizes) - 1
    for k, h in enumerate(cin.layer_sizes):
        total += h * h_prev * num_fields
        h_prev = h if cin.is_direct or k == last else h - h // 2
    return 2.0 * BATCH * EMBED * total


def phase_xdeepfm(seed: int, out_dir):
    """Phase 12: xDeepFM at full width on the bench's workload through the
    entry points (``set_sparse_embeddings(None)``, ``set_compute_dtype(
    "bfloat16")``, ``Trainer(steps_per_execution=8)``): one eager step from
    one state with the kernels against their plain versions (losses, touched
    rows and the running statistics); two epochs of ``fit`` over 96 batches
    (:func:`graphed_fit`), the loss finite and falling; one replay against 8
    eager steps to the bit, running statistics included; ``evaluate`` in
    ``eval()`` mode, which reads the running statistics and moves none; the
    CIN's and the GEMMs' device time a step."""
    import torch

    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.train.state import batch_stats

    fns = kernels()
    k = GRAPH_K
    batches = make_batches(seed + 9, XDEEPFM_DISPATCHES * k)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(ctr_pipeline("xDeepFM", XDEEPFM, compute="bfloat16"), log_every=10**9,
                      seed=seed, steps_per_execution=k)
    trainer.init_state()
    seq = trainer.pipeline.sequential
    stats = batch_stats(seq)
    cin = seq.model.cin
    log(f"[xdeepfm] CIN {cin.layer_sizes} split-half with BatchNorm ({len(stats)} running "
        f"statistics), DNN {XDEEPFM['deep_layer_sizes']}, bf16 tower; "
        f"{sum(p.numel() for n, p in seq.named_parameters() if 'inputs' not in n)} dense "
        f"parameters; CIN forward {cin_flops(cin, len(FIELD_SIZES)) / 1e9:.1f} GFLOP a step")
    trainer.steps_per_execution = 1
    touched = stored_rows(trainer, batches[:1])
    compare = compare_with_plain(trainer, batches[:1], fns, "xdeepfm",
                                 lambda t: t.index_select(0, touched), TRAIN_LOSS_RTOL,
                                 TRAIN_ROWS_ATOL)
    trainer.steps_per_execution = k
    torch.cuda.reset_peak_memory_stats()  # the fit's own peak, without the comparison's copies
    record = graphed_fit(trainer, batches, fns, "xdeepfm", out_dir)
    if not record["train_loss"] < record["first_epoch_train_loss"]:
        raise AssertionError(f"xdeepfm: the loss did not fall: {record}")
    start = snapshot(trainer)
    replay_vs_eager(trainer, batches[:k], start, "xdeepfm")
    restore(trainer, start)
    del start
    before = {n: b.clone() for n, b in stats.items()}
    reset_counts(fns)
    evaluation = trainer.evaluate(batches[:EVAL_BATCHES])
    check_counts("xdeepfm eval", read_counts(fns), expect(row_gather=EVAL_BATCHES))
    if seq.training or any(not torch.equal(b, before[n]) for n, b in stats.items()):
        raise AssertionError("xdeepfm: evaluate ran in training mode or moved the running "
                             "statistics")
    if not all(np.isfinite(v) for v in evaluation.values()):
        raise AssertionError(f"xdeepfm: evaluate gave {evaluation}")
    by_name = record["profile"]["device_us_per_step_by_name"]
    gemm_us = sum(us for name, us in by_name.items()
                  if any(mark in name.lower() for mark in GEMM_MARKS))
    cin_t = cin_device_ms(cin, torch.Generator(device=DEVICE).manual_seed(seed))
    cin_ops = 3 * cin_flops(cin, len(FIELD_SIZES))  # forward, and twice that backward
    kernel_us = record["profile"]["kernel_us_per_step"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[xdeepfm] evaluate (eval mode, running statistics) on {EVAL_BATCHES} batches: "
        f"{evaluation}; in a replayed step: GEMMs {gemm_us:.1f} us, port kernels "
        + ", ".join(f"{n} {us:.1f} us" for n, us in sorted(kernel_us.items()))
        + f"; the CIN's forward and backward alone {cin_t[0] * 1e3:.1f} us device (events "
        f"{cin_t[1] * 1e3:.1f}), {cin_ops / cin_t[0] / 1e9:.1f} TFLOP/s float32 against 67; "
        "top kernels a step: " + "; ".join(f"{us:.1f} us {name[:80]}" for name, us in top))
    del trainer, seq, cin, stats, before
    release()
    return {**record, "compare": compare, "eval": evaluation, "gemm_us_per_step": gemm_us,
            "cin_fwd_bwd_ms": cin_t[0], "cin_fwd_bwd_events_ms": cin_t[1],
            "cin_gflop_fwd": cin_ops / 3 / 1e9}


def phase_dcn(seed: int, out_dir):
    """Phase 13: DCN with the JAX package's defaults (3 cross layers, deep
    (64, 64), deep output 16; float32) at the bench's fingerprint, on the
    route the automatic choice takes, eager: timed steps, then steps each
    from one state with the kernels against their plain versions."""
    import torch

    from torecsys_tpu_torch import Trainer

    fns = kernels()
    batches = make_batches(seed + 10, DCN_STEPS + COMPARE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(ctr_pipeline("DCN", DCN), log_every=10**9, seed=seed)
    trainer.init_state()
    if not (trainer.sparse and trainer._presorter is None):
        raise AssertionError("dcn: the automatic choice did not take the on-device route")
    counts, loss_vals, eps, host = timed_steps(trainer, batches[:DCN_STEPS], fns, "dcn")
    check_counts("dcn", counts, expect(widen_segment_sum=DCN_STEPS,
                                       fused_rowwise_update=DCN_STEPS,
                                       row_gather=2 * DCN_STEPS))
    peak = torch.cuda.max_memory_allocated() / 1e9
    cmp_batches = batches[DCN_STEPS:]
    touched = stored_rows(trainer, cmp_batches)
    compare = compare_with_plain(trainer, cmp_batches, fns, "dcn",
                                 lambda t: t.index_select(0, touched), TRAIN_LOSS_RTOL,
                                 TRAIN_ROWS_ATOL)
    del trainer
    release()
    return {"launches": counts, "examples_per_sec": eps, "host_ms_per_step": host,
            "peak_memory_gb": peak, "losses": loss_vals, "compare": compare}


def ffm_trainer(seed: int, field_sizes=None, spe: int = 1):
    from torecsys_tpu_torch import Trainer

    trainer = Trainer(ctr_pipeline("FFM", {}, field_sizes, embed=FFM_EMBED,
                                   table="field_emb_inputs"),
                      log_every=10**9, seed=seed, steps_per_execution=spe)
    trainer.init_state()
    module = table_module(trainer)
    slots = sum(v.numel() for s in trainer.state.opt_state["sparse"].values()
                for v in s.values())
    log(f"[ffm] field-aware table {tuple(module.embedding.shape)} "
        f"({module.embedding.numel() * 4 / 1e9:.2f} GB; {module.table_view().shape[0]} stored "
        f"rows of pack {module.pack}), Adam slots {slots * 4 / 1e9:.2f} GB; "
        f"{BATCH * len(module.fields) ** 2} ids a batch; route "
        f"{'sparse' if trainer.sparse else 'dense'}, "
        f"{'presorted' if trainer._presorter is not None else 'on-device'}")
    if not (trainer.sparse and trainer._presorter is None):
        raise AssertionError("ffm: the automatic choice did not take the on-device route")
    return trainer


def phase_ffm_held(seed: int, out_dir):
    """Phase 14a: FFM over the field-aware table with each field capped at
    1M rows (so a snapshot of the table and its slots fits beside them):
    three on-device steps on the default combine and three with the fused
    dedup, then one presorted step, each from one state with the kernels
    against their plain versions; then a replay of 8 steps against 8 eager
    steps to the bit."""
    import torch

    from torecsys_tpu_torch.data.presort import Presorter, build_presort_specs

    fns = kernels()
    k = GRAPH_K
    field_sizes = tuple(min(v, ROWS_CAP) for v in FIELD_SIZES)
    n = FFM_HELD_STEPS
    batches = make_batches(seed + 11, n + 1 + 2 * k, field_sizes)
    torch.cuda.reset_peak_memory_stats()
    trainer = ffm_trainer(seed, field_sizes)
    cmp = batches[:n]
    touched = stored_rows(trainer, cmp)
    records = {}
    for path, flag, want in (
            ("ffm_held_ondevice", "0", expect(widen_segment_sum=n, fused_rowwise_update=n,
                                              row_gather=2 * n)),
            ("ffm_held_fused", "1", expect(fused_sorted_dedup_update=n, row_gather=2 * n))):
        with fused_dedup(flag):
            reset_counts(fns)
            records[path] = compare_with_plain(trainer, cmp, fns, path,
                                               lambda t: t.index_select(0, touched),
                                               TRAIN_LOSS_RTOL, TRAIN_ROWS_ATOL)
            check_counts(path, read_counts(fns), want)
    presorter = Presorter(build_presort_specs(trainer.pipeline.inputs))
    if not presorter.native:
        raise AssertionError("ffm: the C++ presort did not load")
    touched = stored_rows(trainer, batches[n:n + 1])
    reset_counts(fns)
    records["ffm_held_presorted"] = compare_with_plain(
        trainer, [presorter(batches[n])], fns, "ffm_held_presorted",
        lambda t: t.index_select(0, touched), TRAIN_LOSS_RTOL, TRAIN_ROWS_ATOL)
    check_counts("ffm_held_presorted", read_counts(fns),
                 expect(widen_segment_sum=1, fused_rowwise_update=1, row_gather=2))
    trainer.steps_per_execution = k
    per_step = GRAPH_ROUTES["ondevice"][3]
    reset_counts(fns)
    trainer.train_steps(batches[n + 1:n + 1 + k])
    check_counts("ffm_held warm-up + capture", read_counts(fns),
                 expect(**{name: 2 * k * c for name, c in per_step.items()}))
    start = snapshot(trainer)
    graphed, eager, same = replay_vs_eager(trainer, batches[n + 1 + k:], start, "ffm_held")
    del start
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[ffm_held] {sum(field_sizes)} rows a table, peak allocated {peak:.3f} GB")
    del trainer
    release()
    return {"compare": records, "graph": {"losses_graphed": graphed, "losses_eager": eager,
                                          "bit_identical": same}, "peak_memory_gb": peak}


# per stored element of a row rule: its slots (each read and written) and its
# float32 operations
RULE_SLOTS = {"adam": 2, "adagrad": 1, "sgd": 0}
RULE_OPS = {"adam": 14, "adagrad": 6, "sgd": 2}


def table_bounds(trainer, batch, rule: str = "adam"):
    """(bound_ms, bound_by) of each kernel of an on-device sparse step on
    ``batch`` under the row rule ``rule``, from its bytes: the lookup and
    the grad permute (``row_gather``, both), the widened sums, the row-wise
    update and the fused dedup (each touched row's table and ``rule``'s
    slots read and written once)."""
    from torecsys_tpu_torch.data.presort import Presorter, spec_for_module

    module = table_module(trainer)
    spec = spec_for_module(module)
    out = Presorter([spec])(batch)
    m = out[spec.aux_key("order")].shape[0]
    u = int(out[spec.aux_key("n_unique")][0])
    flat = (np.stack([batch[f] for f in spec.slot_fields], axis=1).astype(np.int64)
            + np.asarray(spec.slot_offsets, np.int64))
    d = np.unique(flat).size
    e, w = module.embed_size, module.embedding.shape[-1]
    row = w * 4 * (1 + RULE_SLOTS[rule])  # a stored row and its slots
    lookup = bound(m * 8 + d * e * 4 + m * e * 4, 0)
    permute = bound(m * e * 4 + m * 8 + m * e * 4, 0)
    return {"ids": m, "distinct_ids": d, "stored_rows": u,
            "row_gather": (lookup[0] + permute[0], "bytes"),
            "widen_segment_sum": bound(m * e * 4 + 2 * m * 4 + m * w * 4, m * e),
            "fused_rowwise_update": bound(u * (4 + w * 4 + 2 * row), u * w * RULE_OPS[rule]),
            "fused_sorted_dedup_update": bound(m * 4 + m * e * 4 + u * 2 * row,
                                               u * w * RULE_OPS[rule])}


def fit_and_fused_capture(trainer, batches, fns, path: str, out_dir, rule: str = "adam"):
    """Two epochs of ``fit`` over ``batches`` on the on-device route
    (:func:`graphed_fit`), then, with ``TORECSYS_TPU_FUSED_DEDUP=1``, a second
    capture and a traced replay of the fused dedup; each kernel's in-graph
    time at this shape beside its bound under the row rule ``rule``."""
    import torch

    k = trainer.steps_per_execution
    record = graphed_fit(trainer, batches, fns, path, out_dir)
    bounds = table_bounds(trainer, batches[0], rule)
    with fused_dedup("1"):
        trainer._train_scan = None  # the next dispatch captures the fused route
        per_step = GRAPH_ROUTES["ondevice_fused"][3]
        reset_counts(fns)
        trainer.train_steps(batches[:k])
        fused_counts = read_counts(fns)
        check_counts(f"{path}_fused warm-up + capture", fused_counts,
                     expect(**{n: 2 * k * c for n, c in per_step.items()}))
        fused = replay_profile(trainer, batches[:k], out_dir, f"{path}_fused")
        if fused["launches_per_replay"] != {n: k * c for n, c in per_step.items()}:
            raise AssertionError(f"{path}_fused: a traced replay launched "
                                 f"{fused['launches_per_replay']}")
        fused_ran = {n: c + replays_ran(trainer, per_step).get(n, 0)
                     for n, c in fused_counts.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    in_graph = {**record["profile"]["kernel_us_per_step"],
                "fused_sorted_dedup_update": fused["kernel_us_per_step"].get(
                    "fused_sorted_dedup_update", 0.0)}
    log(f"[{path}] M={bounds['ids']} ids a batch, {bounds['distinct_ids']} distinct, "
        f"{bounds['stored_rows']} stored rows; rule {rule}; in-graph us a step against the "
        "bound: "
        + ", ".join(f"{n} {in_graph.get(n, 0.0):.1f} (bound {bounds[n][0] * 1e3:.1f}, "
                    f"{bounds[n][1]})" for n in ("row_gather", "widen_segment_sum",
                                                 "fused_rowwise_update",
                                                 "fused_sorted_dedup_update"))
        + f"; fused route busy {fused['device_busy_ms_per_step']:.4f} ms a step; peak "
        f"allocated {peak:.3f} GB over both captures")
    return {**record, "bounds": dict(bounds), "in_graph_us": in_graph,
            "fused": {"launches_counted": fused_counts, "launches": fused_ran, "profile": fused},
            "peak_memory_gb_both_captures": peak}


def phase_ffm(seed: int, out_dir):
    """Phase 14b: FFM at the full vocabulary (32,884,400 rows a table: a
    14.73 GB field-aware table and 29.46 GB of Adam slots) through ``fit``,
    two epochs of 32 batches at 8 steps a dispatch, then the fused dedup
    captured (:func:`fit_and_fused_capture`)."""
    import torch

    fns = kernels()
    k = GRAPH_K
    batches = make_batches(seed + 12, FFM_DISPATCHES * k)
    torch.cuda.reset_peak_memory_stats()
    trainer = ffm_trainer(seed, spe=k)
    record = fit_and_fused_capture(trainer, batches, fns, "ffm", out_dir)
    del trainer
    release()
    return record


# ---- phase 15: NCF + BPR at the MovieLens-20M vocabulary --------------------

# BASELINE.md configuration 5: NCF trained pairwise (BPR) on implicit
# feedback with in-batch negatives, evaluated by NDCG@10.  The vocabulary is
# MovieLens-20M's (the ml-20m README: 138,493 users, 26,744 rated movies);
# E = 64, the NCF paper's largest predictive factor, and the tower (256,
# 128, 64) the paper's three layers for that factor (He et al., WWW 2017,
# section 4.1); 4 negatives a positive and batch 1024, the paper's.
ML_USERS = 138_493
ML_ITEMS = 26_744
NCF_LTR_EMBED = 64
NCF_LTR_TOWER = (256, 128, 64)
NCF_LTR_INTERACTIONS = 4_000_000
NCF_LTR_HELD = 0.05
NCF_LTR_BATCH = 1024
NCF_LTR_NEGS = 4
NCF_LTR_PLANTED = 0.8     # share of a user's interactions in its planted cluster
NCF_LTR_ZIPF = 1.0        # item popularity of the other interactions
NCF_LTR_NDCG_K = 10
NCF_LTR_NDCG_RISE = 0.05
NCF_LTR_TIMED_DISPATCHES = 64
NCF_LTR_MINER_KEYS = 8
# the lookup and the grad permute of each application, the per-row sum of
# each application's table gradient: two applications a step
LTR_PER_STEP = {"row_gather": 4, "fused_sorted_dedup_update": 2}
RANKING_SMALL_EMBED = 16
RANKING_SMALL_STEPS = 3


def interaction_batches(seed: int):
    """Implicit feedback over the MovieLens-20M vocabulary, written with
    numpy: users uniform; each user prefers a cluster of three items
    (``3u mod items`` and the two after it, as ``tests/test_trainer.py``
    plants one) for 80% of its interactions, the rest drawn from a Zipf(1.0)
    item popularity.  Returns (training batches, held-out batches): 95% and
    5% of the interactions, in batches of 1024 (the remainders dropped)."""
    rng = np.random.default_rng(seed)
    n = NCF_LTR_INTERACTIONS
    users = rng.integers(0, ML_USERS, n)
    popularity = 1.0 / np.arange(1, ML_ITEMS + 1) ** NCF_LTR_ZIPF
    popular = rng.choice(ML_ITEMS, size=n, p=popularity / popularity.sum())
    planted = (users * 3 + rng.integers(0, 3, n)) % ML_ITEMS
    items = np.where(rng.uniform(size=n) < NCF_LTR_PLANTED, planted, popular)
    cols = {"user": users.astype(np.int32), "item": items.astype(np.int32),
            "label": np.ones(n, np.float32)}
    b = NCF_LTR_BATCH
    split = int(n * (1 - NCF_LTR_HELD))

    def cut(lo, hi):
        return [{k: v[s:s + b] for k, v in cols.items()} for s in range(lo, hi - b + 1, b)]

    return cut(0, split), cut(split, n)


def ranking_pipeline(objective: str, model: str, model_kwargs, criterion: str, embed: int,
                     regularizer=None):
    """A ranking pipeline on the card over the MovieLens-20M vocabulary: one
    fused (user, item) table for ``ltr`` (MF, NCF), a context (user) and a
    target (item) table for StarSpace on ``emb``; Adam 1e-3, float32."""
    from torecsys_tpu_torch import Inputs, Pipeline
    from torecsys_tpu_torch.inputs import MultiIndicesEmbedding

    if objective == "ltr":
        schema = {"emb_inputs": MultiIndicesEmbedding(embed, (ML_USERS, ML_ITEMS),
                                                      ("user", "item"), device=DEVICE)}
    else:
        schema = {"context_inputs": MultiIndicesEmbedding(embed, (ML_USERS,), ("user",),
                                                          device=DEVICE),
                  "target_inputs": MultiIndicesEmbedding(embed, (ML_ITEMS,), ("item",),
                                                         device=DEVICE)}
    pipe = (Pipeline(device=DEVICE).set_objective(objective).set_inputs(Inputs(schema))
            .set_model(model, **model_kwargs).set_criterion(criterion)
            .set_miner("UniformBatchMiner", num_negs=NCF_LTR_NEGS)
            .set_miner_target_field("item").set_optimizer("Adam", lr=1e-3)
            .set_target_fields("label"))
    if regularizer is not None:
        pipe.set_regularizer(regularizer)
    return pipe


def check_miner_draws(seed: int):
    """The miner's draws on the card and on the CPU, as integers, for the
    train keys of steps 0-7 (device keys from the state's step) and the
    evaluation keys of batches 0-7."""
    import torch

    from torecsys_tpu_torch.miners import UniformBatchMiner
    from torecsys_tpu_torch.train.steps import eval_miner_key, miner_key

    miner = UniformBatchMiner(NCF_LTR_NEGS)
    n = 0
    for i in range(NCF_LTR_MINER_KEYS):
        step = torch.tensor(i, dtype=torch.int32)
        pairs = ((miner_key(seed, step.to(DEVICE)), miner_key(seed, step)),
                 (eval_miner_key(i), eval_miner_key(i)))
        for card_key, cpu_key in pairs:
            card = miner.draw(card_key, NCF_LTR_BATCH, DEVICE)
            cpu = miner.draw(cpu_key, NCF_LTR_BATCH, "cpu")
            if card.device.type != torch.device(DEVICE).type or not torch.equal(card.cpu(), cpu):
                raise AssertionError(f"ncf_bpr: the miner's draws on the card differ from the "
                                     f"CPU's for key {int(cpu_key)}")
            n += card.numel()
    log(f"[ncf_bpr] miner: {n} draws of {2 * NCF_LTR_MINER_KEYS} keys (train steps 0-"
        f"{NCF_LTR_MINER_KEYS - 1} from the device step, evaluation batches 0-"
        f"{NCF_LTR_MINER_KEYS - 1}) equal on the card and on the CPU")
    return n


def dense_state(trainer):
    """:func:`kept_tensors`, cloned."""
    return {name: t.clone() for name, t in kept_tensors(trainer).items()}


def ltr_bounds(trainer, batch, seed: int):
    """(bound_ms, "bytes") of the row gathers and the table gradients' sums
    of one NCF + BPR step on ``batch`` (step 0's draws): for each
    application, the lookup reads its int64 ids and each distinct row once
    and writes the (M, E) rows; the permute reads the cotangent and the
    order and writes it permuted; the sum reads int32 rows and the permuted
    cotangent and reads and writes each touched stored row of the zero
    table."""
    import torch

    from torecsys_tpu_torch.train.steps import miner_key

    module = table_module(trainer)
    e, w, pack = module.embed_size, module.embedding.shape[-1], module.pack
    draws = trainer.pipeline.miner.draw(miner_key(seed, torch.tensor(0, dtype=torch.int32)),
                                        NCF_LTR_BATCH, "cpu").numpy()
    users, items = batch["user"].astype(np.int64), batch["item"].astype(np.int64) + ML_USERS
    views = {"pos": np.stack([users, items], 1),
             "neg": np.stack([np.repeat(users, NCF_LTR_NEGS), items[draws]], 1)}
    gather_bytes = sum_bytes = 0.0
    detail = {}
    for name, ids in views.items():
        m, d = ids.size, np.unique(ids).size
        u = np.unique(ids // pack).size
        gather_bytes += m * 8 + d * e * 4 + m * e * 4 + (m * e * 4 + m * 8 + m * e * 4)
        sum_bytes += m * 4 + m * e * 4 + 2 * u * w * 4
        detail[name] = {"ids": m, "distinct_ids": d, "stored_rows": u}
    return {"row_gather": bound(gather_bytes, 0), "fused_sorted_dedup_update": bound(sum_bytes, 0),
            "views": detail}


def phase_ncf_ltr(seed: int, out_dir):
    """Phase 15: NCF + BPR at the MovieLens-20M vocabulary through the entry
    points a user calls (``Pipeline().set_objective("ltr")``, ``set_miner``,
    ``set_miner_target_field``, ``Trainer(steps_per_execution=8)``, ``fit``
    for one epoch, ``evaluate`` with ``ndcg_k=10``): the miner's draws held
    to the CPU's; one step from one state against the plain versions
    (losses, table and Adam moments); NDCG@10 on the held-out 5% before and
    after the epoch, which must rise by more than 0.05; launches, the
    wrappers' counts of the warm-up and capture plus the replays times a
    traced replay's, equal to 4 row gathers and 2 table-gradient sums a
    step; a replay against 8 eager steps to the bit and a replay under
    ``set_sync_debug_mode("error")``; then positive examples a second, step
    ms, host ms a step, device busy and peak GB over 64 timed dispatches.
    Then two short eager runs at E = 16, each step from one state against
    the plain versions: MF with ListNet and a regularizer on the table
    (``key_filter`` the table's name), and StarSpace on ``emb``."""
    import torch

    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.layers import Regularizer

    fns = kernels()
    k = GRAPH_K
    card = card_line()
    train, held = interaction_batches(seed + 13)
    torch.cuda.reset_peak_memory_stats()
    pipe = ranking_pipeline("ltr", "NCF", {"deep_layer_sizes": NCF_LTR_TOWER},
                            "BayesianPersonalizedRankingLoss", NCF_LTR_EMBED)
    trainer = Trainer(pipe, log_every=10**9, seed=seed, steps_per_execution=k,
                      ndcg_k=NCF_LTR_NDCG_K)
    trainer.init_state()
    table = table_module(trainer)
    if trainer.sparse or trainer._presorter is not None:
        raise AssertionError("ncf_bpr: the ltr objective left the dense route")
    log(f"[ncf_bpr] {ML_USERS} users, {ML_ITEMS} items: table {tuple(table.embedding.shape)} "
        f"(pack {table.pack}, {table.embedding.numel() * 4 / 1e6:.1f} MB; with Adam's moments "
        f"{table.embedding.numel() * 12 / 1e6:.1f} MB), tower {NCF_LTR_TOWER}, "
        f"{NCF_LTR_NEGS} negatives a positive, batch {NCF_LTR_BATCH}; {len(train)} training "
        f"batches, {len(held)} held out")
    miner_draws = check_miner_draws(seed)
    reset_counts(fns)
    before = trainer.evaluate(held)[f"val_ndcg@{NCF_LTR_NDCG_K}"]
    check_counts("ncf_bpr evaluate", read_counts(fns), expect(row_gather=2 * len(held)))
    start = snapshot(trainer)
    trainer.steps_per_execution = 1
    compare = step_vs_plain(trainer, train[0], fns, "ncf_bpr", expect(**LTR_PER_STEP))
    trainer.steps_per_execution = k
    restore(trainer, start)
    del start
    reset_counts(fns)
    epoch = trainer.fit(train, max_epochs=1)
    counts = read_counts(fns)
    stats = dict(trainer.graph_stats)
    after = trainer.evaluate(held)[f"val_ndcg@{NCF_LTR_NDCG_K}"]
    log(f"[ncf_bpr] NDCG@{NCF_LTR_NDCG_K} on {len(held)} held-out batches: {before:.6f} before "
        f"training, {after:.6f} after one epoch (train_loss {epoch['train_loss']:.6f}, "
        f"{epoch['examples_per_sec']:.1f} positive examples/sec with the warm-up and capture)")
    if not after > before + NCF_LTR_NDCG_RISE:
        raise AssertionError(f"ncf_bpr: NDCG@{NCF_LTR_NDCG_K} rose from {before:.6f} to "
                             f"{after:.6f}, not by more than {NCF_LTR_NDCG_RISE}")
    traced = replay_profile(trainer, train[:k], out_dir, "ncf_bpr")
    per_replay = traced["launches_per_replay"]
    want_replay = {n: k * c for n, c in LTR_PER_STEP.items()}
    if per_replay != want_replay:
        raise AssertionError(f"ncf_bpr: a traced replay launched {per_replay}, expected "
                             f"{want_replay}")
    ran = stats["replays"] - stats["captures"]
    total = {n: counts[n] + ran * per_replay.get(n, 0) for n in counts}
    check_counts(f"ncf_bpr fit ({len(train)} steps: counted {counts}, + {ran} replays x "
                 f"{per_replay})", total,
                 expect(**{n: len(train) * c for n, c in LTR_PER_STEP.items()}))
    _, replay = replay_checks(trainer, train[k:2 * k], fns, "ncf_bpr", LTR_PER_STEP)
    timed = train[:NCF_LTR_TIMED_DISPATCHES * k]
    eps, host = timed_dispatches(trainer, timed, "ncf_bpr", k, NCF_LTR_BATCH)
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = NCF_LTR_BATCH / eps * 1e3
    busy = traced["device_busy_ms_per_step"]
    bounds = ltr_bounds(trainer, train[0], seed)
    in_graph = traced["kernel_us_per_step"]
    top = sorted(traced["device_us_per_step_by_name"].items(), key=lambda kv: -kv[1])[:10]
    log(f"[ncf_bpr] {card}: {eps:.1f} positive examples/sec ({NCF_LTR_BATCH * (1 + NCF_LTR_NEGS)}"
        f" scored pairs a step), step {step_ms:.4f} ms, device busy {busy:.4f} ms a step "
        f"({busy / step_ms:.3f}), host ms/step: "
        + " ".join(f"{n}={v:.3f}" for n, v in host.items())
        + f", peak allocated {peak:.3f} GB; in-graph us a step: "
        + ", ".join(f"{n} {in_graph.get(n, 0.0):.1f} (bound {bounds[n][0] * 1e3:.1f}, "
                    f"{bounds[n][1]})" for n in LTR_PER_STEP)
        + "; top kernels a step: " + "; ".join(f"{us:.1f} us {name[:80]}" for name, us in top))
    scores = trainer.predict(held[0])
    if tuple(scores.shape) != (NCF_LTR_BATCH, 1) or not torch.isfinite(scores).all():
        raise AssertionError("ncf_bpr: predict gave non-finite scores or another shape")
    del trainer, table
    release()
    small = {}
    for path, (objective, model, kwargs, criterion, regularizer) in {
        "mf_listnet": ("ltr", "MF", {}, "ListnetLoss",
                       Regularizer(weight_decay=1e-4, key_filter="schema_emb_inputs")),
        "starspace": ("emb", "StarSpace", {"num_neg": NCF_LTR_NEGS},
                      "BayesianPersonalizedRankingLoss", None),
    }.items():
        t = Trainer(ranking_pipeline(objective, model, kwargs, criterion,
                                     RANKING_SMALL_EMBED, regularizer),
                    log_every=10**9, seed=seed)
        t.init_state()
        small[path] = [step_vs_plain(t, b, fns, f"{path} step {i}", expect(**LTR_PER_STEP))
                       for i, b in enumerate(train[:RANKING_SMALL_STEPS])]
        del t
        release()
    return {"launches": total, "launches_counted": counts, "graph_stats": stats,
            "miner_draws_held": miner_draws, "compare": compare,
            "ndcg_before": before, "ndcg_after": after, "train_loss": epoch["train_loss"],
            "fit_examples_per_sec": epoch["examples_per_sec"], "examples_per_sec": eps,
            "step_ms": step_ms, "host_ms_per_step": host, "device_busy_ms_per_step": busy,
            "device_busy_share": busy / step_ms, "peak_memory_gb": peak,
            "replay": replay,
            "profile": traced, "in_graph_us": in_graph,
            "bounds": {n: bounds[n] for n in LTR_PER_STEP}, "views": bounds["views"],
            "small": small, "card": card}


# ---- phases 16-18: the optimizers, FAT-DeepFFM and FiBiNET -----------------

# FAT-DeepFFM and DeepFFM (phase 16) on FFM's shape (phase 14: E = 4, pack
# 32, 3,211,264 ids a batch), the JAX package's defaults for the excitation
# network (reduction 1, squared), bench.py's DeepFM tower; Adagrad, as the
# FFM paper (Juan et al., RecSys 2016) trains FFM; lr 0.01 (the paper's
# 0.2 is a linear model's).
FAT_MODELS = {"DeepFFM": {"deep_layer_sizes": TOWER},
              "FATDeepFFM": {"reduction": 1, "deep_layer_sizes": TOWER}}
FAT_OPTIMIZER = ("Adagrad", 0.01)
FAT_DISPATCHES = 4        # two epochs of 32 batches, as FFM's
# FiBiNET (phase 17) at the FiBiNET paper's Criteo settings (Huang et al.,
# RecSys 2019, its experimental setup): E = 10, SENET reduction 3, DNN (400, 400,
# 400), Adam at lr 1e-4; the JAX default bilinear type "all"; dropout 0 (the
# paper's 0.5 is cut: the held steps compare without dropout).
FIBINET = {"senet_reduction": 3, "deep_layer_sizes": TOWER, "bilinear_type": "all"}
FIBINET_OPTIMIZER = ("Adam", 1e-4)
FIBINET_DISPATCHES = 6    # two epochs of 48 batches
# The optimizer sweep (phase 18) on the bench DeepFM (E = 16, tower 400-400-400)
# with each field capped at 100,000 rows.
OPTIM_ROWS_CAP = 100_000
OPTIM_LR = 1e-3
# optax's rprop updates by the previous step's step sizes: its first update
# is 0, so its held step follows one step
OPTIM_STILL_FIRST = ("rprop",)
# the scheduled dense Adam of phase 18: a warm-up over the first 4 steps to
# the sweep's rate, then a cosine decay to 1e-5 at step 64 (every step the
# phase takes has a rate of its own)
OPTIM_SCHEDULE = dict(init_value=1e-5, peak_value=OPTIM_LR, warmup_steps=4, decay_steps=64,
                      end_value=1e-5)
ROW_TWINS = {"Adam": "adam", "AdamW": "adam", "Adagrad": "adagrad", "SGD": "sgd"}
ONDEVICE_PER_STEP = {"0": GRAPH_ROUTES["ondevice"][3], "1": GRAPH_ROUTES["ondevice_fused"][3]}
DENSE_PER_STEP = GRAPH_ROUTES["dense"][3]
# The held steps of phases 15-18: kernels against plain versions by each
# kept tensor's change over one step, element by element.  The two steps sum
# a row's gradients in different orders (the dense route's plain twin,
# index_add_, with atomics), so a change may differ in its last bits, and a
# sum that nearly cancels keeps few of them: the tolerance is 2 ulps of the
# value (each result is rounded once) and 1e-3 of the tensor's largest
# change.  The table and each of its optimizer's tensors, which the kernels
# write, must change by 32 ulps of their largest value, so that the check
# sees a kernel that writes nothing or a wrong sum (the slowest rule, the
# dense route's Adadelta at lr 1e-3, moves the table by about 50).  Phases
# 16-18 scale the table first (scale_table) to a trained table's magnitude,
# root mean square 0.3 for the field-aware tables (the FFM term sums 1,512
# products at E = 4) and 0.1 for the others: there the first Adagrad step
# moves its accumulator by thousands of ulps.
# Where a table's rule is Adam's (the row rule adam, or torch.optim.Adam or
# AdamW over a table on the dense route), its element's update lr * m_hat /
# (sqrt(v_hat) + eps) turns a summed gradient that nearly cancels to near eps
# into a step near lr, so there the second term is the larger of 1e-3 of the
# largest change and the update's sensitivity (adam_sensitivity): how far
# the update moves when the summed gradient g moves by the summation-order
# bound 2 * (n - 1) * 2^-24 * sum |g_i| of its n terms, the larger of the
# two sides, in float64 from the plain step's g, sum |g_i| and n (recorded by
# abs_sums around the plain segment sums) and the moments before the step.
# Where |g| is well above eps that sensitivity is far under 1e-3 of the
# largest change, and the tolerance is the one above.  Adagrad, SGD and the
# written-out dense optimizers keep the tolerance above.
HELD_ROUND_ULPS = 2
HELD_RTOL = 1e-3
HELD_MOVED_ULPS = 32
HELD_CHUNK = 1 << 24
FFM_HELD_RMS = 0.3
HELD_RMS = 0.1
SUM_UNIT = 2.0 ** -24  # float32's unit roundoff


def add_counts(total, counts) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def replays_ran(trainer, per_step):
    """The launches the trainer's graph replays ran beyond what the wrappers
    counted: the capture counted one dispatch that ran nothing, and each
    replay ran one (``graphed_fit``'s rule)."""
    stats = trainer.graph_stats
    ran = stats["replays"] - stats["captures"]
    k = trainer.steps_per_execution
    return {n: ran * k * c for n, c in per_step.items()}


def embedding_tables(trainer):
    """``{table parameter name: module}`` of every embedding table of the
    trainer's pipeline: the sparse route's table modules, and the list and
    sequence inputs' tables, which are dense parameters on either route."""
    from torecsys_tpu_torch import inputs
    from torecsys_tpu_torch.train.sparse import sparse_modules

    # by name, where the tree has them: --phases also times a parent tree
    history = tuple(getattr(inputs, n) for n in ("ListIndicesEmbedding",
                                                 "SequenceIndicesEmbedding")
                    if hasattr(inputs, n))
    seq = trainer.pipeline.sequential
    return {**sparse_modules(seq), **{f"{name}.embedding": m for name, m in seq.named_modules()
                                      if isinstance(m, history)}}


def scale_table(trainer, rms: float) -> None:
    """Scale each of the trainer's tables (:func:`embedding_tables`) in place
    to root mean square ``rms`` (the padding rows stay 0).  The held steps
    of phases 16-21 start there: at the initial magnitude one step moves a
    field-aware row by about 1e-8 and Adagrad's accumulator not at all, so
    a kernel that wrote nothing would pass."""
    import torch

    for module in embedding_tables(trainer).values():
        table = module.embedding
        with torch.no_grad():
            table.mul_(rms * table.numel() ** 0.5
                       / torch.linalg.vector_norm(table.float()).item())


def held_compare(start, plain, kernel, sens=None):
    """One kept tensor after a kernel step against it after a plain step,
    both from ``start``, element by element in chunks (a field-aware table
    and its slot are GBs): ``(worst |kernel - plain| over its tolerance,
    flat index of the worst, the plain step's largest change in ulps of the
    tensor's largest value, the worst over the tolerance without ``sens``)``.
    The tolerance is HELD_ROUND_ULPS ulps of the element's value and the
    larger of HELD_RTOL of the tensor's largest change and the element's
    ``sens`` (:func:`adam_sensitivity`; none: 0)."""
    import torch

    if not start.is_floating_point():
        same = torch.equal(plain, kernel)
        return (0.0 if same else float("inf")), None, float((plain != start).any()), (
            0.0 if same else float("inf"))
    s, p, k = (t.reshape(-1) for t in (start, plain, kernel))
    sens = None if sens is None else sens.reshape(-1)
    chunks = [slice(i, i + HELD_CHUNK) for i in range(0, s.numel(), HELD_CHUNK)]
    largest = top = 0.0
    for c in chunks:
        largest = max(largest, (p[c].float() - s[c].float()).abs().max().item())
        top = max(top, s[c].abs().max().item(), p[c].abs().max().item())
    worst, at, worst_old = 0.0, None, 0.0
    for c in chunks:
        mag = torch.maximum(torch.maximum(s[c].abs(), p[c].abs()), k[c].abs())
        ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag).float()
        err = (k[c].float() - p[c].float()).abs()
        rel = torch.full_like(err, HELD_RTOL * largest)
        ratio_old = torch.where(err == 0, torch.zeros_like(err),
                                err / (HELD_ROUND_ULPS * ulp + rel))
        worst_old = max(worst_old, torch.nan_to_num(ratio_old, nan=float("inf")).max().item())
        if sens is not None:
            rel = torch.maximum(rel, sens[c])
        ratio = err / (HELD_ROUND_ULPS * ulp + rel)
        ratio = torch.where(err == 0, torch.zeros_like(err), ratio)
        r = ratio.max().item()
        if r != r or r > worst:
            worst, at = r, c.start + int(torch.argmax(torch.nan_to_num(ratio, nan=float("inf"))))
            if r != r:
                break
    top = torch.tensor(top, dtype=start.dtype)
    return worst, at, largest / (torch.nextafter(top, top + 1) - top).item(), worst_old


@contextlib.contextmanager
def abs_sums():
    """Around a plain step: each plain segment sum (``widen_segment_sum_plain``,
    ``segment_sum_wide_plain``, also inside the plain fused dedup and
    ``table_grad``) is taken again over ``|g|`` and over ones, and each plain
    row update (``fused_rowwise_update_plain``) adds its rows' summed
    gradient, ``sum |g_i|`` and term count into buffers of its table's
    ``(R, W)`` stored rows.  Yields ``{table.data_ptr(): [g, abs, n]}``, one
    entry for each real table: the row route's update writes the table
    itself, and ``table_grad``'s, under a lookup's backward, a zero gradient
    table, which is keyed by the table that lookup's forward read.  Enter
    it before :func:`plain_versions`, which takes the plain update it
    finds."""
    import torch

    from torecsys_tpu_torch.ops import embedding as E
    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    names = ("widen_segment_sum_plain", "segment_sum_wide_plain", "fused_rowwise_update_plain")
    orig = {n: getattr(K, n) for n in names}
    lookup = (E._RowGather.forward, E._RowGather.backward)
    sums, last = {}, {}

    def forward(ctx, packed_table, ids, embed_size):
        ctx.table_key = packed_table.data_ptr()
        return lookup[0](ctx, packed_table, ids, embed_size)

    def backward(ctx, grad):
        last["table"] = ctx.table_key
        try:
            return lookup[1](ctx, grad)
        finally:
            del last["table"]

    def widen(g_sorted, lo, seg, pack):
        last["abs"] = orig["widen_segment_sum_plain"](g_sorted.abs(), lo, seg, pack)
        last["n"] = orig["widen_segment_sum_plain"](torch.ones_like(g_sorted), lo, seg, pack)
        return orig["widen_segment_sum_plain"](g_sorted, lo, seg, pack)

    def wide(rows, seg):
        last["abs"] = orig["segment_sum_wide_plain"](rows.abs(), seg)
        last["n"] = orig["segment_sum_wide_plain"](torch.ones_like(rows), seg)
        return orig["segment_sum_wide_plain"](rows, seg)

    def update(uids, gsum, table, slots, hyper, rule, n_valid=None):
        n = uids.shape[0] if n_valid is None else int(n_valid)
        keep = (uids[:n] >= 0) & (uids[:n] < table.shape[0])
        idx = uids[:n][keep].long()
        bufs = sums.setdefault(last.get("table", table.data_ptr()), [
            torch.zeros(table.shape, dtype=torch.float32, device=table.device) for _ in range(3)])
        for buf, rows in zip(bufs, (gsum, last["abs"], last["n"])):
            buf.index_add_(0, idx, rows[:n][keep].float())
        return orig["fused_rowwise_update_plain"](uids, gsum, table, slots, hyper, rule, n_valid)

    for n, fn in zip(names, (widen, wide, update)):
        setattr(K, n, fn)
    E._RowGather.forward, E._RowGather.backward = staticmethod(forward), staticmethod(backward)
    try:
        yield sums
    finally:
        for n, fn in orig.items():
            setattr(K, n, fn)
        E._RowGather.forward, E._RowGather.backward = (staticmethod(f) for f in lookup)


def adam_rule(trainer, table: str, start):
    """``(lr, b1, b2, eps, t, m0, v0)`` where the table's update is Adam's
    (the row rule adam, or torch.optim.Adam or AdamW over it on the dense
    route), from the state ``start`` before the step; else None."""
    import torch

    from torecsys_tpu_torch.ops.sparse import RowAdam

    dense_opt, slots = _optimizers(trainer)
    if table in slots:
        row = trainer.pipeline.row_optimizer()
        if not isinstance(row, RowAdam):
            return None
        mv = start[f"{table}:mv"]
        w = mv.shape[-1]
        mv = mv.reshape(-1, 2, w)
        return (row.learning_rate, row.b1, row.b2, row.eps, int(start["step"].item()) + 1,
                mv[:, 0], mv[:, 1])
    if not isinstance(dense_opt, (torch.optim.Adam, torch.optim.AdamW)):
        return None
    group = dense_opt.param_groups[0]
    zero = torch.zeros_like(start[table])
    step = start.get(f"{table}:step")
    return (group["lr"], *group["betas"], group["eps"],
            (0 if step is None else int(step.item())) + 1,
            start.get(f"{table}:exp_avg", zero), start.get(f"{table}:exp_avg_sq", zero))


def adam_sensitivity(trainer, start, sums):
    """``{table name: (R, W) float32}``: for each table whose update is
    Adam's (:func:`adam_rule`), each touched element's update change when
    its plain summed gradient g moves by ``d = 2 (n - 1) 2^-24 sum |g_i|``,
    ``max |u(g +- d) - u(g)|`` with ``u(g) = lr m_hat / (sqrt(v_hat) + eps)``
    from the moments before the step, in float64; 0 where untouched."""
    import torch

    out = {}
    for table, module in embedding_tables(trainer).items():
        rule = adam_rule(trainer, table, start)
        stored = module.embedding
        key = stored.data_ptr()
        if rule is None or key not in sums:
            continue
        lr, b1, b2, eps, t, m0, v0 = rule
        g, a, n = (b.reshape(-1) for b in sums[key])
        touched = torch.nonzero(n > 0).reshape(-1)
        gt = g[touched].double()
        d = 2.0 * (n[touched].double() - 1).clamp_min(1.0) * SUM_UNIT * a[touched].double()
        m0t, v0t = (x.reshape(-1)[touched].double() for x in (m0, v0))
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t

        def update(x):
            m_hat = (b1 * m0t + (1 - b1) * x) / bc1
            v_hat = (b2 * v0t + (1 - b2) * x * x) / bc2
            return lr * m_hat / (torch.sqrt(v_hat) + eps)

        u = update(gt)
        sens = torch.maximum((update(gt + d) - u).abs(), (update(gt - d) - u).abs())
        flat = torch.zeros(stored.numel(), dtype=torch.float32, device=stored.device)
        flat[touched] = sens.float()
        out[table] = flat.reshape(stored.shape)
    return out


def step_vs_plain(trainer, batch, fns, path: str, want):
    """One step from one state with the kernels and with their plain
    versions: the losses within TRAIN_LOSS_RTOL, and each tensor the step
    keeps (:func:`kept_tensors`: parameters and tables, the dense
    optimizer's state, the row slots, running statistics) by its change
    over the step (:func:`held_compare`), which for each table
    (:func:`embedding_tables`) and each floating tensor of its optimizer
    state that the plain step writes must reach HELD_MOVED_ULPS ulps.  The
    kernel step's launches must be ``want``.  Returns the record with its ``launches``."""
    import torch

    tables = tuple(embedding_tables(trainer))
    snap = snapshot(trainer)
    start = dense_state(trainer)
    with abs_sums() as sums, plain_versions(fns):
        loss_p = trainer.train_steps([batch])[0].item()
    plain = dense_state(trainer)
    sensitivity = adam_sensitivity(trainer, start, sums)
    del sums
    restore(trainer, snap)
    del snap
    reset_counts(fns)
    loss_k = trainer.train_steps([batch])[0].item()
    counts = read_counts(fns)
    check_counts(f"{path} kernel step", counts, want)
    worst, where, moved, worst_old = 0.0, "all equal", {}, 0.0
    for name, t in kept_tensors(trainer).items():
        # a torch optimizer builds its state at its first step, from 0
        s = start[name] if name in start else torch.zeros_like(t)
        ratio, at, ulps, ratio_old = held_compare(s, plain[name], t, sensitivity.get(name))
        worst_old = max(worst_old, ratio_old)
        # the table and each floating tensor of its optimizer state that the
        # plain step writes (a count, a flag or a placeholder the rule never
        # writes, as adafactor's unfactored v of a factored table, is held
        # to the bit instead)
        if name.split(":")[0] in tables and s.is_floating_point() and (
                ":" not in name or not torch.equal(s, plain[name])):
            moved[name] = ulps
        if not ratio <= worst:
            flat = (s.reshape(-1), plain[name].reshape(-1), t.reshape(-1))
            worst, where = ratio, (f"{name}[{at}]: start {flat[0][at].item():.9g}, plain "
                                   f"{flat[1][at].item():.9g}, kernels {flat[2][at].item():.9g}"
                                   if at is not None else name)
    del start, plain, sensitivity
    rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[{path}] kernels vs plain, one step from one state: loss {loss_k:.8f} vs "
        f"{loss_p:.8f} (rel diff {rel:.3g}, rtol {TRAIN_LOSS_RTOL}); every kept tensor's change "
        f"(parameters, tables, optimizer state, row slots): worst |kernels - plain| / tolerance "
        f"{worst:.3g} ({where}), {worst_old:.3g} without Adam's sensitivity; the table's "
        "largest change in ulps: "
        + ", ".join(f"{n.rsplit('.', 1)[-1]} {u:.4g}" for n, u in moved.items()))
    if not np.isfinite(loss_k) or not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{path}: losses with kernels and plain versions disagree")
    if not worst <= 1.0:
        raise AssertionError(f"{path}: the kernels' step and the plain one differ beyond the "
                             f"tolerance: {where}, {worst:.3g} times it")
    still = {n: u for n, u in moved.items() if not u >= HELD_MOVED_ULPS}
    if still:
        raise AssertionError(f"{path}: the step moved {still} ulps at most, under "
                             f"{HELD_MOVED_ULPS}: the comparison cannot see the kernels")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "worst_over_tolerance": worst,
            "worst_over_old_tolerance": worst_old, "worst": where, "table_moved_ulps": moved,
            "launches": counts}


def replay_checks(trainer, group, fns, path: str, per_step, warm=None):
    """At the trainer's K steps a dispatch: where ``warm`` is given, the
    first dispatch over it warms up and captures (the wrappers launch 2K
    steps' kernels); from one state, one replay over ``group`` against its
    K steps taken eagerly, to the bit; then one replay under
    ``set_sync_debug_mode("error")``; the state is put back.  Returns (the
    wrappers' launches: the warm-up's, the capture's and the eager
    steps', record)."""
    import torch

    k = trainer.steps_per_execution
    reset_counts(fns)
    if warm is not None:
        trainer.train_steps(warm)
        check_counts(f"{path} warm-up + capture", read_counts(fns),
                     expect(**{n: 2 * k * c for n, c in per_step.items()}))
    captures = trainer.graph_stats["captures"]
    if warm is not None and captures != 1:
        raise AssertionError(f"{path}: the warm-up captured {captures} times")
    start = snapshot(trainer)
    graphed, eager, same = replay_vs_eager(trainer, group, start, path)
    counts = read_counts(fns)
    check_counts(f"{path} {'warm-up, capture and ' if warm is not None else ''}{k} eager steps",
                 counts, expect(**{n: (3 if warm is not None else 1) * k * c
                                   for n, c in per_step.items()}))
    restore(trainer, start)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_steps(group)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    restore(trainer, start)
    del start
    if trainer.graph_stats["captures"] != captures:
        raise AssertionError(f"{path}: captured again: {trainer.graph_stats}")
    log(f"[{path}] a replay under set_sync_debug_mode('error'): no synchronising call")
    return counts, {"losses_graphed": graphed, "losses_eager": eager, "bit_identical": same}


def timed_replays(trainer, group, path: str, per_step, bounds):
    """Graphed steps over ``group`` (examples/sec, step ms, host ms), peak
    GB, and a traced replay (no chrome trace is written): device busy and
    each port kernel's in-graph µs beside its bound (``table_bounds``)."""
    import torch

    k = trainer.steps_per_execution
    eps, host = timed_dispatches(trainer, group * 2, path, k)
    traced = replay_profile(trainer, group, None, path)
    want = {n: k * c for n, c in per_step.items()}
    if traced["launches_per_replay"] != want:
        raise AssertionError(f"{path}: a traced replay launched "
                             f"{traced['launches_per_replay']}, expected {want}")
    step_ms = BATCH / eps * 1e3
    busy = traced["device_busy_ms_per_step"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    us = traced["kernel_us_per_step"]
    log(f"[{path}] graphed: {eps:.1f} examples/sec, step {step_ms:.4f} ms, device busy "
        f"{busy:.4f} ms ({busy / step_ms:.3f}); peak allocated {peak:.3f} GB; in-graph us a "
        "step against the bound: " + ", ".join(
            f"{n} {v:.1f} (bound {bounds[n][0] * 1e3:.1f}, {bounds[n][1]})"
            for n, v in sorted(us.items())))
    return {"examples_per_sec": eps, "step_ms": step_ms, "host_ms_per_step": host,
            "device_busy_ms_per_step": busy, "peak_memory_gb": peak, "profile": traced,
            "bounds": dict(bounds)}


def fat_trainer(seed: int, model: str, field_sizes=None, spe: int = 1, sparse=None):
    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.ops.sparse import RowAdagrad

    trainer = Trainer(ctr_pipeline(model, FAT_MODELS[model], field_sizes, sparse=sparse,
                                   embed=FFM_EMBED, table="field_emb_inputs",
                                   optimizer=FAT_OPTIMIZER),
                      log_every=10**9, seed=seed, steps_per_execution=spe)
    trainer.init_state()
    module = table_module(trainer)
    dense = trainer.state.opt_state["dense"]
    log(f"[fat_deepffm] {model}: field-aware table {tuple(module.embedding.shape)} "
        f"({module.embedding.numel() * 4 / 1e9:.2f} GB), Adagrad slot "
        f"{module.embedding.numel() * 4 / 1e9:.2f} GB; route "
        f"{'sparse' if trainer.sparse else 'dense'}, "
        f"{'presorted' if trainer._presorter is not None else 'on-device'}; row rule "
        f"{type(trainer.pipeline.row_optimizer()).__name__}, tower optimizer "
        f"{type(dense).__name__}")
    if not (trainer.sparse and trainer._presorter is None
            and isinstance(trainer.pipeline.row_optimizer(), RowAdagrad)
            and type(dense).__name__ == "Adagrad"):
        raise AssertionError(f"fat_deepffm: {model} did not take the on-device route with "
                             "RowAdagrad and the optax-exact Adagrad")
    return trainer


def phase_fat_held(seed: int, out_dir):
    """Phase 16a: DeepFFM and FAT-DeepFFM under Adagrad with each field
    capped at 1M rows: one on-device step of each from one state, on the
    default combine and on the fused dedup, with the kernels against their
    plain versions (losses, the table, its ``v`` slot, the tower and its
    accumulators); then a replay of FAT-DeepFFM's 8 steps against 8 eager
    steps to the bit, and one under ``set_sync_debug_mode("error")``."""
    import torch

    fns = kernels()
    k = GRAPH_K
    field_sizes = tuple(min(v, ROWS_CAP) for v in FIELD_SIZES)
    batches = make_batches(seed + 13, 2 + 2 * k, field_sizes)
    total, records = {}, {}
    for model in FAT_MODELS:
        torch.cuda.reset_peak_memory_stats()
        trainer = fat_trainer(seed, model, field_sizes)
        scale_table(trainer, FFM_HELD_RMS)
        for i, flag in enumerate(("0", "1")):
            path = f"fat_held_{model}_{'fused' if flag == '1' else 'ondevice'}"
            with fused_dedup(flag):
                records[path] = step_vs_plain(trainer, batches[i], fns, path,
                                              expect(**ONDEVICE_PER_STEP[flag]))
            add_counts(total, records[path]["launches"])
        if model == "FATDeepFFM":
            trainer.steps_per_execution = k
            counts, records["fat_held_graph"] = replay_checks(
                trainer, batches[2 + k:], fns, "fat_held", ONDEVICE_PER_STEP["0"],
                warm=batches[2:2 + k])
            add_counts(total, counts)
            add_counts(total, replays_ran(trainer, ONDEVICE_PER_STEP["0"]))
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"[fat_held] {model}: {sum(field_sizes)} rows a table, peak allocated {peak:.3f} GB "
            "with the comparisons' copies")
        records[f"{model}_peak_memory_gb"] = peak
        del trainer
        release()
    return {"launches": total, **records}


def phase_fat(seed: int, out_dir):
    """Phase 16b: FAT-DeepFFM under Adagrad at the full vocabulary (a 14.73
    GB field-aware table and a 14.73 GB ``v`` slot) through ``fit``, two
    epochs of 32 batches at 8 steps a dispatch, then the fused dedup
    captured (:func:`fit_and_fused_capture`, Adagrad's bounds)."""
    import torch

    fns = kernels()
    k = GRAPH_K
    batches = make_batches(seed + 14, FAT_DISPATCHES * k)
    torch.cuda.reset_peak_memory_stats()
    trainer = fat_trainer(seed, "FATDeepFFM", spe=k)
    # no chrome traces here (about 6 MB each): --out stays small
    record = fit_and_fused_capture(trainer, batches, fns, "fat_deepffm", None, "adagrad")
    del trainer
    release()
    return record


def fibinet_trainer(seed: int, field_sizes=None, spe: int = 1, presort=None, sparse=True,
                    **model_kwargs):
    from torecsys_tpu_torch import Trainer

    trainer = Trainer(ctr_pipeline("FiBiNET", {**FIBINET, **model_kwargs}, field_sizes,
                                   sparse=sparse, embed=FIBINET_EMBED,
                                   optimizer=FIBINET_OPTIMIZER),
                      log_every=10**9, seed=seed, presort=presort, steps_per_execution=spe)
    trainer.init_state()
    return trainer


def phase_fibinet(seed: int, out_dir):
    """Phase 17: FiBiNET at the FiBiNET paper's Criteo settings over the
    bench's fields: E = 10 packs P = 8 into stored rows of W = 80, so the
    segment sum and the fused dedup take their scalar instantiations and the
    grad permute moves 40-byte rows.  One step from one state with the
    kernels against their plain versions on the on-device route (default
    combine and fused dedup) and the presorted one at the full vocabulary,
    and on the on-device route for the "each" and "interaction" bilinear
    types with fields capped at 1M rows; a replay against 8 eager steps to
    the bit and one under ``set_sync_debug_mode("error")``; then two epochs
    of ``fit`` on the route the automatic choice takes, the fused dedup
    captured, each kernel's in-graph µs beside its bound."""
    import torch

    from torecsys_tpu_torch.data.presort import Presorter, build_presort_specs

    fns = kernels()
    k = GRAPH_K
    batches = make_batches(seed + 15, max(FIBINET_DISPATCHES * k, 3 + 2 * k))
    total, records = {}, {}
    torch.cuda.reset_peak_memory_stats()
    trainer = fibinet_trainer(seed, presort=False)
    module = table_module(trainer)
    log(f"[fibinet] table {tuple(module.embedding.shape)} (E={module.embed_size}, pack "
        f"{module.pack}, {module.embedding.numel() * 4 / 1e9:.2f} GB), Adam slots "
        f"{2 * module.embedding.numel() * 4 / 1e9:.2f} GB; bilinear pairs "
        f"{len(FIELD_SIZES) * (len(FIELD_SIZES) - 1) // 2}, tower {TOWER}")
    if module.pack != 8 or module.embedding.shape[-1] != 80:
        raise AssertionError(f"fibinet: stored rows {tuple(module.embedding.shape)}, "
                             "expected pack 8 into W = 80")
    scale_table(trainer, HELD_RMS)
    for i, flag in enumerate(("0", "1")):
        path = f"fibinet_held_{'fused' if flag == '1' else 'ondevice'}"
        with fused_dedup(flag):
            records[path] = step_vs_plain(trainer, batches[i], fns, path,
                                          expect(**ONDEVICE_PER_STEP[flag]))
        add_counts(total, records[path]["launches"])
    presorter = Presorter(build_presort_specs(trainer.pipeline.inputs))
    if not presorter.native:
        raise AssertionError("fibinet: the C++ presort did not load")
    records["fibinet_held_presorted"] = step_vs_plain(
        trainer, presorter(batches[2]), fns, "fibinet_held_presorted",
        expect(**GRAPH_ROUTES["presorted"][3]))
    add_counts(total, records["fibinet_held_presorted"]["launches"])
    trainer.steps_per_execution = k
    counts, records["fibinet_graph"] = replay_checks(trainer, batches[3 + k:3 + 2 * k], fns,
                                                     "fibinet", ONDEVICE_PER_STEP["0"],
                                                     warm=batches[3:3 + k])
    add_counts(total, counts)
    add_counts(total, replays_ran(trainer, ONDEVICE_PER_STEP["0"]))
    del trainer, module
    release()
    capped = tuple(min(v, ROWS_CAP) for v in FIELD_SIZES)
    (capped_batch,) = make_batches(seed + 16, 1, capped)
    for kind in ("each", "interaction"):
        trainer = fibinet_trainer(seed, capped, presort=False, bilinear_type=kind)
        scale_table(trainer, HELD_RMS)
        path = f"fibinet_held_{kind}"
        records[path] = step_vs_plain(trainer, capped_batch, fns, path,
                                      expect(**ONDEVICE_PER_STEP["0"]))
        add_counts(total, records[path]["launches"])
        del trainer
        release()
    torch.cuda.reset_peak_memory_stats()
    trainer = fibinet_trainer(seed, spe=k, sparse=None)
    route = ("sparse, on-device" if trainer.sparse and trainer._presorter is None else
             "sparse, presorted" if trainer.sparse else "dense")
    log(f"[fibinet] the automatic choice takes the {route} route")
    record = fit_and_fused_capture(trainer, batches[:FIBINET_DISPATCHES * k], fns, "fibinet",
                                   None, "adam")
    del trainer
    release()
    return {**record, "held_launches": total, "route": route, "held": records}


def check_schedule_count(trainer, group, schedule):
    """After the replay check: two replays (16 steps) move every parameter's
    schedule count by 16, over steps whose rates differ from step to step
    (a rate frozen into the graph could not follow them)."""
    import torch

    opt = trainer.state.opt_state
    before = {int(s["lr_count"]) for s in opt.state.values()}
    trainer.train_steps(group * 2)
    after = {int(s["lr_count"]) for s in opt.state.values()}
    (start,) = before
    if after != {start + 2 * len(group)}:
        raise AssertionError(f"schedule: the counts moved from {before} to {after}")
    rates = [schedule(torch.tensor(c, dtype=torch.int32)).item()
             for c in range(start, start + 2 * len(group))]
    if len(set(rates)) != len(rates):
        raise AssertionError(f"schedule: the replayed steps' rates repeat: {rates}")
    log(f"[optim_schedule] {2 * len(group)} replayed steps moved the schedule count {start} -> "
        f"{start + 2 * len(group)}; "
        "their rates " + ", ".join(f"{r:.3g}" for r in rates))
    return {"count_before": start, "count_after": start + 2 * len(group), "rates": rates}


def optim_trainer(seed: int, name, sparse, field_sizes, spe: int = 1, lr=OPTIM_LR):
    from torecsys_tpu_torch import Trainer

    trainer = Trainer(ctr_pipeline("DeepFM", {"deep_layer_sizes": TOWER}, field_sizes,
                                   sparse=sparse, optimizer=(name, lr)),
                      log_every=10**9, seed=seed, presort=False, steps_per_execution=spe)
    trainer.init_state()
    return trainer


def phase_optim_sweep(seed: int, out_dir):
    """Phase 18: the bench DeepFM (E = 16, tower 400-400-400, fields capped
    at 100,000 rows) under each optimizer.  On the dense route each of the
    twelve names, on the on-device sparse route each name with a row twin
    (Adam, AdamW, Adagrad, SGD) on the default combine and on the fused
    dedup: 3 steps each from one state with the kernels against their plain
    versions (the table scaled first, :func:`scale_table`), the launches
    held; a replay of 8 steps against 8 eager steps to the bit and one under
    ``set_sync_debug_mode("error")``; graphed examples/sec and a traced
    replay.  optax's other names that the JAX Trainer can train with
    (``OPTAX_OTHERS`` but ``lbfgs``) on the dense route the same way with one
    held step each, and Adam under ``warmup_cosine_decay_schedule``
    (:data:`OPTIM_SCHEDULE`): its replay equal to its eager steps to the bit
    (each step at its own rate; a rate frozen at capture would part them),
    then 16 replayed steps whose schedule count the optimizer holds at 16
    more.  Then one step of the opaque form and of Lamb under the
    automatic choice, which must fall back to the dense route.  The path's
    ``launches`` are the wrappers' counts of these eager steps (held steps,
    Lamb's and the opaque one); ``graph_launches`` those of the replay
    checks and timed replays (warm-ups, captures and eager steps counted,
    replays from a traced replay)."""
    import torch

    from torecsys_tpu_torch import Pipeline, Trainer
    from torecsys_tpu_torch.train import schedules
    from torecsys_tpu_torch.train.optimizers import OPTAX_OTHERS, available_optimizers

    fns = kernels()
    k = GRAPH_K
    field_sizes = tuple(min(v, OPTIM_ROWS_CAP) for v in FIELD_SIZES)
    batches = make_batches(seed + 17, COMPARE_STEPS + 2 * k, field_sizes)
    cmp, warm, group = batches[:COMPARE_STEPS], batches[COMPARE_STEPS:COMPARE_STEPS + k], \
        batches[COMPARE_STEPS + k:]
    held, graphs, by_rule, records = {}, {}, {}, {}
    # (name, sparse, fused dedup flag, learning rate, held steps)
    configs = [(name, False, "0", OPTIM_LR, COMPARE_STEPS)
               for name in sorted(available_optimizers())]
    configs += [(name, True, flag, OPTIM_LR, COMPARE_STEPS) for name in ROW_TWINS
                for flag in ("0", "1")]
    configs += [(name, False, "0", OPTIM_LR, 1) for name in sorted(OPTAX_OTHERS)
                if name != "lbfgs"]
    schedule = schedules.warmup_cosine_decay_schedule(**OPTIM_SCHEDULE)
    configs.append(("Adam", False, "0", schedule, 1))
    torch.cuda.reset_peak_memory_stats()
    for name, sparse, flag, lr, n_held in configs:
        path = (f"optim_{name.lower()}_" + ("schedule_" if callable(lr) else "")
                + ("dense" if not sparse else "fused" if flag == "1" else "ondevice"))
        per_step = ONDEVICE_PER_STEP[flag] if sparse else DENSE_PER_STEP
        rule = ROW_TWINS[name] if sparse else "table_grad"
        with fused_dedup(flag):
            trainer = optim_trainer(seed, name, sparse, field_sizes, lr=lr)
            dense = trainer.state.opt_state["dense"] if sparse else trainer.state.opt_state
            row = trainer.pipeline.row_optimizer() if sparse else None
            if trainer.sparse != sparse or (sparse and trainer._presorter is not None):
                raise AssertionError(f"{path}: not on the expected route")
            scale_table(trainer, HELD_RMS)
            launched, replayed = {}, {}
            if name in OPTIM_STILL_FIRST:
                # its first update is 0 by design: the held step is the second
                reset_counts(fns)
                trainer.train_steps(cmp[-1:])
                check_counts(f"{path} first step", read_counts(fns), expect(**per_step))
                add_counts(launched, read_counts(fns))
            steps = [step_vs_plain(trainer, b, fns, f"{path} step {i}", expect(**per_step))
                     for i, b in enumerate(cmp[:n_held])]
            for st in steps:
                add_counts(launched, st["launches"])
            trainer.steps_per_execution = k
            counts, graph = replay_checks(trainer, group, fns, path, per_step, warm=warm)
            add_counts(replayed, counts)
            if callable(lr):
                graph["schedule"] = check_schedule_count(trainer, group, lr)
            # the dense route's table gradient is the fused dedup's sgd rule
            # at lr -1 on a zero table: its bound is that rule's
            timed = timed_replays(trainer, group, path, per_step,
                                  table_bounds(trainer, group[0], ROW_TWINS.get(name, "sgd")
                                               if sparse else "sgd"))

        add_counts(replayed, replays_ran(trainer, per_step))
        add_counts(held, launched)
        add_counts(graphs, replayed)
        for kernel in ("fused_rowwise_update", "fused_sorted_dedup_update"):
            if launched.get(kernel):
                by_rule.setdefault(kernel, {})
                by_rule[kernel][rule] = by_rule[kernel].get(rule, 0) + launched[kernel]
        records[path] = {"optimizer": type(dense).__name__,
                         "row_rule": type(row).__name__ if row else None,
                         "steps": steps, "graph": graph, "launches": launched,
                         "graph_launches": replayed, **timed}
        log(f"[{path}] {type(dense).__name__} over the "
            + (f"tower, {type(row).__name__} on the table" if sparse else "tower and the table")
            + f"; launches: held steps {launched}, graphs {replayed}")
        del trainer, dense, row
        release()
    lamb = optim_trainer(seed, "Lamb", None, field_sizes)
    if lamb.sparse or lamb.pipeline.row_optimizer() is not None:
        raise AssertionError("optim_sweep: Lamb under the automatic choice did not fall back "
                             "to the dense route")
    reset_counts(fns)
    loss = lamb.train_steps(cmp[:1])[0].item()
    check_counts("optim_lamb_auto", read_counts(fns), expect(**DENSE_PER_STEP))
    single = read_counts(fns)
    inputs = lamb.pipeline.inputs
    del lamb
    release()
    pipe = (Pipeline(device=DEVICE).set_inputs(inputs).set_model("DeepFM", deep_layer_sizes=TOWER)
            .set_optimizer(lambda params: torch.optim.SGD(params, lr=OPTIM_LR, momentum=0.9)))
    opaque = Trainer(pipe, log_every=10**9, seed=seed)
    reset_counts(fns)
    opaque_loss = opaque.train_steps(cmp[:1])[0].item()
    check_counts("optim_opaque", read_counts(fns), expect(**DENSE_PER_STEP))
    add_counts(single, read_counts(fns))
    add_counts(held, single)
    table_grads = by_rule.setdefault("fused_sorted_dedup_update", {})
    table_grads["table_grad"] = table_grads.get("table_grad", 0) + single[
        "fused_sorted_dedup_update"]
    if opaque.sparse or not isinstance(opaque.state.opt_state, torch.optim.SGD):
        raise AssertionError("optim_sweep: the opaque factory did not train the dense route")
    if not (np.isfinite(loss) and np.isfinite(opaque_loss)):
        raise AssertionError(f"optim_sweep: non-finite loss {loss} {opaque_loss}")
    log(f"[optim_sweep] Lamb under set_sparse_embeddings(None): dense route, loss {loss:.6f}; "
        f"an opaque factory (torch.optim.SGD, momentum 0.9): dense route, loss "
        f"{opaque_loss:.6f}; launches by rule {by_rule}")
    del opaque, pipe, inputs
    release()
    return {"launches": held, "graph_launches": graphs, "launches_by_rule": by_rule,
            "configs": records,
            "lamb_auto_loss": loss, "opaque_loss": opaque_loss}


# ---- phases 19-20: MMoE at full width; the multi-task, attention and position models

# MMoE (phase 19): the model of the MMoE paper (Ma et al., KDD 2018) at
# DeepCTR's MMOE defaults for its widths (num_experts=3,
# expert_dnn_hidden_units=(256, 128), tower_dnn_hidden_units=(64,),
# gate_dnn_hidden_units=()): 3 experts of a 256 layer to 128, a tower of 64
# to 1 per task, the gate one Dense; two tasks on (B, 2) labels drawn from
# --seed, on bench.py's workload.
MMOE = {"num_tasks": 2, "num_experts": 3, "expert_layer_sizes": (256,),
        "expert_output_size": 128, "tower_layer_sizes": (64,)}
MMOE_DISPATCHES = 6       # two epochs of 48 batches, as FiBiNET's
# Phase 20, each model held at a stated size (no published full-width
# configuration is claimed): ESMM at Ma et al., SIGIR 2018, section 4.2
# (E = 18, an MLP (360, 200, 80) per head) over the bench's fields capped at
# 1M rows: E = 18 packs P = 4 into stored rows of W = 72 floats (72-byte
# logical rows), the scalar instantiations; ESM2, DeepMoE (two MoE layers)
# and DeepMCP at the JAX package's defaults, and PAL around the bench
# DeepFM, on the same capped fields; PRM at the JAX defaults (encoding 32,
# 2 blocks, 2 heads, feed-forward 64) over lists of 30 of phase 15's 26,744
# MovieLens-20M items at E = 64, 1024 lists a batch, on the dense route.
ESMM_EMBED = 18
ESMM = {"deep_layer_sizes": (360, 200, 80)}
DEEPMOE = {"num_moe_layers": 2}
PAL_POSITIONS = 128       # the JAX PAL's max_num_position
PRM_LIST = 30
PRM_EMBED = 64
PRM_BATCH = 1024
PRM_CLICK_RATE = 0.1


def task_labels(batches, seed: int, tasks: int, nested: bool):
    """Replace each batch's label by ``(B, tasks)`` labels drawn from
    ``seed``: independent coins for MMoE's tasks, or (``nested``) a chain in
    which each task can be 1 only where the one before is (click, then
    conversion), the entire-space models' labels."""
    rng = np.random.default_rng(seed)
    for b in batches:
        n = b["label"].shape[0]
        cols = [b["label"].astype(np.float32)]
        for _ in range(tasks - 1):
            coin = (rng.uniform(size=n) < 0.5).astype(np.float32)
            cols.append(cols[-1] * coin if nested else coin)
        b["label"] = np.stack(cols, axis=1)
    return batches


def esmm_criterion(preds, targets):
    """ESMM's loss over ``(pCVR, pCTR)`` and the (click, conversion) label:
    ``BCE(pCTR, click) + BCE(pCTR·pCVR, conversion)`` (Ma et al., SIGIR
    2018, eq. 2-3), the registry's ``BCELoss``."""
    from torecsys_tpu_torch.losses import BCELoss

    pcvr, pctr = preds
    bce = BCELoss()
    return bce(pctr, targets[:, 0]) + bce(pctr * pcvr, targets[:, 1])


def chain_criterion(preds, targets):
    """ESM2's loss: the registry's ``BCELoss`` of each output against its
    label column, summed."""
    from torecsys_tpu_torch.losses import BCELoss

    bce = BCELoss()
    return sum(bce(p, targets[:, i]) for i, p in enumerate(preds))


def mcp_criterion(preds, targets):
    """DeepMCP's loss: the prediction subnet's logits and the matching
    subnet against the click, the correlation subnet's positive toward 1
    and its negatives toward 0."""
    import torch

    from torecsys_tpu_torch.losses import BCELoss, BCEWithLogitsLoss

    y_pred, y_match, y_pos, y_neg = preds
    bce = BCELoss()
    return (BCEWithLogitsLoss()(y_pred, targets) + bce(y_match, targets)
            + bce(y_pos, torch.ones_like(y_pos)) + bce(y_neg, torch.zeros_like(y_neg)))


def held_trainer(pipeline, seed: int, presort=False, spe: int = 1):
    from torecsys_tpu_torch import Trainer

    trainer = Trainer(pipeline, log_every=10**9, seed=seed, presort=presort,
                      steps_per_execution=spe)
    trainer.init_state()
    return trainer


def top_kernels(profile, n: int = 8) -> str:
    """A traced replay's GEMM time a step and its ``n`` longest kernels."""
    by_name = profile["device_us_per_step_by_name"]
    gemm_us = sum(us for name, us in by_name.items()
                  if any(mark in name.lower() for mark in GEMM_MARKS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return (f"GEMMs {gemm_us:.1f} us a step; top kernels a step: "
            + "; ".join(f"{us:.1f} us {name[:80]}" for name, us in top))


def phase_mmoe(seed: int, out_dir):
    """Phase 19: MMoE at DeepCTR's widths on bench.py's workload (28 Zipf
    fields over 32,884,400 rows, E = 16, batch 4096) with (B, 2) labels,
    Adam 1e-3, ``set_sparse_embeddings(None)``, bf16 tower,
    ``Trainer(steps_per_execution=8)``.  One step from one state with the
    kernels against their plain versions on the on-device route (both dedup
    settings) and the presorted one, the table scaled first; a replay
    against 8 eager steps to the bit and one under
    ``set_sync_debug_mode("error")``; two epochs of ``fit`` over 48 batches
    on the route the automatic choice takes, then the fused dedup captured
    (each kernel's in-graph time beside its bound); ``evaluate`` on 8
    held-out batches."""
    import torch

    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.data.presort import Presorter, build_presort_specs

    fns = kernels()
    k = GRAPH_K
    n_train = max(MMOE_DISPATCHES * k, 3 + 2 * k)
    batches = task_labels(make_batches(seed + 18, n_train + EVAL_BATCHES), seed + 18,
                          MMOE["num_tasks"], nested=False)
    train, held_out = batches[:n_train], batches[n_train:]
    total, records = {}, {}
    torch.cuda.reset_peak_memory_stats()
    trainer = held_trainer(ctr_pipeline("MMoE", MMOE, sparse=True, compute="bfloat16"), seed)
    seq = trainer.pipeline.sequential
    dense = sum(p.numel() for n, p in seq.named_parameters() if "inputs" not in n)
    n_in = len(FIELD_SIZES) * EMBED
    expert_macs = MMOE["num_experts"] * (n_in * 256 + 256 * 128)
    tower_macs = MMOE["num_tasks"] * (MMOE["num_experts"] * 128 * 64 + 64)
    gate_macs = n_in * MMOE["num_experts"] * MMOE["num_tasks"]
    log(f"[mmoe] {MMOE}; {dense} dense parameters; "
        f"{(expert_macs + tower_macs + gate_macs) / 1e6:.3f}M multiply-adds an example "
        f"(experts {expert_macs / 1e6:.3f}M, towers {tower_macs / 1e6:.4f}M, gates "
        f"{gate_macs / 1e6:.4f}M); labels {train[0]['label'].shape}")
    scale_table(trainer, HELD_RMS)
    for i, flag in enumerate(("0", "1")):
        path = f"mmoe_held_{'fused' if flag == '1' else 'ondevice'}"
        with fused_dedup(flag):
            records[path] = step_vs_plain(trainer, train[i], fns, path,
                                          expect(**ONDEVICE_PER_STEP[flag]))
        add_counts(total, records[path]["launches"])
    presorter = Presorter(build_presort_specs(trainer.pipeline.inputs))
    records["mmoe_held_presorted"] = step_vs_plain(
        trainer, presorter(train[2]), fns, "mmoe_held_presorted",
        expect(**GRAPH_ROUTES["presorted"][3]))
    add_counts(total, records["mmoe_held_presorted"]["launches"])
    trainer.steps_per_execution = k
    counts, records["mmoe_graph"] = replay_checks(trainer, train[3 + k:3 + 2 * k], fns, "mmoe",
                                                  ONDEVICE_PER_STEP["0"], warm=train[3:3 + k])
    add_counts(total, counts)
    add_counts(total, replays_ran(trainer, ONDEVICE_PER_STEP["0"]))
    del trainer, seq
    release()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(ctr_pipeline("MMoE", MMOE, sparse=None, compute="bfloat16"),
                      log_every=10**9, seed=seed, steps_per_execution=k)
    trainer.init_state()
    record = fit_and_fused_capture(trainer, train[:MMOE_DISPATCHES * k], fns, "mmoe", None,
                                   "adam")
    reset_counts(fns)
    evaluation = trainer.evaluate(held_out)
    check_counts("mmoe eval", read_counts(fns), expect(row_gather=EVAL_BATCHES))
    scores = trainer.predict(held_out[0])
    if not all(np.isfinite(v) for v in evaluation.values()) or tuple(scores.shape) != (
            BATCH, MMOE["num_tasks"]) or not torch.isfinite(scores).all():
        raise AssertionError(f"mmoe: evaluate gave {evaluation}, predict {tuple(scores.shape)}")
    log(f"[mmoe] evaluate on {EVAL_BATCHES} held-out batches, both tasks: {evaluation}; "
        f"predict {tuple(scores.shape)} {scores.dtype}; in a replayed step: "
        + top_kernels(record["profile"]))
    del trainer
    release()
    return {**record, "held_launches": total, "held": records, "eval": evaluation}


def position_input(field: str):
    """PAL's ``pos_inputs``: an input module giving the raw ``(B,)``
    position ids of one field."""
    from torecsys_tpu_torch.inputs import BaseInput

    class _PositionInput(BaseInput):
        def __init__(self):
            super().__init__()
            self.fields = (field,)

        def forward(self, batch):
            return batch[field]

    return _PositionInput()


def prm_batches(seed: int, n: int):
    """``n`` batches of PRM_BATCH lists of PRM_LIST items (Zipf(1.2) over the
    26,744 MovieLens-20M movies) with a per-position click label drawn at
    PRM_CLICK_RATE, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {f"pos_{i}": (np.minimum(rng.zipf(1.2, size=PRM_BATCH), ML_ITEMS) - 1).astype(
            np.int32) for i in range(PRM_LIST)}
        b["label"] = (rng.uniform(size=(PRM_BATCH, PRM_LIST)) < PRM_CLICK_RATE).astype(
            np.float32)
        out.append(b)
    return out


def multitask_pipelines(capped):
    """Phase 20's pipelines, each ``sparse`` route setting its own:
    ``{name: (pipeline factory, route, batches' label kind)}``."""
    from torecsys_tpu_torch import Inputs, Pipeline, ValueInput
    from torecsys_tpu_torch.inputs import MultiIndicesEmbedding, SingleIndexEmbedding
    from torecsys_tpu_torch.models import MODELS

    cats = tuple(f"cat_{i}" for i in range(len(capped)))

    def mcp():
        user = MultiIndicesEmbedding(EMBED, capped[:10], cats[:10], device=DEVICE)
        single = lambda fields: SingleIndexEmbedding(ROWS_CAP, EMBED, fields,  # noqa: E731
                                                     device=DEVICE)
        inputs = Inputs({"user_emb_inputs": user, "content_emb_inputs": single(cats[10:11]),
                         "pos_emb_inputs": single(cats[11:12]),
                         "neg_emb_inputs": single(cats[12:16])})
        return (Pipeline(device=DEVICE).set_inputs(inputs).set_model("DeepMCP")
                .set_criterion(mcp_criterion).set_optimizer("Adam", lr=1e-3)
                .set_sparse_embeddings(False))

    def pal():
        pctr = Inputs({"feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(NUM_DENSE))),
                       "emb_inputs": MultiIndicesEmbedding(EMBED, capped, cats, device=DEVICE)})
        pipe = Pipeline(device=DEVICE).set_inputs(
            Inputs({"pctr_inputs": pctr, "pos_inputs": position_input("position")}))
        model = MODELS["PAL"].from_inputs(pipe.inputs, "DeepFM", {"deep_layer_sizes": TOWER},
                                          max_num_position=PAL_POSITIONS, device=DEVICE)
        return (pipe.set_model(model).set_criterion("BCELoss").set_optimizer("Adam", lr=1e-3)
                .set_sparse_embeddings(True))

    def prm():
        table = SingleIndexEmbedding(ML_ITEMS, PRM_EMBED,
                                     tuple(f"pos_{i}" for i in range(PRM_LIST)), device=DEVICE)
        return (Pipeline(device=DEVICE).set_inputs(Inputs({"feat_inputs": table}))
                .set_model("PRM").set_criterion("BCELoss").set_optimizer("Adam", lr=1e-3)
                .set_sparse_embeddings(False))

    return {
        "esmm": (lambda: ctr_pipeline("ESMM", ESMM, capped, sparse=True, embed=ESMM_EMBED,
                                      criterion=esmm_criterion), "ondevice", ("nested", 2)),
        "esm2": (lambda: ctr_pipeline("ESM2", {}, capped, sparse=True,
                                      criterion=chain_criterion), "ondevice", ("nested", 3)),
        "deepmoe": (lambda: ctr_pipeline("DeepMoE", DEEPMOE, capped, sparse=True), "ondevice",
                    None),
        "deepmcp": (mcp, "dense4", None),
        "pal": (pal, "ondevice", "position"),
        "prm": (prm, "dense", "prm"),
    }


def phase_multitask(seed: int, out_dir):
    """Phase 20: ESMM at E = 18 (W = 72: the scalar instantiations and the
    72-byte grad permute), ESM2, DeepMoE, DeepMCP (four tables, the dense
    route), PAL around the bench DeepFM and PRM (the dense route), each at
    its stated size (:data:`ESMM` ... above): one step from one state with
    the kernels against their plain versions (the losses, the tables, every
    parameter and its Adam moments, PRM's running statistics), ESMM's on
    both dedup settings; a replay against 8 eager steps to the bit and one
    under ``set_sync_debug_mode("error")`` for ESMM and PRM, and ESMM's
    graphed steps traced, each kernel's in-graph time beside its bound."""
    import torch

    fns = kernels()
    k = GRAPH_K
    capped = tuple(min(v, ROWS_CAP) for v in FIELD_SIZES)
    per_route = {"ondevice": ONDEVICE_PER_STEP["0"], "dense": DENSE_PER_STEP,
                 "dense4": {n: 4 * c for n, c in DENSE_PER_STEP.items()}}
    total, records = {}, {}
    for name, (make, route, labels) in multitask_pipelines(capped).items():
        torch.cuda.reset_peak_memory_stats()
        n = 2 + 2 * k
        if labels == "prm":
            batches = prm_batches(seed + 20, n)
        else:
            batches = make_batches(seed + 19, n, capped)
            if labels == "position":
                rng = np.random.default_rng(seed + 19)
                for b in batches:
                    b["position"] = rng.integers(0, PAL_POSITIONS, BATCH).astype(np.int32)
            elif labels is not None:
                task_labels(batches, seed + 19, labels[1], nested=True)
        trainer = held_trainer(make(), seed)
        if trainer.sparse != (route == "ondevice"):
            raise AssertionError(f"{name}: route {'sparse' if trainer.sparse else 'dense'}, "
                                 f"expected {route}")
        scale_table(trainer, HELD_RMS)
        flags = ("0", "1") if name == "esmm" else ("0",)
        for i, flag in enumerate(flags):
            path = f"{name}_held" + ("_fused" if flag == "1" else "")
            want = ONDEVICE_PER_STEP[flag] if route == "ondevice" else per_route[route]
            with fused_dedup(flag):
                records[path] = step_vs_plain(trainer, batches[i], fns, path, expect(**want))
            add_counts(total, records[path]["launches"])
        if name == "esmm":
            module = table_module(trainer)
            if module.pack != 4 or module.embedding.shape[-1] != 72:
                raise AssertionError(f"esmm: stored rows {tuple(module.embedding.shape)}, "
                                     "expected pack 4 into W = 72")
        if name in ("esmm", "prm"):
            per_step = per_route[route]
            trainer.steps_per_execution = k
            counts, records[f"{name}_graph"] = replay_checks(
                trainer, batches[2 + k:], fns, name, per_step, warm=batches[2:2 + k])
            add_counts(total, counts)
            if name == "esmm":
                records["esmm_timed"] = timed_replays(
                    trainer, batches[2 + k:], name, per_step,
                    table_bounds(trainer, batches[2 + k], "adam"))
                log(f"[esmm] in a replayed step: "
                    + top_kernels(records["esmm_timed"]["profile"]))
            add_counts(total, replays_ran(trainer, per_step))
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"[{name}] {type(trainer.pipeline.model).__name__} on the "
            f"{'on-device sparse' if trainer.sparse else 'dense'} route; "
            f"{sum(p.numel() for p in trainer.pipeline.sequential.parameters())} parameters; "
            f"peak allocated {peak:.3f} GB with the comparisons' copies")
        records[f"{name}_peak_memory_gb"] = peak
        del trainer
        release()
    return {"launches": total, **records}


# ---- phase 21: DSIN and the sequence inputs ----------------------------------

# DSIN (Feng et al., IJCAI 2019) at DeepCTR's DSIN defaults: att_head_num = 8
# heads of att_embedding_size = 1, so E = 8 (the interest extractor's 8
# heads of depth 1) and a BiLSTM of 8 units; sess_max_count = 5 sessions.
# The behaviour vocabulary is the 846,811 ad groups of the Taobao display-ad
# dataset the paper evaluates DSIN on (section 4).  Sessions of L = 10
# behaviours are this script's choice (neither source fixes L here); ids are
# Zipf(1.2) (bench.py's skew) with padding id 0 past a length drawn in
# 1..10, the session index uniform in [0, 5), labels random, all from
# --seed; batch 4096, Adam 1e-3, float32, 8 steps a dispatch, the dense
# route (the list input's table is no sparse-route table): row_gather looks
# the behaviours up and permutes the table gradient, fused_sorted_dedup_update
# sums it (table_grad).
DSIN_EMBED = 8
DSIN_HEADS = 8
DSIN_HIDDEN = 8
DSIN_SESSIONS = 5
DSIN_LENGTH = 10
DSIN_VOCAB = 846_811
DSIN_DISPATCHES = 6       # one epoch of 48 batches
# The held mixed path: the bench DeepFM (E = 16, fields capped at 1M rows)
# on the on-device sparse route, its emb_inputs a StackedInput of the bench
# table, a SequenceIndicesEmbedding (2 bidirectional layers of LSTM cells,
# average pooling over a lengths field) and a ListIndicesEmbedding with
# 2-head attention, both over histories of DSIN's vocabulary and length:
# the bench table on the row kernels, the history tables on the dense
# optimizer through table_grad, in one step.
SEQ_DEEPFM_PER_STEP = dict(widen_segment_sum=1, fused_rowwise_update=1, row_gather=6,
                           fused_sorted_dedup_update=2)
# Its held step is taken from fresh Adam moments, as every other held step:
# held_compare bounds the bench table's elements by Adam's sensitivity
# (adam_sensitivity), where a hot row's gradient sum that nearly cancels to
# near eps once failed a correct kernel (g about 8e-10, 1.3 times the older
# tolerance, on the card).


def behaviour_batches(seed: int, n: int, fields=("behaviour",), batches=None):
    """``n`` batches of DSIN's workload from ``seed``: for each of
    ``fields`` a ``(B, L)`` id matrix (Zipf(1.2) ids in [1, 846,810], 0
    past a length drawn in 1..L) and its ``(B,)`` lengths (``<field>_len``);
    with ``batches`` added to those, else with the session index and a
    random label."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = {} if batches is None else batches[i]
        for field in fields:
            lengths = rng.integers(1, DSIN_LENGTH + 1, BATCH).astype(np.int32)
            ids = np.minimum(rng.zipf(1.2, size=(BATCH, DSIN_LENGTH)), DSIN_VOCAB - 1)
            ids[np.arange(DSIN_LENGTH)[None, :] >= lengths[:, None]] = 0
            b[field], b[f"{field}_len"] = ids.astype(np.int32), lengths
        if batches is None:
            b["session"] = rng.integers(0, DSIN_SESSIONS, BATCH).astype(np.int32)
            b["label"] = (rng.uniform(size=BATCH) < 0.5).astype(np.float32)
        out.append(b)
    return out


def dsin_pipeline():
    """DSIN through the entry points a user calls: ``Pipeline(...)
    .set_inputs(Inputs({...})).set_model("DSIN")``."""
    import warnings

    from torecsys_tpu_torch import Inputs, Pipeline
    from torecsys_tpu_torch.inputs import ListIndicesEmbedding

    inputs = Inputs({"session_embed_inputs": ListIndicesEmbedding(
        DSIN_VOCAB, DSIN_EMBED, ("behaviour",), output_method="none", device=DEVICE),
        "session_index": position_input("session")})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # DSIN's in-development marker
        return (Pipeline(device=DEVICE).set_objective("ctr").set_inputs(inputs)
                .set_model("DSIN", max_num_session=DSIN_SESSIONS, max_num_position=DSIN_LENGTH,
                           extractor_num_heads=DSIN_HEADS, interacting_hidden_size=DSIN_HIDDEN)
                .set_criterion("BCEWithLogitsLoss").set_optimizer("Adam", lr=1e-3)
                .set_target_fields("label"))


def seq_deepfm_pipeline(rnn_method: str):
    """The held mixed path's pipeline (:data:`SEQ_DEEPFM_PER_STEP`) with
    ``rnn_method`` cells."""
    from torecsys_tpu_torch import Inputs, Pipeline, ValueInput
    from torecsys_tpu_torch.inputs import (
        ListIndicesEmbedding,
        MultiIndicesEmbedding,
        SequenceIndicesEmbedding,
        StackedInput,
    )

    capped = tuple(min(v, ROWS_CAP) for v in FIELD_SIZES)
    stacked = StackedInput([
        MultiIndicesEmbedding(EMBED, capped, tuple(f"cat_{i}" for i in range(len(capped))),
                              device=DEVICE),
        SequenceIndicesEmbedding(DSIN_VOCAB, EMBED, ("behaviour",),
                                 lengths_field="behaviour_len", rnn_method=rnn_method,
                                 bidirectional=True, num_layers=2, output_method="avg_pooling",
                                 device=DEVICE),
        ListIndicesEmbedding(DSIN_VOCAB, EMBED, ("clicks",), use_attn=True, num_heads=2,
                             device=DEVICE)])
    inputs = Inputs({"feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(NUM_DENSE))),
                     "emb_inputs": stacked})
    return (Pipeline(device=DEVICE).set_objective("ctr").set_inputs(inputs)
            .set_model("DeepFM", deep_layer_sizes=TOWER).set_criterion("BCEWithLogitsLoss")
            .set_optimizer("Adam", lr=1e-3).set_sparse_embeddings(True)
            .set_target_fields("label"))


def dsin_bounds(batch):
    """(bound_ms, bound_by) of DSIN's dense step's kernels over its
    behaviour table (E = 8, pack 1): ``row_gather`` twice (the lookup: int64
    ids read, each distinct row read once, the rows written; the gradient's
    permute: the cotangent read, the int64 order read, the rows written)
    and ``fused_sorted_dedup_update`` as ``table_grad`` (int32 sorted ids
    and the cotangent read, each distinct row read and written, the sgd
    rule's 2 operations an element)."""
    ids, e = batch["behaviour"], DSIN_EMBED
    m, d = ids.size, np.unique(ids).size
    lookup = bound(m * 8 + d * e * 4 + m * e * 4, 0)
    permute = bound(m * e * 4 + m * 8 + m * e * 4, 0)
    return {"row_gather": (lookup[0] + permute[0], "bytes"),
            "fused_sorted_dedup_update": bound(m * 4 + m * e * 4 + d * 2 * e * 4,
                                               d * e * RULE_OPS["sgd"])}


def phase_dsin(seed: int, out_dir):
    """Phase 21: DSIN at DeepCTR's defaults over the Taobao ad-group
    vocabulary (:data:`DSIN_EMBED` ... above) on the dense route.  One step
    from one state with the kernels against their plain versions at float32
    and at bf16 compute, the table scaled first; a replay against 8 eager
    steps to the bit and one under ``set_sync_debug_mode("error")``; one
    epoch of ``fit`` over 48 batches at 8 steps a dispatch (launches from
    the counters and a traced replay), graphed steps timed and traced
    (examples/sec, step ms, busy share, each kernel's in-graph time beside
    its bound, top kernels, peak GB); ``evaluate`` and ``predict``.  Then
    the held mixed path (:func:`seq_deepfm_pipeline`): one step from fresh
    Adam moments with the kernels against their plain versions for each cell, and a replay of the
    LSTM's against 8 eager steps to the bit."""
    import torch

    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.layers.precision import apply_compute_dtype

    fns = kernels()
    k = GRAPH_K
    n_train = DSIN_DISPATCHES * k
    batches = behaviour_batches(seed + 21, n_train + EVAL_BATCHES)
    train, held_out = batches[:n_train], batches[n_train:]
    records, held = {}, {}
    torch.cuda.reset_peak_memory_stats()
    trainer = held_trainer(dsin_pipeline(), seed)
    if trainer.sparse:
        raise AssertionError("dsin: took the sparse route; its table is a dense parameter")
    seq = trainer.pipeline.sequential
    log(f"[dsin] E={DSIN_EMBED}, {DSIN_HEADS} heads, BiLSTM of {DSIN_HIDDEN}, "
        f"{DSIN_SESSIONS} sessions, L={DSIN_LENGTH}, {DSIN_VOCAB} behaviours; "
        f"{sum(p.numel() for n, p in seq.named_parameters() if 'inputs' not in n)} model "
        f"parameters")
    scale_table(trainer, HELD_RMS)
    for compute in (None, "bfloat16"):
        path = f"dsin_held_{compute or 'float32'}"
        apply_compute_dtype(seq, compute)
        records[path] = step_vs_plain(trainer, train[0], fns, path, expect(**DENSE_PER_STEP))
        add_counts(held, records[path]["launches"])
    apply_compute_dtype(seq, None)
    trainer.steps_per_execution = k
    counts, records["dsin_graph"] = replay_checks(trainer, train[k:2 * k], fns, "dsin",
                                                  DENSE_PER_STEP, warm=train[:k])
    add_counts(held, counts)
    add_counts(held, replays_ran(trainer, DENSE_PER_STEP))
    del trainer, seq
    release()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(dsin_pipeline(), log_every=10**9, seed=seed, steps_per_execution=k)
    trainer.init_state()
    # no chrome trace: a DSIN replay's thousands of small kernels make one
    # of about 26 MB
    record = graphed_fit(trainer, train, fns, "dsin", None, route="dense", epochs=1)
    bounds = dsin_bounds(train[0])
    timed = timed_replays(trainer, train[:k], "dsin", DENSE_PER_STEP, bounds)
    log("[dsin] in a replayed step: " + top_kernels(timed["profile"]))
    reset_counts(fns)
    evaluation = trainer.evaluate(held_out)
    check_counts("dsin eval", read_counts(fns), expect(row_gather=EVAL_BATCHES))
    scores = trainer.predict(held_out[0])
    if not all(np.isfinite(v) for v in evaluation.values()) or tuple(scores.shape) != (
            BATCH, 1) or not torch.isfinite(scores).all():
        raise AssertionError(f"dsin: evaluate gave {evaluation}, predict {tuple(scores.shape)}")
    log(f"[dsin] evaluate on {EVAL_BATCHES} held-out batches: {evaluation}; predict "
        f"{tuple(scores.shape)} {scores.dtype}")
    del trainer
    release()
    # the held mixed path
    capped = tuple(min(v, ROWS_CAP) for v in FIELD_SIZES)
    n_mixed = 1 + 2 * k
    mixed = behaviour_batches(seed + 22, n_mixed, ("behaviour", "clicks"),
                              make_batches(seed + 22, n_mixed, capped))
    step, warm_k, group = mixed[0], mixed[-2 * k:-k], mixed[-k:]
    seq_counts, mixed_held = {}, {}
    for rnn_method in ("lstm", "gru", "rnn"):
        torch.cuda.reset_peak_memory_stats()
        trainer = held_trainer(seq_deepfm_pipeline(rnn_method), seed)
        tables = embedding_tables(trainer)
        if not trainer.sparse or trainer._presorter is not None or len(
                trainer.state.opt_state["sparse"]) != 1 or len(tables) != 3:
            raise AssertionError(f"seq_deepfm: route sparse={trainer.sparse}, row-rule tables "
                                 f"{list(trainer.state.opt_state.get('sparse', {}))}, tables "
                                 f"{list(tables)}")
        scale_table(trainer, HELD_RMS)
        path = f"seq_deepfm_held_{rnn_method}"
        with fused_dedup("0"):
            records[path] = step_vs_plain(trainer, step, fns, path,
                                          expect(**SEQ_DEEPFM_PER_STEP))
            add_counts(mixed_held, records[path]["launches"])
            if rnn_method == "lstm":
                trainer.steps_per_execution = k
                seq_counts, records["seq_deepfm_graph"] = replay_checks(
                    trainer, group, fns, "seq_deepfm", SEQ_DEEPFM_PER_STEP, warm=warm_k)
                add_counts(seq_counts, replays_ran(trainer, SEQ_DEEPFM_PER_STEP))
        log(f"[{path}] peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB with the "
            "comparisons' copies")
        del trainer
        release()
    in_graph = timed["profile"]["kernel_us_per_step"]
    log("[dsin] in-graph us a step against the bound at DSIN's shape: " + ", ".join(
        f"{n} {in_graph.get(n, 0.0):.1f} (bound {bounds[n][0] * 1e3:.1f}, {bounds[n][1]})"
        for n in DENSE_PER_STEP))
    return {**record, "timed": timed, "bounds": bounds, "in_graph_us": in_graph,
            "eval": evaluation, "held": records, "held_launches": held,
            "seq_deepfm": {"launches": seq_counts, "held_launches": mixed_held}}


# ---- phase 22: image inputs, the pretrained tower, the API remainder --------

# The bench DeepFM (28 Zipf(1.2) fields over 32,884,400 rows, 13 dense
# fields, E = 16, tower 400-400-400, batch 4096, Adam 1e-3, float32) with its
# emb_inputs a StackedInput of the fused table and an ImageInput(16, 3) at
# the JAX package's default tower (convolutions 32 and 64, 3x3, stride 1,
# max pool 2, BatchNorm): 29 fields of width 16.  The images are 64x64 RGB
# uint8 thumbnails (a stated choice: the JAX package fixes the tower, the
# data the size), each taken from a pool of IMAGE_POOL item images made from
# --seed, indexed by the example's first field (its Zipf item id) modulo the
# pool.  The automatic sparse route at 8 steps a dispatch, one epoch of 48
# batches.
IMAGE_SIZE = 64
IMAGE_CHANNELS = 3
IMAGE_POOL = 8192          # 8192 x 12,288 bytes = 96 MiB of thumbnails
IMAGE_DISPATCHES = 6       # one epoch of 48 batches
CONV_MARKS = ("conv", "implicit", "cudnn", "wgrad", "dgrad", "fprop")


def image_batches(seed: int, n: int):
    """:func:`make_batches` with an ``image`` field: ``(B, 64, 64, 3)`` uint8
    thumbnails from a pool made from ``seed``, indexed by each example's
    ``cat_0`` id."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (IMAGE_POOL, IMAGE_SIZE, IMAGE_SIZE, IMAGE_CHANNELS),
                        dtype=np.uint8)
    batches = make_batches(seed, n)
    for b in batches:
        b["image"] = pool[b["cat_0"] % IMAGE_POOL]
    return batches


def image_pipeline(sparse=None, weights_path=None):
    """The image-tower DeepFM; with ``weights_path`` its image input is a
    ``PretrainedImageInput`` over that frozen tower (``head`` 16 → 16)."""
    from torecsys_tpu_torch import Inputs, Pipeline, ValueInput
    from torecsys_tpu_torch.inputs import (ImageInput, MultiIndicesEmbedding,
                                           PretrainedImageInput, StackedInput)

    table = MultiIndicesEmbedding(EMBED, FIELD_SIZES,
                                  tuple(f"cat_{i}" for i in range(len(FIELD_SIZES))),
                                  device=DEVICE)
    image = (ImageInput(EMBED, IMAGE_CHANNELS, device=DEVICE) if weights_path is None else
             PretrainedImageInput(EMBED, weights_path=weights_path, backbone_embed_size=EMBED,
                                  device=DEVICE))
    schema = {"feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(NUM_DENSE))),
              "emb_inputs": StackedInput([table, image])}
    return (Pipeline(device=DEVICE).set_objective("ctr").set_inputs(Inputs(schema))
            .set_model("DeepFM", deep_layer_sizes=TOWER).set_criterion("BCEWithLogitsLoss")
            .set_optimizer("Adam", lr=1e-3).set_sparse_embeddings(sparse)
            .set_target_fields("label"))


def image_module(trainer):
    return trainer.pipeline.sequential.inputs.schema["emb_inputs"].inputs[1]


def image_work():
    """The tower's multiply-adds an image (forward) and the bytes of its
    BatchNorm, ReLU and pool passes a step (float32 activations each read
    and written once a pass forward, twice backward; max-pool's int64
    indices), at the JAX default tower on 64x64x3."""
    h = w = IMAGE_SIZE
    macs, traffic, c_in = 0, 0, IMAGE_CHANNELS
    for c in (32, 64):
        macs += h * w * 9 * c_in * c
        act = h * w * c * 4
        traffic += 3 * (2 * act) + (act + act // 4 + (act // 4) * 2)  # BN, ReLU x3 passes; pool
        h, w, c_in = h // 2, w // 2, c
    return macs, traffic


def image_split(profile):
    """A traced replay's device µs a step: cuDNN's convolutions (the
    forward), the backward's unfold and fold, GEMMs (the backward's and the
    tower's), max pool, the port's kernels, and the rest (BatchNorm, ReLU,
    reductions, elementwise)."""
    split = dict.fromkeys(("cudnn_convolutions", "unfold_fold", "gemms", "max_pool",
                           "port_kernels", "other"), 0.0)
    for name, us in profile["device_us_per_step_by_name"].items():
        low = name.lower()
        if port_kernel(name):
            split["port_kernels"] += us
        elif "max_pool" in low:
            split["max_pool"] += us
        elif "im2col" in low or "col2im" in low:
            split["unfold_fold"] += us
        elif any(m in low for m in CONV_MARKS):
            split["cudnn_convolutions"] += us
        elif any(m in low for m in GEMM_MARKS):
            split["gemms"] += us
        else:
            split["other"] += us
    return split


def check_lookups(fns):
    """``embedding_lookup`` and ``fused_offset_lookup`` on the card: each one
    ``row_gather`` launch, each equal to ``index_select`` to the bit (ids at
    the bench's batch and fields)."""
    import torch

    from torecsys_tpu_torch.ops.embedding import (embedding_lookup, field_offsets,
                                                  fused_offset_lookup)

    gen = torch.Generator(device=DEVICE).manual_seed(22)
    sizes = tuple(min(v, 100_000) for v in FIELD_SIZES)
    table = torch.randn(sum(sizes), EMBED, device=DEVICE, generator=gen)
    raw = torch.stack([torch.randint(0, v, (BATCH,), device=DEVICE, generator=gen)
                       for v in sizes], dim=1)
    offs = field_offsets(sizes)
    fused_ids = raw + torch.as_tensor(offs, device=DEVICE)[None, :]
    counts = {}
    for name, call, ids in (("embedding_lookup", lambda: embedding_lookup(table, fused_ids),
                             fused_ids),
                            ("fused_offset_lookup", lambda: fused_offset_lookup(table, raw, offs),
                             fused_ids)):
        reset_counts(fns)
        out = call()
        got = read_counts(fns)
        check_counts(f"api {name}", got, expect(row_gather=1))
        add_counts(counts, got)
        want = table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, EMBED)
        if not same_bits(out, want):
            raise AssertionError(f"{name}: differs from index_select")
        log(f"[api] {name} over {tuple(ids.shape)} ids of a ({table.shape[0]}, {EMBED}) table: "
            "one row_gather launch, bit-identical to index_select")
    return counts


def check_not_jittable():
    """``not_jittable`` under a real CUDA graph capture: it raises before the
    wrapped function runs (so it enqueues nothing into the capture), and the
    captured graph replays what was captured around it."""
    import torch

    from torecsys_tpu_torch.utils.decorator import not_jittable

    ran = []

    @not_jittable
    def grow(x):
        ran.append(1)
        return x + 1

    x = torch.arange(8, dtype=torch.float32, device=DEVICE)
    if not torch.equal(grow(x), x + 1) or ran != [1]:
        raise AssertionError("not_jittable: the eager call did not pass through")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2
    torch.cuda.current_stream().wait_stream(side)
    graph, refused = torch.cuda.CUDAGraph(), None
    with torch.cuda.graph(graph):
        y = x * 2
        try:
            grow(x)
        except RuntimeError as e:
            refused = str(e)
    graph.replay()
    torch.cuda.synchronize()
    if refused is None or ran != [1] or not torch.equal(y, x * 2):
        raise AssertionError(f"not_jittable: refused={refused!r}, body ran {len(ran)} times")
    log(f"[api] not_jittable under a capture: refused ({refused}); the body did not run")
    return refused


def phase_image(seed: int, out_dir):
    """Phase 22: the image-tower DeepFM at the bench's widths.  One step from
    fresh Adam moments with the kernels against their plain versions on the
    on-device route (the table scaled first, Adam's sensitivity bound), a
    replay against 8 eager steps to the bit and one under
    ``set_sync_debug_mode("error")``; one epoch of ``fit`` over 48 batches at
    8 steps a dispatch on the route the automatic choice takes (launches
    from the counters and a traced replay; examples/sec, step ms, host ms by
    stage, device busy, the device time split: convolutions, GEMMs, max
    pool, the port's kernels, the rest); the fitted tower saved with
    ``save_tower_weights`` and a DeepFM over a ``PretrainedImageInput`` of
    it held the same way (its head and table move, the frozen tower's
    weights and statistics do not); the two lookups and ``not_jittable``."""
    import shutil
    import tempfile

    import torch

    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.inputs import save_tower_weights

    fns = kernels()
    k = GRAPH_K
    per_step = ONDEVICE_PER_STEP["0"]
    n_train = IMAGE_DISPATCHES * k
    t0 = time.perf_counter()
    batches = image_batches(seed + 23, n_train + 1 + 2 * k)
    train, step = batches[:n_train], batches[n_train]
    warm, group = batches[n_train + 1:n_train + 1 + k], batches[n_train + 1 + k:]
    macs, traffic = image_work()
    log(f"[image] {len(batches)} batches with (B, {IMAGE_SIZE}, {IMAGE_SIZE}, "
        f"{IMAGE_CHANNELS}) uint8 images from a pool of {IMAGE_POOL} in "
        f"{time.perf_counter() - t0:.1f} s; the tower: {macs / 1e6:.2f}M multiply-adds an "
        f"image, {2 * macs * BATCH / 1e12:.3f} TFLOP forward a batch and about "
        f"{6 * macs * BATCH / 1e12:.3f} a step; BatchNorm, ReLU and pool traffic about "
        f"{traffic * BATCH / 1e9:.1f} GB a step; {step['image'].nbytes / 2**20:.1f} MiB of "
        "pixels a batch to the card")
    records, held = {}, {}
    torch.cuda.reset_peak_memory_stats()
    trainer = held_trainer(image_pipeline(sparse=True), seed)
    if not trainer.sparse or trainer._presorter is not None:
        raise AssertionError("image: the held trainer is not on the on-device route")
    scale_table(trainer, HELD_RMS)
    with fused_dedup("0"):
        records["image_held"] = step_vs_plain(trainer, step, fns, "image_held",
                                              expect(**per_step))
        add_counts(held, records["image_held"]["launches"])
        trainer.steps_per_execution = k
        counts, records["image_graph"] = replay_checks(trainer, group, fns, "image_deepfm",
                                                       per_step, warm=warm)
    add_counts(held, counts)
    add_counts(held, replays_ran(trainer, per_step))
    del trainer
    release()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(image_pipeline(sparse=None), log_every=10**9, seed=seed,
                      steps_per_execution=k)
    trainer.init_state()
    record = graphed_fit(trainer, train, fns, "image_deepfm", None, epochs=1)
    bounds = table_bounds(trainer, train[0])
    # graphed steps after the epoch: examples/sec, host ms by stage, a trace
    timed = timed_replays(trainer, train[:k], "image_deepfm", per_step, bounds)
    in_graph = timed["profile"]["kernel_us_per_step"]
    split = image_split(timed["profile"])
    log(f"[image_deepfm] {timed['examples_per_sec']:.1f} examples/sec, step "
        f"{timed['step_ms']:.4f} ms, device busy {timed['device_busy_ms_per_step']:.4f} ms; host "
        "ms a step: " + ", ".join(f"{n} {v:.3f}" for n, v in timed["host_ms_per_step"].items())
        + "; device us a step: "
        + ", ".join(f"{n} {v:.1f}" for n, v in split.items())
        + "; the port's kernels in the graph against the bound: "
        + ", ".join(f"{n} {v:.1f} (bound {bounds[n][0] * 1e3:.1f}, {bounds[n][1]})"
                    for n, v in sorted(in_graph.items()))
        + f"; peak {timed['peak_memory_gb']:.3f} GB; " + top_kernels(timed["profile"]))
    work = tempfile.mkdtemp()
    try:
        weights = save_tower_weights(os.path.join(work, "tower.npz"), image_module(trainer))
        del trainer
        release()
        trainer = held_trainer(image_pipeline(sparse=True, weights_path=weights), seed)
        pretrained = image_module(trainer)
        frozen = [t.clone() for t in (*pretrained._tower.parameters(),
                                      *pretrained._tower.buffers())]
        scale_table(trainer, HELD_RMS)
        head = pretrained.head.weight.detach().clone()
        with fused_dedup("0"):
            records["pretrained_held"] = step_vs_plain(trainer, step, fns, "pretrained_held",
                                                       expect(**per_step))
            add_counts(held, records["pretrained_held"]["launches"])
            if torch.equal(head, pretrained.head.weight):
                raise AssertionError("pretrained: the held step did not move the head")
            trainer.steps_per_execution = k
            counts, records["pretrained_graph"] = replay_checks(
                trainer, group, fns, "image_pretrained", per_step, warm=warm)
        add_counts(held, counts)
        add_counts(held, replays_ran(trainer, per_step))
        still = [t for t in (*pretrained._tower.parameters(), *pretrained._tower.buffers())]
        if len(still) != len(frozen) or not all(same_bits(a, b) for a, b in zip(frozen, still)):
            raise AssertionError("pretrained: the frozen tower moved")
        log(f"[image_pretrained] a PretrainedImageInput over the saved tower: the head and "
            f"the table moved, the tower's {len(frozen)} tensors (weights and running "
            "statistics) did not; trained parameters: "
            + ", ".join(n for n, _ in pretrained.named_parameters()))
        del trainer, pretrained, frozen
        release()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    add_counts(held, check_lookups(fns))
    refused = check_not_jittable()
    return {**record, "timed": timed, "device_us_split": split, "held": records,
            "held_launches": held, "in_graph_us": in_graph, "bounds": dict(bounds),
            "tower_macs_per_image": macs, "not_jittable": refused}


# ---- phase 11: file-fed training, the parser, the CLI and checkpoints --------

# bench.py's file-fed configuration (bench.py:314-393): the Criteo DAC format
# has 26 categorical columns, so the first 26 of the bench's fields.
FILE_FIELD_SIZES = FIELD_SIZES[:26]
FILE_BYTES = 256 << 20
FILE_CHUNK_BYTES = 64 << 20     # 4 chunks: 3 chunk boundaries an epoch
FILE_BLOCK_ROWS = 131_072       # rows generated and written at a time
PARSE_CHECK_BYTES = 4 << 20     # C++ against the Python route, bit for bit
HOST_ONLY_BATCHES = 400         # as bench.py's host-pipeline-only count
FILE_PREFETCH = 8               # as bench.py's file-fed Trainer
CLI_HASH_SIZE = 1_264_800       # 26 x 1,264,800 = 32,884,800 rows
CLI_STEPS, CLI_RESUME_STEPS = 64, 16
CHECKPOINT_DISK_BYTES = 24 << 30  # two full-width checkpoints and a spare


def tsv_bytes(cols) -> bytes:
    """Rows of non-negative integers ``(n, c)`` as tab-separated decimal
    lines, formatted with numpy alone."""
    n, c = cols.shape
    width = len(str(int(cols.max())))
    cells = np.empty((n, c, width + 1), np.uint8)
    v = cols.astype(np.int32)
    for k in range(width - 1, -1, -1):
        cells[:, :, k] = v % 10 + 48
        v //= 10
    digits = np.ones(cols.shape, np.int32)
    for k in range(1, width):
        digits += cols >= 10 ** k
    keep = np.ones(cells.shape, bool)
    keep[:, :, :width] = np.arange(width)[None, None, :] >= (width - digits)[:, :, None]
    cells[:, :, width] = 9    # tab
    cells[:, -1, width] = 10  # newline
    return cells[keep].tobytes()


def write_criteo_file(path: str, seed: int, target_bytes: int) -> int:
    """A Criteo DAC TSV of about ``target_bytes`` as bench.py:319-342 makes
    one: a 0/1 label, 13 dense integers in [0, 1000) and 26 Zipf(1.2)
    tokens capped at ``FILE_FIELD_SIZES`` (the same token hashes to the same
    id, so the id stream keeps the bench's duplication).  Returns the rows."""
    rng = np.random.default_rng(seed)
    rows = 0
    with open(path, "wb") as f:
        while f.tell() < target_bytes:
            n = FILE_BLOCK_ROWS
            cols = np.empty((n, 1 + NUM_DENSE + len(FILE_FIELD_SIZES)), np.int64)
            cols[:, 0] = rng.integers(0, 2, n)
            cols[:, 1:1 + NUM_DENSE] = rng.integers(0, 1000, (n, NUM_DENSE))
            for i, v in enumerate(FILE_FIELD_SIZES):
                cols[:, 1 + NUM_DENSE + i] = np.minimum(rng.zipf(1.2, n) - 1, v - 1)
            f.write(tsv_bytes(cols))
            rows += n
    return rows


def same_arrays(a, b) -> bool:
    """Same dtype, shape and bits."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                               np.ascontiguousarray(b).view(np.uint8)))


def check_parser(path: str):
    """The parser on the card's host: the C++ route must be the one taken,
    bit-identical to the Python route on the file's first 4 MB; then its
    rows/sec on one whole chunk (best of 3)."""
    from torecsys_tpu_torch.data import native

    if not native.native_available():
        raise AssertionError("the card's host parses Criteo files in Python: the C++ parser "
                             "did not build or load")
    route = "c++"
    with open(path, "rb") as f:
        head = f.read(PARSE_CHECK_BYTES)
        f.seek(0)
        chunk = f.read(FILE_CHUNK_BYTES)
    head, chunk = head[:head.rfind(b"\n") + 1], chunk[:chunk.rfind(b"\n") + 1]
    cpp = native.parse_criteo_tsv(head, FILE_FIELD_SIZES)
    t0 = time.perf_counter()
    py = native.parse_criteo_tsv(head, FILE_FIELD_SIZES, force_python=True)
    python_s = time.perf_counter() - t0
    rows_head = len(cpp["label"])
    for k in ("label", "dense", "cats"):
        if not same_arrays(cpp[k], py[k]):
            raise AssertionError(f"C++ parse differs from the Python route at {k!r}")
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = native.parse_criteo_tsv(chunk, FILE_FIELD_SIZES)
        best = min(best, time.perf_counter() - t0)
    rows = len(out["label"])
    rec = {"route": route, "threads": os.cpu_count(), "check_rows": rows_head,
           "chunk_rows": rows, "chunk_mb": len(chunk) / 1e6, "rows_per_sec": rows / best,
           "mb_per_sec": len(chunk) / 1e6 / best,
           "python_rows_per_sec": rows_head / python_s}
    log(f"[file-parser] route {route}: C++ bit-identical to the Python route on the first "
        f"{len(head) / 1e6:.1f} MB ({rows_head} rows; labels, dense, cats); one "
        f"{len(chunk) / 1e6:.1f} MB chunk ({rows} rows) on {os.cpu_count()} threads, best of 3: "
        f"{rows / best:.1f} rows/sec, {len(chunk) / 1e6 / best:.1f} MB/s (Python route "
        f"{rows_head / python_s:.1f} rows/sec)")
    return rec


def file_loader(path: str):
    from torecsys_tpu_torch.data import CriteoFileIterable

    return CriteoFileIterable(path, FILE_FIELD_SIZES, batch_size=BATCH,
                              chunk_bytes=FILE_CHUNK_BYTES, shuffle=False)


def host_pipeline_only(path: str):
    """The file stream alone, no card in the loop (bench.py:380-390 without
    the presort, which the card's route does not run): examples/sec over
    ``HOST_ONLY_BATCHES`` batches or all the file has."""
    loader = file_loader(path)
    n = 0
    t0 = time.perf_counter()
    for _ in loader:
        n += 1
        if n >= HOST_ONLY_BATCHES:
            break
    eps = n * BATCH / (time.perf_counter() - t0)
    log(f"[file-host] CriteoFileIterable alone ({FILE_CHUNK_BYTES >> 20} MB chunks): {n} batches, "
        f"{eps:.1f} examples/sec")
    return {"batches": n, "examples_per_sec": eps}


def file_fed_training(path: str, seed: int, batches_per_epoch: int, out_dir):
    """bench.py's file-fed configuration through ``Trainer.fit``: two epochs
    of the stream at 8 steps a dispatch, prefetch 8, the automatic route and
    the bf16 tower.  The automatic choice must take the on-device sparse
    route; every step must launch its kernels (warm-up, capture and the
    remainders' eager steps counted by the wrappers, replays from a traced
    replay)."""
    import torch

    from torecsys_tpu_torch import Trainer

    fns = kernels()
    k = GRAPH_K
    loader = file_loader(path)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(bench_pipeline(FILE_FIELD_SIZES, sparse=None, compute="bfloat16"),
                      log_every=10**9, seed=seed, steps_per_execution=k, prefetch=FILE_PREFETCH)
    reset_counts(fns)
    first = trainer.fit(loader, max_epochs=1)
    trainer.host_ms = dict.fromkeys(trainer.host_ms, 0.0)
    t0 = time.perf_counter()
    second = trainer.fit(loader, max_epochs=1)
    epoch_s = time.perf_counter() - t0
    counts = read_counts(fns)
    if not (trainer.sparse and trainer._presorter is None):
        raise AssertionError("file-fed: the automatic choice did not take the on-device sparse "
                             "route")
    per_step = GRAPH_ROUTES["ondevice"][3]
    eager = 2 * k + 2 * (batches_per_epoch % k)  # warm-up, capture, each epoch's remainder
    check_counts("file-fed warm-up, capture and remainders", counts,
                 expect(**{n: eager * c for n, c in per_step.items()}))
    stats = dict(trainer.graph_stats)
    host = {n: v / batches_per_epoch for n, v in trainer.host_ms.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    traced = replay_profile(trainer, list(itertools.islice(iter(loader), k)), out_dir, "file")
    per_replay = traced["launches_per_replay"]
    if not per_replay:
        raise AssertionError("file-fed: the trace of a replay shows none of the port's kernels")
    total = {n: counts[n] + (stats["replays"] - stats["captures"]) * per_replay.get(n, 0)
             for n in counts}
    steps = 2 * batches_per_epoch
    if total != expect(**{n: steps * c for n, c in per_step.items()}):
        raise AssertionError(f"file-fed: launches {total} over {steps} steps, expected "
                             f"{per_step} a step")
    step_ms = epoch_s / batches_per_epoch * 1e3
    busy = traced["device_busy_ms_per_step"]
    log(f"[file-fed] auto choice: sparse, on-device; {batches_per_epoch} batches an epoch, "
        f"{stats['captures']} capture, {stats['replays']} replays; first epoch "
        f"{first['examples_per_sec']:.1f} examples/sec (warm-up and capture), second "
        f"{second['examples_per_sec']:.1f}; train_loss {second['train_loss']:.6f}; host ms/step "
        "(second epoch): " + " ".join(f"{n}={v:.3f}" for n, v in host.items())
        + f"; step {step_ms:.3f} ms, device busy {busy:.4f} ms/step ({busy / step_ms:.1%}); "
        f"peak allocated {peak:.3f} GB; launches {total} over {steps} steps")
    if not np.isfinite(second["train_loss"]):
        raise AssertionError(f"file-fed: non-finite loss {second}")
    del trainer
    release()
    return {"launches": total, "launches_counted": counts, "graph_stats": stats,
            "batches_per_epoch": batches_per_epoch,
            "examples_per_sec": second["examples_per_sec"],
            "first_epoch_examples_per_sec": first["examples_per_sec"],
            "train_loss": second["train_loss"], "host_ms_per_step": host,
            "step_ms": step_ms, "device_busy_ms_per_step": busy,
            "device_busy_share": busy / step_ms, "peak_memory_gb": peak, "profile": traced}


def checkpoint_tensors(path: str):
    """A checkpoint file's counters (step, loss_count) and every tensor by a
    flat name, on the CPU."""
    import torch

    saved = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    flat = {f"params/{n}": t for n, t in saved["params"].items()}
    for i, st in saved["dense_opt"]["state"].items():
        flat.update({f"dense_opt/{i}/{k}": v for k, v in st.items()})
    for table, slots in saved["row_slots"].items():
        flat.update({f"row_slots/{table}/{k}": v for k, v in slots.items()})
    flat["loss_sum"] = saved["loss_sum"]
    return {"step": saved["step"], "loss_count": saved["loss_count"]}, flat


def live_tensors(trainer):
    """The trainer's live counters and state under
    :func:`checkpoint_tensors`' names."""
    seq, opt = trainer.pipeline.sequential, trainer.state.opt_state
    flat = {f"params/{n}": p for n, p in seq.named_parameters()}
    dense = opt["dense"] if isinstance(opt, dict) else opt
    for i, st in dense.state_dict()["state"].items():
        flat.update({f"dense_opt/{i}/{k}": v for k, v in st.items()})
    for table, slots in (opt["sparse"].items() if isinstance(opt, dict) else ()):
        flat.update({f"row_slots/{table}/{k}": v for k, v in slots.items()})
    flat["loss_sum"] = trainer.state.loss_sum
    counters = {"step": int(trainer.state.step), "loss_count": int(trainer.state.loss_count)}
    return counters, flat


def differing(a, b):
    """Names of the tensors that differ in bits between ``a`` and ``b``
    (each compared on ``a``'s device), and those only one of them has."""
    import torch

    return sorted(set(a) ^ set(b)) + [
        n for n in a if n in b
        and not torch.equal(bits(a[n].detach()), bits(b[n].detach().to(a[n].device)))]


def cli_launches(what: str, counts, stats, per_replay, steps: int):
    """A CLI train command's launches: the wrappers' counts (warm-up and
    capture) plus its replays after the capture x a traced replay's, held to
    ``steps`` x the on-device route's launches a step."""
    total = {n: counts[n] + (stats["replays"] - stats["captures"]) * per_replay.get(n, 0)
             for n in counts}
    per_step = GRAPH_ROUTES["ondevice"][3]
    if total != expect(**{n: steps * c for n, c in per_step.items()}):
        raise AssertionError(f"cli {what}: launches {total} over {steps} steps (counted "
                             f"{counts}, graph {stats}), expected {per_step} a step")
    return total


def cli_round_trip(path: str, work: str, out_dir):
    """The port's CLI in this process (``cli.run``, which returns the
    trainer), at full width on the file: train 64 steps with a checkpoint,
    whose file must hold the trainer's live state to the bit; a trainer
    restored from it (the state to the bit, twice in place; its save again,
    to the bit); the same train command again, which must resume and take
    16 more steps and equal the first trainer taking the same 16 steps
    straight on (losses and state to the bit, CUDA graph replays against a
    fresh warm-up and capture); evaluate from the last checkpoint.  Each
    train command's launches are its counted ones plus its replays x a
    traced replay's, held to its steps x the on-device route's per step."""
    import io

    import torch

    from torecsys_tpu_torch import cli
    from torecsys_tpu_torch.train import Pipeline, Trainer
    from torecsys_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint

    fns = kernels()
    ckpt_dir = os.path.join(work, "ckpts")
    model = {"method": "DeepFM", "deep_layer_sizes": list(TOWER)}
    data = ["--train_file", path, "--stream", "on", "--criteo_hash_size", str(CLI_HASH_SIZE),
            "--embed_size", str(EMBED), "--batch_size", str(BATCH)]
    train = ["train", "--model_config", json.dumps(model), *data,
             "--steps_per_execution", str(GRAPH_K), "--checkpoint_dir", ckpt_dir]

    def run(argv):
        out = io.StringIO()
        reset_counts(fns)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = cli.run(argv)
        seconds = time.perf_counter() - t0
        return result, json.loads(out.getvalue().strip().splitlines()[-1]), seconds, \
            read_counts(fns)

    first_trainer, first, first_s, first_counts = run(
        [*train, "--max_num_iterations", str(CLI_STEPS)])
    first_stats = dict(first_trainer.graph_stats)
    if first_trainer.device.type != DEVICE or not (
            first_trainer.sparse and first_trainer._presorter is None):
        raise AssertionError(f"cli train: runs on {first_trainer.device}, sparse="
                             f"{first_trainer.sparse}, presorted="
                             f"{first_trainer._presorter is not None}; expected the card's "
                             "on-device sparse route")
    ckpt = latest_checkpoint(ckpt_dir)
    if ckpt is None or os.path.basename(ckpt) != f"ckpt_{CLI_STEPS}.pt":
        raise AssertionError(f"cli train: checkpoint {ckpt}, expected ckpt_{CLI_STEPS}.pt")
    gb = os.path.getsize(ckpt) / 1e9
    # the file holds what the trainer that wrote it holds
    counters, saved = checkpoint_tensors(ckpt)
    held, live = live_tensors(first_trainer)
    differ = differing(live, saved)
    if counters != held or counters["step"] != CLI_STEPS or differ:
        raise AssertionError(f"cli train: ckpt_{CLI_STEPS}.pt is not the trainer's state: "
                             f"counters {counters} against {held}, differ {differ}")
    del live
    # a trainer restored from the checkpoint, built as the CLI builds it
    pipeline = Pipeline.build(objective="ctr",
                              inputs_config=cli._criteo_schema_inputs(CLI_HASH_SIZE, EMBED),
                              model_config=model, load_from=ckpt)
    trainer = Trainer(pipeline, resume=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if trainer.device.type != DEVICE or not trainer.sparse:
        raise AssertionError(f"cli: the restored trainer runs on {trainer.device}, "
                             f"sparse={trainer.sparse}")
    _, live = live_tensors(trainer)
    ptrs = {n: t.data_ptr() for n, t in live.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restore_checkpoint(ckpt, trainer.pipeline.sequential, trainer.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    held, live = live_tensors(trainer)
    moved = [n for n, t in live.items() if t.data_ptr() != ptrs.get(n)]
    differ = differing(live, saved)
    if held != counters or moved or differ:
        raise AssertionError(f"cli: restore not to the bit or not in place: counters {held} "
                             f"against {counters}, moved {moved}, differ {differ}")
    resave = os.path.join(work, "resave.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_checkpoint(resave)
    save_s = time.perf_counter() - t0
    counters2, again = checkpoint_tensors(resave)
    differ = differing(again, saved)
    if counters2 != counters or differ:
        raise AssertionError(f"cli: a restored state saved again differs from its checkpoint: "
                             f"counters {counters2} against {counters}, differ {differ}")
    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    log(f"[cli] train {CLI_STEPS} steps in {first_s:.1f} s (train_loss "
        f"{first['train_loss']:.6f}); checkpoint {os.path.basename(ckpt)} {gb:.3f} GB: the "
        f"trainer's live state to the bit ({len(saved)} tensors, step and loss_count); table "
        f"{tuple(table.shape)}, restored to the bit, twice in place (no tensor moved); "
        f"init_state with the restore {init_s:.2f} s, the restore again (file in the page "
        f"cache) {restore_s:.2f} s; save {save_s:.2f} s ({gb / save_s:.2f} GB/s), saved again "
        "to the bit")
    del trainer, pipeline, live, saved, again, table
    os.remove(resave)
    release()
    resumed, second, second_s, resumed_counts = run(
        [*train, "--max_num_iterations", str(CLI_RESUME_STEPS)])
    resumed_stats = dict(resumed.graph_stats)
    last = latest_checkpoint(ckpt_dir)
    want = f"ckpt_{CLI_STEPS + CLI_RESUME_STEPS}.pt"
    if last is None or os.path.basename(last) != want:
        raise AssertionError(f"cli: the second train did not resume: newest checkpoint "
                             f"{last}, expected {want}")
    # the first trainer takes the resumed run's 16 steps straight on: its
    # loader as the CLI builds it, a fresh epoch 0 as the resumed run's
    args = cli.make_parser().parse_args(train)
    loader = lambda: cli._streaming_loader(  # noqa: E731
        args.train_file, args.criteo_hash_size, args.target_fields, args.batch_size,
        args.stream_chunk_mb, shuffle=True)
    first_trainer.checkpoint_dir = None
    straight = first_trainer.fit(loader(), max_epochs=1, max_steps=CLI_RESUME_STEPS)
    counters, live = live_tensors(first_trainer)
    held, resumed_live = live_tensors(resumed)
    differ = differing(live, resumed_live)
    if straight["train_loss"] != second["train_loss"] or counters != held or differ:
        raise AssertionError(f"cli: the resumed run differs from {CLI_STEPS} + "
                             f"{CLI_RESUME_STEPS} steps straight through: train_loss "
                             f"{second['train_loss']!r} against {straight['train_loss']!r}, "
                             f"counters {held} against {counters}, differ {differ}")
    del live, resumed_live, resumed
    release()
    traced = replay_profile(first_trainer, list(itertools.islice(iter(loader()), GRAPH_K)),
                            out_dir, "cli")
    per_replay = traced["launches_per_replay"]
    train_total = cli_launches(f"train {CLI_STEPS}", first_counts, first_stats, per_replay,
                               CLI_STEPS)
    resume_total = cli_launches(f"train again {CLI_RESUME_STEPS}", resumed_counts,
                                resumed_stats, per_replay, CLI_RESUME_STEPS)
    del first_trainer
    os.remove(ckpt)
    release()
    _, metrics, eval_s, _ = run(["evaluate", "--model_config", json.dumps(model), "--load_from",
                                 last, "--eval_file", path, *data[2:]])
    if not (0.0 <= metrics["val_auc"] <= 1.0 and np.isfinite(metrics["val_logloss"])):
        raise AssertionError(f"cli evaluate: {metrics}")
    log(f"[cli] train again: resumed from step {CLI_STEPS}, {CLI_RESUME_STEPS} more steps in "
        f"{second_s:.1f} s -> {os.path.basename(last)}, equal to the first trainer taking "
        f"them straight on (train_loss {second['train_loss']:.6f}, every tensor to the bit); "
        f"launches: train {train_total} ({first_stats}), train again {resume_total} "
        f"({resumed_stats}); evaluate --load_from in {eval_s:.1f} s: {metrics}")
    os.remove(last)
    release()
    launches = {n: train_total[n] + resume_total[n] for n in train_total}
    return {"launches": launches, "launches_train": train_total,
            "launches_resume": resume_total, "first_train_s": first_s,
            "resume_train_s": second_s, "evaluate_s": eval_s, "checkpoint_gb": gb,
            "save_s": save_s, "init_with_restore_s": init_s, "restore_s": restore_s,
            "train": first, "resumed": second, "evaluate": metrics, "profile": traced}


def phase_file(seed: int, out_dir):
    """Phase 11: a 256 MB Criteo DAC file, written here and deleted at the
    end, through the parser, the stream alone, ``Trainer.fit`` (bench.py's
    file-fed configuration) and the port's CLI with checkpoints."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_file_")
    try:
        free = shutil.disk_usage(work).free
        if free < CHECKPOINT_DISK_BYTES + 2 * FILE_BYTES:
            raise AssertionError(f"{work}: {free / 1e9:.1f} GB free, the checkpoints need "
                                 f"{CHECKPOINT_DISK_BYTES / 1e9:.1f}")
        path = os.path.join(work, "criteo.tsv")
        t0 = time.perf_counter()
        rows = write_criteo_file(path, seed + 8, FILE_BYTES)
        size = os.path.getsize(path)
        if size <= 3 * FILE_CHUNK_BYTES:
            raise AssertionError("the file crosses fewer than 3 chunk boundaries")
        batches = file_loader(path).shard_batch_counts()[0]
        log(f"[file] {rows} rows, {size / 1e6:.1f} MB in {time.perf_counter() - t0:.1f} s "
            f"({-(-size // FILE_CHUNK_BYTES)} chunks of {FILE_CHUNK_BYTES >> 20} MB, {batches} "
            f"batches of {BATCH}); {free / 1e9:.1f} GB free under {work}")
        parser = check_parser(path)
        host = host_pipeline_only(path)
        fed = file_fed_training(path, seed, batches, out_dir)
        cli = cli_round_trip(path, work, out_dir)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"file": {"rows": rows, "bytes": size, "batches_per_epoch": batches},
            "parser": parser, "host_only": host, "fed": fed, "cli": cli}


# ---- --auto-sweep: the automatic choice's crossover --------------------------

SWEEP_ROWS = (62_500, 125_000, 250_000, 500_000, 1_000_000, 2_000_000, 3_000_000, 4_000_000,
              8_000_000, 16_000_000)
SWEEP_WARM_DISPATCHES = 2
SWEEP_TIMED_DISPATCHES = 8
SWEEP_REPEATS = 3
SWEEP_EAGER_STEPS = 16


def sweep_field_sizes(rows: int):
    """The bench's 28 field sizes scaled to ``rows`` logical rows in all."""
    total = sum(FIELD_SIZES)
    sizes = [max(1, int(v * rows / total)) for v in FIELD_SIZES]
    sizes[0] += rows - sum(sizes)
    return tuple(sizes)


def phase_auto_sweep(seed: int):
    """Dense route against the presorted and the on-device sparse routes at
    table sizes from 62.5k to 16M logical rows (E = 16, the bench's field
    proportions, batch 4096, bf16 tower).  Per size and route one trainer:
    two warm-up dispatches of 8 steps (the capture among them), then
    ``SWEEP_REPEATS`` timed runs of ``SWEEP_TIMED_DISPATCHES`` dispatches
    (their median kept), then ``SWEEP_EAGER_STEPS`` eager steps (K = 1).
    The crossover of each sparse route is the smallest size from which its
    median beats the dense route's at every larger size, at K = 8."""
    import torch

    from torecsys_tpu_torch import Trainer

    k = GRAPH_K
    n = (SWEEP_WARM_DISPATCHES + SWEEP_TIMED_DISPATCHES) * k
    raw = make_batches(seed + 7, n)
    routes = {"dense": (False, None), "presorted": (True, True), "ondevice": (True, False)}
    results = {}
    for rows in SWEEP_ROWS:
        sizes = sweep_field_sizes(rows)
        batches = [{**b, **{f"cat_{i}": np.minimum(b[f"cat_{i}"], v - 1)
                            for i, v in enumerate(sizes)}} for b in raw]
        warm, timed = batches[:SWEEP_WARM_DISPATCHES * k], batches[SWEEP_WARM_DISPATCHES * k:]
        row = {}
        for route, (sparse, presort) in routes.items():
            trainer = Trainer(bench_pipeline(sizes, sparse, "bfloat16"), log_every=10**9,
                              seed=seed, presort=presort, steps_per_execution=k)
            trainer.train_steps(warm)
            runs = []
            for _ in range(SWEEP_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_steps(timed)
                torch.cuda.synchronize()
                runs.append(BATCH * len(timed) / (time.perf_counter() - t0))
            row[f"{route}_k{k}"] = float(np.median(runs))
            row[f"{route}_k{k}_runs"] = runs
            trainer.steps_per_execution = 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_steps(timed[:SWEEP_EAGER_STEPS])
            torch.cuda.synchronize()
            row[f"{route}_k1"] = BATCH * SWEEP_EAGER_STEPS / (time.perf_counter() - t0)
            if trainer.sparse != sparse or (trainer._presorter is not None) != bool(presort):
                raise AssertionError(f"auto-sweep: {route} took another route")
            del trainer
            release()
        elements = packed_elements(rows)
        log(f"[auto-sweep] rows={rows} elements={elements}: " + " ".join(
            f"{key}={v:.1f}" for key, v in row.items() if not key.endswith("_runs")))
        results[rows] = {"elements": elements, **row}
    for route in ("presorted", "ondevice"):
        wins = [r for r in SWEEP_ROWS
                if all(results[q][f"{route}_k{k}"] > results[q][f"dense_k{k}"]
                       for q in SWEEP_ROWS if q >= r)]
        edge = wins[0] if wins else None
        log(f"[auto-sweep] {route} beats dense at K={k} from {edge} rows "
            f"({packed_elements(edge) if edge else None} elements) on")
        results[f"{route}_crossover_rows"] = edge
    return results


def packed_elements(rows: int) -> int:
    from torecsys_tpu_torch.ops.embedding import packed_shape

    vp, w = packed_shape(rows, EMBED)
    return vp * w


# ---- phase 23: parallel ---------------------------------------------------------

# (mesh, strategy) of the parallel phase's runs: (2, 2) row-shards the bench
# table (4,110,550 stored rows divide 2); at (1, 4) the rule replicates it
# (they do not divide 4) and its lookups still route through the collective
PARALLEL_RUNS = (((2, 2), "psum"), ((2, 2), "alltoall"), ((2, 2), "auto"), ((1, 4), "psum"))
PARALLEL_RANKS = 4
PARALLEL_HELD = 2         # held steps a run, each from one state
PARALLEL_FIT = 6          # batches of each run's fit
PARALLEL_TIMED = 8        # timed eager steps a run over NCCL
PARALLEL_TIMEOUT_S = 300
PARALLEL_GRAPH_K = 4      # steps a dispatch of the NCCL graph check
# the sharded step's launches: the lookup's gather and the grad permute,
# the wide segment sum, the row update (a replicated table's too)
PARALLEL_PER_STEP = dict(row_gather=2, widen_segment_sum=1, fused_rowwise_update=1)
# the planted overflow: one field of 2^20 rows (131,072 stored rows, sharded
# at 4), every id in its first eighth, table rank 0's rows; at (1, 4) and
# capacity factor 1 the exchange overflows until the factor reaches 4
OVERFLOW_FIELD = 1 << 20
OVERFLOW_MESH = (1, 4)
OVERFLOW_OPTIONS = {"strategy": "alltoall", "capacity_factor": 1.0}
COLLECTIVE_KINDS = (("all_reduce", "AllReduce"), ("all_gather", "AllGather"),
                    ("all_to_all", "SendRecv"), ("all_to_all", "AllToAll"))
# The dense-route runs: the bench DeepFM (28 fields, E = 16, tower 400-400-400,
# batch 4096) with sparse_embeddings=False under the dense optimizers that
# reduce over a whole parameter, LAMB and Adafactor, at (2, 2), the table
# row-sharded.  Each field is capped at ROWS_CAP rows (12,884,400 rows,
# 1,610,550 stored rows of 128; the cap is the only cut): each held step
# gathers the table and its optimizer state over the table group twice, to
# hold the logical state against the single-device step, and at the full
# 32.9M rows four ranks sharing one card would stage 2.5x the bytes through
# the host for gloo.  The checkpoint round trip runs Adafactor and SM3 on
# the same table; the ltr step is phase 15's NCF + BPR.
PARALLEL_DENSE_FIELDS = tuple(min(v, ROWS_CAP) for v in FIELD_SIZES)
PARALLEL_DENSE_RUNS = (((2, 2), "lamb"), ((2, 2), "adafactor"))
PARALLEL_DENSE_LR = 1e-3
PARALLEL_DENSE_FIT = 2    # batches of each dense run's fit
PARALLEL_CKPT_OPTIMIZERS = ("adafactor", "sm3")
# a dense step's launches on every rank: the lookup's gather and the table
# gradient's permute, the table gradient's sum (as on one device)
PARALLEL_DENSE_PER_STEP = DENSE_PER_STEP


def parallel_table(trainer):
    from torecsys_tpu_torch.train.sparse import sparse_modules

    (module,) = sparse_modules(trainer.pipeline.sequential).values()
    return module


def touched_rows(trainer, batch):
    """The global stored rows a host batch's ids touch, ascending, on the card."""
    import torch

    module = parallel_table(trainer)
    ids = np.stack([batch[f] for f in module.fields], axis=1).astype(np.int64)
    ids = ids + module.offsets.cpu().numpy()[None, :]
    rows = np.unique(ids // module.pack)
    return torch.as_tensor(rows, device=module.embedding.device)


def gather_rows(trainer, mesh, rows):
    """(table rows, Adam moments) of global stored ``rows`` from a sharded
    trainer: each table rank fills the rows it owns, and a sum over the
    table group gives every rank all of them."""
    import torch

    module = parallel_table(trainer)
    table, (path, slots) = module.table_view(), next(iter(trainer.state.opt_state["sparse"]
                                                          .items()))
    mv = slots["mv"]
    layout = module.row_layout
    if layout is None:
        return table[rows].clone(), mv[rows].clone()
    mine = layout.served(rows)
    local = layout.local(rows)[mine]
    t_rows = torch.zeros((rows.shape[0], table.shape[1]), device=table.device)
    m_rows = torch.zeros((rows.shape[0], *mv.shape[1:]), device=table.device)
    t_rows[mine] = table[local]
    m_rows[mine] = mv[local]
    mesh.all_reduce(t_rows, "table")
    mesh.all_reduce(m_rows, "table")
    return t_rows, m_rows


def dense_view(trainer):
    """``{name: tensor}`` of the dense parameters and their Adam state."""
    seq = trainer.pipeline.sequential
    table = {name for name, _ in seq.named_parameters() if name.endswith("embedding")}
    opt = trainer.state.opt_state["dense"]
    named = {n: p for n, p in seq.named_parameters() if n not in table}
    out = dict(named)
    for n, p in named.items():
        for k, v in opt.state.get(p, {}).items():
            if k != "step":
                out[f"{n}:{k}"] = v
    return out


def sync_reference(ref, trainer, rows, t_rows, m_rows):
    """Put the sharded trainer's state into the single-device reference: the
    touched rows of the table and its moments, the dense parameters and
    their Adam state, the step."""
    import torch

    with torch.no_grad():
        module = parallel_table(ref)
        module.table_view()[rows] = t_rows
        next(iter(ref.state.opt_state["sparse"].values()))["mv"][rows] = m_rows
        mine = dict(trainer.pipeline.sequential.named_parameters())
        for n, p in ref.pipeline.sequential.named_parameters():
            if not n.endswith("embedding"):
                p.copy_(mine[n])
        opt_s, opt_r = trainer.state.opt_state["dense"], ref.state.opt_state["dense"]
        for ps, pr in zip((p for g in opt_s.param_groups for p in g["params"]),
                          (p for g in opt_r.param_groups for p in g["params"])):
            state = opt_s.state.get(ps)
            if state:
                opt_r.state[pr] = {k: v.clone() if isinstance(v, torch.Tensor) else v
                                   for k, v in state.items()}
            else:
                opt_r.state.pop(pr, None)
        ref.state.step.copy_(trainer.state.step)


def row_sensitivity(ref, sums, rows, m_rows, step: int):
    """Adam's sensitivity (:func:`adam_sensitivity`) of the touched rows."""
    import torch

    module = parallel_table(ref)
    row = ref.pipeline.row_optimizer()
    g, a, n = (b[rows].double() for b in sums[module.embedding.data_ptr()])
    t = step + 1
    d = 2.0 * (n - 1).clamp_min(1.0) * SUM_UNIT * a
    m0, v0 = m_rows[:, 0].double(), m_rows[:, 1].double()
    bc1, bc2 = 1.0 - row.b1 ** t, 1.0 - row.b2 ** t

    def update(x):
        m_hat = (row.b1 * m0 + (1 - row.b1) * x) / bc1
        v_hat = (row.b2 * v0 + (1 - row.b2) * x * x) / bc2
        return row.learning_rate * m_hat / (torch.sqrt(v_hat) + row.eps)

    u = update(g)
    sens = torch.maximum((update(g + d) - u).abs(), (update(g - d) - u).abs())
    return torch.where(n > 0, sens, torch.zeros_like(sens)).float()


def parallel_held_step(trainer, ref, mesh, batch, fns, path: str):
    """One step from one state: the single-device reference (rank 0) with
    the plain versions, the sharded trainer with the kernels on every rank;
    rank 0 holds every tensor the step changes (the touched rows of the
    table and its moments, the dense parameters and their Adam state) by
    :func:`held_compare`.  Returns rank 0's record (None elsewhere)."""
    import torch

    rows = touched_rows(trainer, batch)
    t0, m0 = gather_rows(trainer, mesh, rows)
    record = None
    if ref is not None:
        sync_reference(ref, trainer, rows, t0, m0)
        start = {"table": t0, "mv": m0, **{k: v.clone() for k, v in dense_view(ref).items()}}
        step = int(ref.state.step)
        with abs_sums() as sums, plain_versions(fns):
            loss_p = ref.train_steps([batch])[0].item()
        sens = row_sensitivity(ref, sums, rows, m0, step)
        del sums
        module = parallel_table(ref)
        plain = {"table": module.table_view()[rows].clone(),
                 "mv": next(iter(ref.state.opt_state["sparse"].values()))["mv"][rows].clone(),
                 **{k: v.clone() for k, v in dense_view(ref).items()}}
    loss_k = trainer.train_steps([batch])[0].item()
    t1, m1 = gather_rows(trainer, mesh, rows)
    if ref is None:
        return None
    kernel = {"table": t1, "mv": m1, **dense_view(trainer)}
    worst, where, moved = 0.0, "all equal", None
    for name, k in kernel.items():
        s = start.get(name)
        if s is None:  # Adam's state, built at this step from 0
            s = torch.zeros_like(k)
        ratio, at, ulps, _ = held_compare(s, plain[name], k, sens if name == "table" else None)
        if name == "table":
            moved = ulps
        if not ratio <= worst:
            worst, where = ratio, f"{name}[{at}]"
    rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[{path}] sharded kernels vs the single-device plain step, one step from one state: "
        f"loss {loss_k:.8f} vs {loss_p:.8f} (rel diff {rel:.3g}, rtol {TRAIN_LOSS_RTOL}); "
        f"{rows.shape[0]} touched stored rows, their moments, the dense parameters and their "
        f"Adam state: worst |sharded - plain| / tolerance {worst:.3g} ({where}); the table's "
        f"largest change {moved:.4g} ulps")
    if not np.isfinite(loss_k) or not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{path}: the sharded and the single-device losses disagree")
    if not worst <= 1.0:
        raise AssertionError(f"{path}: the sharded step and the single-device one differ "
                             f"beyond the tolerance at {where}, {worst:.3g} times it")
    if not moved >= HELD_MOVED_ULPS:
        raise AssertionError(f"{path}: the table moved {moved} ulps, under {HELD_MOVED_ULPS}")
    return {"loss_sharded": loss_k, "loss_plain": loss_p, "worst_over_tolerance": worst,
            "worst": where, "touched_rows": int(rows.shape[0]), "table_moved_ulps": moved}


def collective_profile(trainer, batches, mesh):
    """A traced window of eager steps on this rank: the card's busy share
    (the union of its kernel and copy intervals over the window's device
    span) and the device ms of NCCL's kernels by kind, a step."""
    import torch

    with card_profile() as prof:
        trainer.train_steps(batches)
        torch.cuda.synchronize()
    events = device_events(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0]
    by_kind = {}
    for e in events:
        if "nccl" not in e.name.lower():
            continue
        kind = next((k for k, mark in COLLECTIVE_KINDS if mark in e.name), e.name[:40])
        by_kind[kind] = by_kind.get(kind, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    n = len(batches)
    return {"device_busy_share": busy / window, "device_busy_ms_per_step": busy / 1e3 / n,
            "collective_ms_per_step": {k: v / n for k, v in by_kind.items()}}


def parallel_run(mesh, strategy: str, batches, fns, reference: bool, timed: bool):
    """One configuration on this rank: the held steps, a short ``fit``, and
    over NCCL the timings.  The wrappers count from the first sharded step
    to the end of the fit."""
    import torch

    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.parallel.lookup import (LookupContext, modeled_comm_mb,
                                                    resolve_strategy)

    path = f"parallel_{mesh.shape['data']}x{mesh.shape['table']}_{strategy}"
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(bench_pipeline(sparse=True), mesh=mesh, presort=False, log_every=10**9,
                      lookup_options={"strategy": strategy})
    trainer.init_state()
    ref = None
    if reference:
        ref = Trainer(bench_pipeline(sparse=True), presort=False, log_every=10**9)
        ref.init_state()
    module = parallel_table(trainer)
    layout = module.row_layout
    reset_counts(fns)
    held = [parallel_held_step(trainer, ref, mesh, b, fns, path)
            for b in batches[:PARALLEL_HELD]]
    del ref
    release()
    fit_batches = batches[PARALLEL_HELD:PARALLEL_HELD + PARALLEL_FIT]
    metrics = trainer.fit(lambda: iter(fit_batches), max_epochs=1)
    steps = PARALLEL_HELD + len(fit_batches)
    counts = read_counts(fns)
    want = expect(**{n: steps * c for n, c in PARALLEL_PER_STEP.items()})
    if counts != want:
        raise AssertionError(f"{path} rank {mesh.rank}: kernel launches {counts}, expected {want}")
    m = BATCH * len(FIELD_SIZES)
    ts, dp = mesh.shape["table"], mesh.shape["data"]
    ctx_strategy = resolve_strategy(LookupContext(mesh=mesh, strategy=strategy), m, EMBED)
    rec = {"path": path, "strategy": strategy, "resolved": ctx_strategy,
           "table": {"sharded": layout is not None,
                     "local_shape": list(module.embedding.shape)},
           "held": held, "fit_loss": metrics["train_loss"],
           "fit_examples_per_sec": metrics["examples_per_sec"], "launches": counts,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "modeled_comm_mb": modeled_comm_mb(ctx_strategy, m, EMBED, 2.0, ts, dp)}
    if timed:
        rec.update(timed_mesh_steps(trainer, mesh, batches[:PARALLEL_TIMED]))
    if mesh.rank == 0:
        log(f"[{path}] rank 0: table {'row-sharded' if layout else 'replicated'} "
            f"{tuple(module.embedding.shape)}, strategy {strategy} -> {ctx_strategy}, fit loss "
            f"{metrics['train_loss']:.6f}, launches {counts}, peak "
            f"{rec['peak_memory_gb']:.3f} GB"
            + (f", step {rec['step_ms']:.3f} ms, {rec['examples_per_sec']:.0f} examples/sec, busy "
               f"{rec['device_busy_share']:.3f}, collective ms/step {rec['collective_ms_per_step']}"
               f", MB/step sent {rec['collective_mb_per_step']} (modeled "
               f"{rec['modeled_comm_mb']:.3f})" if timed else ""))
    del trainer
    release()
    return rec


def overflow_batch(seed: int):
    rng = np.random.default_rng(seed)
    return {"cat_0": rng.integers(0, OVERFLOW_FIELD // 8, BATCH).astype(np.int32),
            "dense_0": rng.normal(size=BATCH).astype(np.float32),
            "label": (rng.uniform(size=BATCH) < 0.5).astype(np.float32)}


def parallel_overflow(mesh, seed: int):
    """The planted stream (every id in table rank 0's rows) under the
    all-to-all at capacity factor 1: one step's loss is NaN; ``fit``
    without recovery raises ``LookupOverflowSuspected``; with it, ``fit``
    raises the factor to the table axis' size and completes."""
    from torecsys_tpu_torch import Inputs, Pipeline, Trainer, ValueInput
    from torecsys_tpu_torch.inputs import MultiIndicesEmbedding
    from torecsys_tpu_torch.train.trainer import LookupOverflowSuspected

    def pipeline():
        inputs = Inputs({"feat_inputs": ValueInput(("dense_0",)),
                         "emb_inputs": MultiIndicesEmbedding(EMBED, (OVERFLOW_FIELD,),
                                                             ("cat_0",), device=DEVICE)})
        return (Pipeline(device=DEVICE).set_objective("ctr").set_inputs(inputs).set_model("FM")
                .set_criterion("BCEWithLogitsLoss").set_optimizer("Adam", lr=1e-3)
                .set_sparse_embeddings(True).set_target_fields("label"))

    batch = overflow_batch(seed)
    poisoned = Trainer(pipeline(), mesh=mesh, presort=False, log_every=1,
                       lookup_options=dict(OVERFLOW_OPTIONS), lookup_recovery=False)
    loss = poisoned.train_steps([batch])[0].item()
    if not np.isnan(loss):
        raise AssertionError(f"the planted overflow gave a finite loss {loss}")
    try:
        Trainer(pipeline(), mesh=mesh, presort=False, log_every=1,
                lookup_options=dict(OVERFLOW_OPTIONS), lookup_recovery=False).fit([batch])
        raise AssertionError("fit without recovery did not raise on the planted overflow")
    except LookupOverflowSuspected as e:
        error = str(e)
    recovering = Trainer(pipeline(), mesh=mesh, presort=False, log_every=1,
                         lookup_options=dict(OVERFLOW_OPTIONS))
    metrics = recovering.fit([batch])
    ts = mesh.shape["table"]
    if not np.isfinite(metrics["train_loss"]) or (
            recovering.lookup_options["capacity_factor"] != ts):
        raise AssertionError(f"the recovery ended at {recovering.lookup_options} with "
                             f"{metrics}")
    return {"poisoned_loss": float(loss), "error": error[:160],
            "recoveries": recovering.recoveries, "loss": metrics["train_loss"],
            "capacity_factor": recovering.lookup_options["capacity_factor"]}


def parallel_graph(mesh, batches, pipeline=None, label: str = "sparse"):
    """Over NCCL, whose collectives a CUDA graph captures: ``fit`` at
    PARALLEL_GRAPH_K steps a dispatch (the first dispatch warms up and
    captures, the next replays), then one replay against its steps taken
    eagerly from one state, the losses to the bit.  ``pipeline``: the bench
    DeepFM on the sparse route by default."""
    import torch

    from torecsys_tpu_torch import Trainer

    k = PARALLEL_GRAPH_K
    pipeline = bench_pipeline(sparse=True) if pipeline is None else pipeline
    trainer = Trainer(pipeline, mesh=mesh, presort=False, log_every=10**9,
                      steps_per_execution=k)
    metrics = trainer.fit(lambda: iter(batches[:2 * k]), max_epochs=1)
    stats = trainer.graph_stats
    if stats != {"captures": 1, "replays": 1} or not np.isfinite(metrics["train_loss"]):
        raise AssertionError(f"graphed fit under {mesh}: {stats}, {metrics}")
    start = snapshot(trainer)
    graphed = [x.item() for x in trainer.train_steps(batches[:k])]
    restore(trainer, start)
    trainer.steps_per_execution = 1
    eager = [x.item() for x in trainer.train_steps(batches[:k])]
    torch.cuda.synchronize()
    if graphed != eager:
        raise AssertionError(f"a replay under {mesh} is not its eager steps: {graphed} {eager}")
    if mesh.rank == 0:
        log(f"[parallel-nccl] {label} {mesh.shape} at {k} steps a dispatch: captured once, a "
            f"replay equals its {k} eager steps to the bit ({graphed[-1]:.8f})")
    del trainer, start
    release()
    return {"graph_stats": stats, "losses": graphed}


def dense_parallel_pipeline(optimizer: str):
    """The bench DeepFM on the dense route over the capped fields, under the
    named dense optimizer at PARALLEL_DENSE_LR."""
    return ctr_pipeline("DeepFM", {"deep_layer_sizes": TOWER}, PARALLEL_DENSE_FIELDS,
                        sparse=False, optimizer=(optimizer, PARALLEL_DENSE_LR))


def mesh_kept(trainer, mesh, keep: bool):
    """:func:`kept_tensors` of a mesh trainer as the logical state, cloned:
    each tensor that holds a row-sharded table's rows (the table, and each
    optimizer state tensor that ``state_row_axis`` places on the rows)
    gathered over the table group in row order; the others as they are.
    Every rank takes part in the gathers; only with ``keep`` is the result
    kept (None elsewhere)."""
    from torecsys_tpu_torch.parallel.sharding import _table_owners, axis_layout
    from torecsys_tpu_torch.train.optimizers import state_row_axis

    seq = trainer.pipeline.sequential
    dense_opt, _ = _optimizers(trainer)
    layouts = {n: m.row_layout for n, m in _table_owners(seq).items()
               if m.row_layout is not None and m.row_layout.sharded}
    params = dict(seq.named_parameters())
    out = {}
    for name, t in kept_tensors(trainer).items():
        base, _, key = name.partition(":")
        layout = layouts.get(base)
        if layout is not None and key:
            layout = axis_layout(layout, state_row_axis(dense_opt, params[base], key, t))
        if layout is None:
            logical = t.clone() if keep else None
        else:
            parts = mesh.all_gather(t, "table")
            logical = (parts.reshape(-1, *t.shape[1:]) if layout.blocks == 1 else
                       parts.movedim(0, 1).reshape(t.shape[0], -1, *t.shape[2:]))
            del parts
            if not keep:
                logical = None
        out[name] = logical
    return out if keep else None


def sync_logical(ref, start) -> None:
    """Put a logical state (:func:`mesh_kept`) into the single-device
    reference trainer: parameters, running statistics, the dense optimizer's
    state (built for a parameter that has none yet) and the step."""
    import torch

    from torecsys_tpu_torch.train.state import batch_stats

    seq = ref.pipeline.sequential
    opt, _ = _optimizers(ref)
    with torch.no_grad():
        for n, p in seq.named_parameters():
            p.copy_(start[n])
            keys = {name.split(":", 1)[1] for name in start if name.startswith(n + ":")}
            live = opt.state.get(p) or {}
            if not keys:
                opt.state.pop(p, None)
            elif set(live) != keys:
                opt.state[p] = {k: start[f"{n}:{k}"].clone() for k in keys}
            else:
                for k in keys:
                    live[k].copy_(start[f"{n}:{k}"])
        for n, b in batch_stats(seq).items():
            b.copy_(start[f"{n} (buffer)"])
        ref.state.step.copy_(start["step"])


def parallel_dense_held_step(trainer, ref, mesh, batch, fns, path: str, dead=()):
    """One step from one state on the dense route: the single-device
    reference (rank 0) with the plain versions, the mesh trainer with the
    kernels on every rank; rank 0 holds every kept tensor of the logical
    state (the table and its optimizer state gathered from the shards, the
    replicated parameters and their state) by :func:`held_compare`, with
    Adam's sensitivity where the table's rule is torch's Adam
    (:func:`adam_sensitivity`); the table and each floating state tensor of
    it that the plain step writes must move by HELD_MOVED_ULPS ulps.  The
    parameters ``dead`` (and their state) have gradient 0 in exact
    arithmetic: each side's rounding noise, summed over other slices, which
    Adam scales to steps near lr; they are not compared.  Returns rank 0's
    record (None elsewhere)."""
    import torch

    keep = ref is not None
    start = mesh_kept(trainer, mesh, keep)
    if keep:
        sync_logical(ref, start)
        with abs_sums() as sums, plain_versions(fns):
            loss_p = ref.train_steps([batch])[0].item()
        plain = dense_state(ref)
        sens = adam_sensitivity(ref, start, sums)
        del sums
    loss_k = trainer.train_steps([batch])[0].item()
    after = mesh_kept(trainer, mesh, keep)
    if not keep:
        return None
    tables = tuple(embedding_tables(ref))
    worst, where, moved = 0.0, "all equal", {}
    for name, k in after.items():
        if name.split(":")[0] in dead:
            continue
        s = start.get(name)
        if s is None:  # torch's Adam builds its state at its first step, from 0
            s = torch.zeros_like(k)
        ratio, at, ulps, _ = held_compare(s, plain[name], k, sens.get(name))
        if name.split(":")[0] in tables and s.is_floating_point() and (
                ":" not in name or not torch.equal(s, plain[name])):
            moved[name] = ulps
        if not ratio <= worst:
            flat = (s.reshape(-1), plain[name].reshape(-1), k.reshape(-1))
            worst, where = ratio, (f"{name}[{at}]: start {flat[0][at].item():.9g}, plain "
                                   f"{flat[1][at].item():.9g}, mesh {flat[2][at].item():.9g}"
                                   if at is not None else name)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[{path}] the mesh's kernels vs the single-device plain step, one step from one "
        f"state: loss {loss_k:.8f} vs {loss_p:.8f} (rel diff {rel:.3g}, rtol "
        f"{TRAIN_LOSS_RTOL}); the logical state ({len(after)} tensors): worst |mesh - plain| / "
        f"tolerance {worst:.3g} ({where}); largest change in ulps: "
        + ", ".join(f"{n.rsplit('.', 1)[-1]} {u:.4g}" for n, u in moved.items()))
    if not np.isfinite(loss_k) or not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{path}: the mesh and the single-device losses disagree")
    if not worst <= 1.0:
        raise AssertionError(f"{path}: the mesh step and the single-device one differ beyond "
                             f"the tolerance at {where}, {worst:.3g} times it")
    still = {n: u for n, u in moved.items() if not u >= HELD_MOVED_ULPS}
    if still:
        raise AssertionError(f"{path}: the step moved {still} ulps at most, under "
                             f"{HELD_MOVED_ULPS}: the comparison cannot see the kernels")
    return {"loss_mesh": loss_k, "loss_plain": loss_p, "worst_over_tolerance": worst,
            "worst": where, "moved_ulps": moved}


def timed_mesh_steps(trainer, mesh, batches):
    """Eager steps over NCCL: examples/sec, step ms, MB a step handed to
    each kind of collective, then a traced window (:func:`collective_profile`)."""
    import torch

    mesh.sent.clear()
    trainer.train_steps(batches[:2])
    torch.cuda.synchronize()
    sent0 = dict(mesh.sent)
    t0 = time.perf_counter()
    trainer.train_steps(batches)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / len(batches)
    sent = {k: (v - sent0.get(k, 0)) / len(batches) / 1e6 for k, v in mesh.sent.items()}
    return {"step_ms": wall * 1e3, "examples_per_sec": BATCH / wall,
            "collective_mb_per_step": sent, **collective_profile(trainer, batches[:3], mesh)}


def parallel_dense_run(mesh, optimizer: str, batches, fns, reference: bool, timed: bool):
    """The bench DeepFM on the dense route under ``optimizer`` on this rank:
    PARALLEL_HELD held steps (:func:`parallel_dense_held_step`, the table
    scaled first, :func:`scale_table`), a fit of PARALLEL_DENSE_FIT, and over
    NCCL the timings.  Every rank's launches are counted exactly."""
    import torch

    from torecsys_tpu_torch import Trainer

    shape = f"{mesh.shape['data']}x{mesh.shape['table']}"
    path = f"parallel_dense_{optimizer}_{shape}"
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(dense_parallel_pipeline(optimizer), mesh=mesh, presort=False,
                      log_every=10**9)
    trainer.init_state()
    ref = None
    if reference:
        ref = Trainer(dense_parallel_pipeline(optimizer), presort=False, log_every=10**9)
        ref.init_state()
    module = parallel_table(trainer)
    opt = trainer.state.opt_state
    if trainer.sparse or module.row_layout is None or module.embedding not in opt._tables:
        raise AssertionError(f"{path}: the table is not row-sharded on the dense route with "
                             f"its optimizer reducing over the table group")
    scale_table(trainer, HELD_RMS)
    reset_counts(fns)
    held = [parallel_dense_held_step(trainer, ref, mesh, b, fns, f"{path} step {i}")
            for i, b in enumerate(batches[:PARALLEL_HELD])]
    del ref
    release()
    fit_batches = batches[PARALLEL_HELD:PARALLEL_HELD + PARALLEL_DENSE_FIT]
    metrics = trainer.fit(lambda: iter(fit_batches), max_epochs=1)
    steps = PARALLEL_HELD + len(fit_batches)
    counts = read_counts(fns)
    want = expect(**{n: steps * c for n, c in PARALLEL_DENSE_PER_STEP.items()})
    if counts != want:
        raise AssertionError(f"{path} rank {mesh.rank}: kernel launches {counts}, expected {want}")
    state = opt.state[module.embedding]
    rec = {"path": path, "optimizer": type(opt).__name__,
           "table": {"local_shape": list(module.embedding.shape),
                     "state": {k: list(v.shape) for k, v in state.items()}},
           "held": held, "fit_loss": metrics["train_loss"], "launches": counts,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if timed:
        rec.update(timed_mesh_steps(trainer, mesh, batches[:PARALLEL_TIMED]))
    if mesh.rank == 0:
        log(f"[{path}] rank 0: {type(opt).__name__} over the row-sharded table "
            f"{tuple(module.embedding.shape)} (state {rec['table']['state']}), fit loss "
            f"{metrics['train_loss']:.6f}, launches {counts}, peak {rec['peak_memory_gb']:.3f} GB"
            + (f", step {rec['step_ms']:.3f} ms, {rec['examples_per_sec']:.0f} examples/sec, "
               f"busy {rec['device_busy_share']:.3f}, collective ms/step "
               f"{rec['collective_ms_per_step']}, MB/step sent {rec['collective_mb_per_step']}"
               if timed else ""))
    del trainer, opt, module, state
    release()
    return rec


def parallel_checkpoint(optimizer: str, batches, work: str, fns):
    """Under ``optimizer`` on the dense route: one step at (2, 2), a
    checkpoint there, restored at (1, 4) and on one device (rank 0): the
    logical state (:func:`mesh_kept`) equal to the bit in both.  Returns
    the launches of the step and rank 0's record."""
    import torch
    import torch.distributed as dist

    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.parallel.mesh import make_mesh

    rank = dist.get_rank()
    path = os.path.join(work, f"ckpt_{optimizer}", "ckpt_1.pt")
    mesh = make_mesh(2, 2)
    trainer = Trainer(dense_parallel_pipeline(optimizer), mesh=mesh, presort=False,
                      log_every=10**9)
    trainer.init_state()
    reset_counts(fns)
    trainer.train_steps(batches[:1])
    counts = read_counts(fns)
    want = expect(**PARALLEL_DENSE_PER_STEP)
    if counts != want:
        raise AssertionError(f"checkpoint {optimizer} rank {rank}: launches {counts}, "
                             f"expected {want}")
    trainer.save_checkpoint(path)
    saved = mesh_kept(trainer, mesh, rank == 0)
    sharded = {k: list(v.shape) for k, v in trainer.state.opt_state.state[
        parallel_table(trainer).embedding].items()}
    del trainer
    release()
    other_mesh = make_mesh(1, 4)
    other = Trainer(dense_parallel_pipeline(optimizer), mesh=other_mesh, presort=False,
                    log_every=10**9, load_from=path)
    other.init_state()
    restored = {"(1, 4)": mesh_kept(other, other_mesh, rank == 0)}
    del other
    release()
    if rank == 0:
        single = Trainer(dense_parallel_pipeline(optimizer), presort=False, log_every=10**9,
                         load_from=path)
        single.init_state()
        restored["one device"] = dense_state(single)
        del single
        release()
    dist.barrier()
    if rank != 0:
        return counts, None
    differ = {where: sorted(n for n in saved if n not in got or not torch.equal(
        bits(saved[n]), bits(got[n]))) for where, got in restored.items()}
    log(f"[parallel-checkpoint] {optimizer}: saved at (2, 2) (table state "
        f"{sharded}), restored at (1, 4) and on one device: "
        + ", ".join(f"{w}: {'every tensor equal to the bit' if not d else d}"
                    for w, d in differ.items()))
    if any(differ.values()):
        raise AssertionError(f"checkpoint {optimizer}: restored state differs: {differ}")
    return counts, {"optimizer": optimizer, "tensors": len(saved), "table_state": sharded,
                    "differ": differ}


def parallel_ltr(mesh, seed: int, fns, reference: bool):
    """Phase 15's NCF + BPR at (2, 2): a step, then one held step against
    the single-device port (its negatives drawn over the global batch, as
    the mesh draws them), twice the launches of LTR_PER_STEP.  The held
    step follows a step so that Adam's moments are not 0: at Adam's first
    step a tower weight's update is near ``g / (|g| + eps)``, and where
    ``|g|`` is near eps the two data slices' sum of the tower's gradient
    (against the whole batch's GEMM) moves it by more than the held
    tolerance, which bounds that sensitivity for the tables only
    (:func:`adam_sensitivity`)."""
    from torecsys_tpu_torch import Trainer

    train, _ = interaction_batches(seed + 13)

    def pipeline():
        return ranking_pipeline("ltr", "NCF", {"deep_layer_sizes": NCF_LTR_TOWER},
                                "BayesianPersonalizedRankingLoss", NCF_LTR_EMBED)

    trainer = Trainer(pipeline(), mesh=mesh, log_every=10**9, seed=seed)
    trainer.init_state()
    ref = None
    if reference:
        ref = Trainer(pipeline(), log_every=10**9, seed=seed)
        ref.init_state()
    layout = table_module(trainer).row_layout
    reset_counts(fns)
    trainer.train_steps(train[:1])
    # the score shift's bias: a ranking loss reads differences of scores
    held = parallel_dense_held_step(trainer, ref, mesh, train[1], fns, "parallel_ltr_2x2",
                                    dead=("model.deep.output.bias",))
    counts = read_counts(fns)
    want = expect(**{n: 2 * c for n, c in LTR_PER_STEP.items()})
    if counts != want:
        raise AssertionError(f"parallel_ltr rank {mesh.rank}: launches {counts}, expected "
                             f"{want}")
    del trainer, ref
    release()
    return {"held": held, "launches": counts, "table_sharded": layout is not None}


def parallel_rank(job_path: str, rank: int) -> None:
    """One rank of the parallel phase (``--parallel-rank``): bring the group
    up, run each configuration, write the rank's record."""
    import torch
    import torch.distributed as dist

    from torecsys_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    with open(job_path) as f:
        job = json.load(f)
    torch.cuda.set_device(job["devices"][rank])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=job["init"], world_size=job["world"], rank=rank,
                           backend=job["backend"], timeout=PARALLEL_TIMEOUT_S)
    fns = kernels()
    n_batches = max(PARALLEL_HELD + PARALLEL_FIT, PARALLEL_TIMED)
    out = {"rank": rank, "backend": job["backend"], "runs": [], "dense_runs": []}
    batches = None
    if job["runs"] or job["graph"]:
        batches = make_batches(job["seed"], n_batches)
        for shape, strategy in job["runs"]:
            mesh = make_mesh(*shape)
            out["runs"].append(parallel_run(mesh, strategy, batches, fns, rank == 0,
                                            job["timed"]))
    if job["overflow"]:
        out["overflow"] = parallel_overflow(make_mesh(*OVERFLOW_MESH), job["seed"])
    if job["graph"]:
        out["graph"] = parallel_graph(make_mesh(*job["graph"]), batches)
    del batches
    dense = make_batches(job["seed"] + 23, n_batches, PARALLEL_DENSE_FIELDS)
    for shape, optimizer in job["dense_runs"]:
        out["dense_runs"].append(parallel_dense_run(make_mesh(*shape), optimizer, dense, fns,
                                                    rank == 0, job["timed"]))
    if job["dense_graph"]:
        shape, optimizer = job["dense_graph"]
        out["dense_graph"] = parallel_graph(make_mesh(*shape), dense,
                                            dense_parallel_pipeline(optimizer),
                                            f"dense {optimizer}")
    out["checkpoints"] = []
    for optimizer in job["checkpoints"]:
        counts, rec = parallel_checkpoint(optimizer, dense, job["out"], fns)
        out["checkpoints"].append({"launches": counts, "record": rec})
    if job["ltr"]:
        out["ltr"] = parallel_ltr(make_mesh(2, 2), job["seed"], fns, rank == 0)
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def spawn_parallel(world: int, devices, backend: str, runs, timed: bool, overflow: bool,
                   seed: int, graph=None, dense_runs=(), dense_graph=None, checkpoints=(),
                   ltr: bool = False):
    """Start ``world`` ranks of this script (``--parallel-rank``) and wait;
    every rank is ended before this returns.  Returns their records."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    job = os.path.join(work, "job.json")
    with open(job, "w") as f:
        json.dump({"world": world, "devices": devices, "backend": backend,
                   "init": f"file://{os.path.join(work, 'init')}", "runs": runs,
                   "timed": timed, "overflow": overflow, "graph": graph, "seed": seed,
                   "dense_runs": [list(r) for r in dense_runs], "dense_graph": dense_graph,
                   "checkpoints": list(checkpoints), "ltr": ltr, "out": work}, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "RANK", "WORLD_SIZE",
                        "LOCAL_WORLD_SIZE", "TORCHELASTIC_RUN_ID")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               job, str(r)], env=env) for r in range(world)]
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"the parallel ranks ran past {PARALLEL_TIMEOUT_S} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"the parallel ranks exited with {codes}")
    recs = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    shutil.rmtree(work, ignore_errors=True)
    return recs


def phase_parallel(seed: int, out_dir):
    """Phase 23: the parallel layer on the card.  Four ranks share the card
    over gloo (NCCL refuses two ranks on one device; gloo's collectives run
    on the host, each card tensor copied there and back, so every kernel
    stays on the card), each a full-width bench DeepFM (28 fields, 32.9M
    rows, E = 16, batch 4096, Adam 1e-3, on-device sparse route): at (2, 2)
    under psum, alltoall and auto (the table row-sharded) and at (1, 4)
    under psum (the table replicated, its lookups collective).  Each run
    takes held steps, each from one state against the single-device
    Trainer on rank 0 with the plain versions (:func:`parallel_held_step`),
    then a short ``fit``; every rank's ``row_gather`` and
    ``fused_rowwise_update`` must launch, as many times as its steps ask.
    Then the planted overflow (:func:`parallel_overflow`).  A second gloo
    world takes the reductions over the logical table and batch: the bench
    DeepFM on the dense route under LAMB and Adafactor at (2, 2)
    (:func:`parallel_dense_run`: held steps against the single-device
    Trainer's plain step, the logical state gathered from the shards, and
    a short fit; ``row_gather`` and ``fused_sorted_dedup_update`` counted
    exactly on every rank), a checkpoint round trip under Adafactor and SM3
    (:func:`parallel_checkpoint`) and one held ``ltr`` step of phase 15's
    NCF + BPR (:func:`parallel_ltr`).  With two cards or more, the runs
    again one rank a card over NCCL, timed, the LAMB run among them, and
    graphed fits of the sparse route and of LAMB's dense route."""
    import torch

    t0 = time.perf_counter()
    runs = [[list(shape), strategy] for shape, strategy in PARALLEL_RUNS]
    recs = spawn_parallel(PARALLEL_RANKS, [0] * PARALLEL_RANKS, "gloo", runs, False, True, seed)
    t_dense = time.perf_counter()
    dense = spawn_parallel(PARALLEL_RANKS, [0] * PARALLEL_RANKS, "gloo", [], False, False, seed,
                           dense_runs=PARALLEL_DENSE_RUNS, checkpoints=PARALLEL_CKPT_OPTIMIZERS,
                           ltr=True)
    dense_s = time.perf_counter() - t_dense
    launches = {}
    by_rank = []
    for rec, drec in zip(recs, dense):
        counts = {}
        for run in rec["runs"] + drec["dense_runs"] + drec["checkpoints"] + [drec["ltr"]]:
            add_counts(counts, run["launches"])
        by_rank.append(counts)
        add_counts(launches, counts)
        for name in ("row_gather", "fused_rowwise_update", "fused_sorted_dedup_update"):
            if not counts[name] > 0:
                raise AssertionError(f"rank {rec['rank']} launched {name} {counts[name]} times")
    peaks = [[round(r["peak_memory_gb"], 3) for r in rec["runs"] + d["dense_runs"]]
             for rec, d in zip(recs, dense)]
    log(f"[parallel] 4 ranks on one card over gloo: launches by rank {by_rank}; peak GB by "
        f"rank and run {peaks}")
    overflow = recs[0]["overflow"]
    log(f"[parallel] the planted overflow at {OVERFLOW_MESH}: loss {overflow['poisoned_loss']}, "
        f"without recovery: {overflow['error'][:90]}...; recovery {overflow['recoveries']}, "
        f"final loss {overflow['loss']:.6f}")
    log(f"[parallel] the dense-route world (LAMB and Adafactor at (2, 2), the checkpoints, the "
        f"ltr step): {dense_s:.1f} s")
    out = {"launches": launches, "launches_by_rank": by_rank, "runs": recs[0]["runs"],
           "dense_runs": dense[0]["dense_runs"],
           "checkpoints": [c["record"] for c in dense[0]["checkpoints"]],
           "ltr": dense[0]["ltr"], "overflow": overflow, "gloo_s": time.perf_counter() - t0,
           "dense_gloo_s": dense_s}
    n = torch.cuda.device_count()
    if n >= 2:
        world = 4 if n >= 4 else 2
        nccl_runs = [[[world // 2, 2], "psum"], [[world // 2, 2], "alltoall"],
                     [[1, world], "psum"], [[1, world], "alltoall"]]
        t1 = time.perf_counter()
        nccl = spawn_parallel(world, list(range(world)), "nccl", nccl_runs, True, False, seed,
                              graph=[world // 2, 2], dense_runs=[[[world // 2, 2], "lamb"]],
                              dense_graph=[[world // 2, 2], "lamb"])
        out["nccl"] = {"world": world, "runs": nccl[0]["runs"], "graph": nccl[0]["graph"],
                       "dense_runs": nccl[0]["dense_runs"],
                       "dense_graph": nccl[0]["dense_graph"],
                       "peak_gb_by_rank": [[r["peak_memory_gb"]
                                            for r in rec["runs"] + rec["dense_runs"]]
                                           for rec in nccl],
                       "s": time.perf_counter() - t1}
        for r in nccl[0]["runs"] + nccl[0]["dense_runs"]:
            log(f"[parallel-nccl] {r['path']}: {r['examples_per_sec']:.0f} examples/sec, step "
                f"{r['step_ms']:.3f} ms, busy {r['device_busy_share']:.3f}, collective ms/step "
                f"{r['collective_ms_per_step']}, MB/step {r['collective_mb_per_step']}"
                + (f" against modeled {r['modeled_comm_mb']:.3f}" if "modeled_comm_mb" in r
                   else ""))
        first = nccl[0]["runs"][0]
        out.update({k: first[k] for k in ("examples_per_sec", "step_ms", "device_busy_share")})
    out["peak_memory_gb"] = max(r["peak_memory_gb"] for rec in recs + dense
                                for r in rec["runs"] + rec["dense_runs"])
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke_parallel.json"), "w") as f:
            json.dump(out, f, indent=1)
    return out


# ---- phases 24-25: quality at convergence and the parity protocol ----------

QUALITY_ROWS = 1_048_576
QUALITY_TRAIN = 917_504
QUALITY_HALF = 65_536     # the held-out rows: one half chooses the epoch, one judges
QUALITY_EPOCHS = 5
QUALITY_PAIR_SCALE = 2.0
QUALITY_MARGIN = 0.005    # DeepFM over LR (tests/test_convergence.py's margin)
QUALITY_BF16_AUC = 0.003  # bf16 compute against float32
QUALITY_ARMS = (  # (arm, model, compute, judged)
    ("lr", "LR", None, True), ("deepfm_bf16", "DeepFM", "bfloat16", True),
    ("deepfm_f32", "DeepFM", None, True), ("bench_dense13", "DeepFM", "bfloat16", False))
QUALITY_PER_STEP = dict(row_gather=2, widen_segment_sum=1, fused_rowwise_update=1)  # a table


def quality_pipeline(arm: str, model: str, compute):
    """The quality phase's pipelines: LR over a 1-wide table of the fields
    (BCELoss on its probabilities), the bench DeepFM with that table as its
    first order beside the E = 16 table, and (``bench_dense13``) the bench
    pipeline itself, whose first order is the 13 raw dense values."""
    from torecsys_tpu_torch import Inputs, Pipeline
    from torecsys_tpu_torch.inputs import MultiIndicesEmbedding

    if arm == "bench_dense13":
        return bench_pipeline(sparse=None, compute=compute)
    cats = tuple(f"cat_{i}" for i in range(len(FIELD_SIZES)))
    schema = {"feat_inputs": MultiIndicesEmbedding(1, FIELD_SIZES, cats, device=DEVICE)}
    kwargs, criterion = {}, "BCELoss"
    if model == "DeepFM":
        schema["emb_inputs"] = MultiIndicesEmbedding(EMBED, FIELD_SIZES, cats, device=DEVICE)
        kwargs, criterion = {"deep_layer_sizes": TOWER}, "BCEWithLogitsLoss"
    return (Pipeline(device=DEVICE).set_objective("ctr").set_inputs(Inputs(schema))
            .set_model(model, **kwargs).set_criterion(criterion).set_optimizer("Adam", lr=1e-3)
            .set_sparse_embeddings(None).set_compute_dtype(compute).set_target_fields("label"))


def quality_arm(arm, model, compute, train, select, test, seed, fns, card, out_dir):
    """``QUALITY_EPOCHS`` epochs of ``fit`` at ``GRAPH_K`` steps a dispatch,
    each epoch's metrics on both held-out halves; then a traced replay for
    the launches a replay runs."""
    import torch

    from torecsys_tpu_torch import Trainer

    reset_counts(fns)
    trainer = Trainer(quality_pipeline(arm, model, compute), log_every=10**9, seed=seed,
                      steps_per_execution=GRAPH_K)
    epochs = []
    t0 = time.perf_counter()
    for epoch in range(QUALITY_EPOCHS):
        m = trainer.fit(train, val_loader=select, max_epochs=1)
        judged = trainer.evaluate(test)
        rec = {"epoch": epoch, "train_loss": m["train_loss"],
               "examples_per_sec": m["examples_per_sec"], "select_auc": m["val_auc"],
               "select_logloss": m["val_logloss"], "auc": judged["val_auc"],
               "logloss": judged["val_logloss"]}
        epochs.append(rec)
        log(f"[quality] {arm} epoch {epoch} ({card}): held-out AUC {rec['auc']:.4f} logloss "
            f"{rec['logloss']:.4f} (choosing half {rec['select_auc']:.4f}, "
            f"{rec['select_logloss']:.4f}); train_loss {rec['train_loss']:.4f}, "
            f"{rec['examples_per_sec']:.0f} examples/sec")
        for key in ("auc", "logloss", "select_logloss", "train_loss"):
            if not np.isfinite(rec[key]):
                raise AssertionError(f"quality {arm}: non-finite {key} {rec}")
    seconds = time.perf_counter() - t0
    counts = read_counts(fns)
    if not trainer.sparse or trainer._presorter is not None:
        raise AssertionError(f"quality {arm}: not the on-device sparse route")
    stats = dict(trainer.graph_stats)
    per_replay = replay_profile(trainer, train[:GRAPH_K], out_dir, f"quality_{arm}")[
        "launches_per_replay"]
    total = {n: counts[n] + (stats["replays"] - stats["captures"]) * per_replay.get(n, 0)
             for n in counts}
    steps = QUALITY_EPOCHS * len(train)
    tables = 1 if model == "LR" or arm == "bench_dense13" else 2
    want = expect(**{n: steps * c * tables for n, c in QUALITY_PER_STEP.items()})
    # evaluate and fit's validation look each table up once a batch
    want["row_gather"] += QUALITY_EPOCHS * (len(select) + len(test)) * tables
    if DEVICE == "cuda" and total != want:
        raise AssertionError(f"quality {arm}: launches {total}, expected {want}")
    best = min(epochs, key=lambda r: r["select_logloss"])
    log(f"[quality] {arm} ({model}, compute {compute or 'float32'}, table "
        f"{'the 13 dense values as first order' if arm == 'bench_dense13' else 'a 1-wide table as first order'}): "
        f"epoch {best['epoch']} chosen, held-out AUC {best['auc']:.4f} logloss "
        f"{best['logloss']:.4f}; {seconds:.1f} s; launches {total}")
    table = trainer.pipeline.inputs.schema[
        "feat_inputs" if model == "LR" else "emb_inputs"].embedding
    shape = tuple(table.shape)
    del trainer, table
    release()
    return {"model": model, "compute": compute or "float32", "epochs": epochs, "chosen": best,
            "launches": total, "launches_counted": counts, "graph_stats": stats,
            "seconds": seconds, "table": shape}


def phase_quality(seed: int, out_dir):
    """Phase 24: the bench DeepFM trained to a held-out AUC at full width
    (module docstring, phase 24)."""
    from torecsys_tpu_torch.data.sample_data import make_synthetic_ctr

    card = card_line()
    t0 = time.perf_counter()
    data = make_synthetic_ctr(num_rows=QUALITY_ROWS, field_sizes=FIELD_SIZES,
                              num_dense=NUM_DENSE, pair_scale=QUALITY_PAIR_SCALE, seed=seed)
    data_s = time.perf_counter() - t0

    def batches(lo, hi):
        return [{k: v[s:s + BATCH] for k, v in data.items()} for s in range(lo, hi, BATCH)]

    train = batches(0, QUALITY_TRAIN)
    select = batches(QUALITY_TRAIN, QUALITY_TRAIN + QUALITY_HALF)
    test = batches(QUALITY_TRAIN + QUALITY_HALF, QUALITY_ROWS)
    log(f"[quality] data: {QUALITY_ROWS} rows over {len(FIELD_SIZES)} fields "
        f"({sum(FIELD_SIZES)} ids), {NUM_DENSE} dense, label mean {data['label'].mean():.4f}; "
        f"{len(train)} batches to train on, {len(select)} + {len(test)} held out; made in "
        f"{data_s:.1f} s")
    fns = kernels()
    arms = {arm: quality_arm(arm, model, compute, train, select, test, seed, fns, card, out_dir)
            for arm, model, compute, _ in QUALITY_ARMS}
    lr = arms["lr"]["chosen"]
    for arm in ("deepfm_bf16", "deepfm_f32"):
        got = arms[arm]["chosen"]
        if not (got["auc"] >= lr["auc"] + QUALITY_MARGIN and got["logloss"] < np.log(2)):
            raise AssertionError(f"quality: {arm} AUC {got['auc']:.4f} logloss "
                                 f"{got['logloss']:.4f} against LR's AUC {lr['auc']:.4f}: "
                                 f"not {QUALITY_MARGIN} over it under ln 2")
    gap = arms["deepfm_bf16"]["chosen"]["auc"] - arms["deepfm_f32"]["chosen"]["auc"]
    if abs(gap) > QUALITY_BF16_AUC:
        raise AssertionError(f"quality: bf16 AUC {gap:+.4f} from float32's")
    launches = {}
    for arm, _, _, judged in QUALITY_ARMS:
        if judged:
            add_counts(launches, arms[arm]["launches"])
    log(f"[quality] {card}: DeepFM over LR by "
        f"{arms['deepfm_bf16']['chosen']['auc'] - lr['auc']:+.4f} AUC (bf16) and "
        f"{arms['deepfm_f32']['chosen']['auc'] - lr['auc']:+.4f} (float32); bf16 against "
        f"float32 {gap:+.4f}; the bench pipeline's dense first order: AUC "
        f"{arms['bench_dense13']['chosen']['auc']:.4f} logloss "
        f"{arms['bench_dense13']['chosen']['logloss']:.4f} (not judged)")
    out = {"card": card, "arms": arms, "launches": launches, "data_s": data_s}
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke_quality.json"), "w") as f:
            json.dump(out, f, indent=1)
    return out


PARITY_CUT_SEEDS = 1
PARITY_KERNELS = ("row_gather", "fused_sorted_dedup_update", "widen_segment_sum",
                  "fused_rowwise_update")


def parity_run(seeds: int, ncf_seeds: int, log_path: str):
    """The parity protocol on the card (``parity/run_parity_torch.py``)
    with the launch counts set to 0 before it and read after: each of
    :data:`PARITY_KERNELS` must have launched (the counts tick in eager
    steps and captures, not in replays, which ``graph_stats`` counts)."""
    from parity import run_parity_torch as runner

    fns = kernels()
    reset_counts(fns)
    t0 = time.perf_counter()
    columns = runner.run_protocol(DEVICE, seeds, ncf_seeds, log=log)
    seconds = time.perf_counter() - t0
    counts = read_counts(fns)
    missing = [n for n in PARITY_KERNELS if not counts[n] > 0]
    if missing:
        raise AssertionError(f"{log_path}: {missing} did not launch (counts {counts})")
    runs = [r for models in columns.values() for by_route in models.values()
            for cell in by_route.values() for r in cell["runs"]]
    replays = sum(r["graph_stats"]["replays"] for r in runs)
    for models in columns.values():
        for name, by_route in models.items():
            for route, cell in by_route.items():
                want = "dense" if route == "default" else "ondevice"
                if any(r["route"] != want for r in cell["runs"]):
                    raise AssertionError(f"{log_path}: {name} on {route} took "
                                         f"{[r['route'] for r in cell['runs']]}")
    log(f"[{log_path}] {len(runs)} runs in {seconds:.1f} s; launches counted (eager steps, "
        f"captures, evaluation) {counts}; graph replays {replays}")
    return runner, columns, seconds, {"launches": counts, "replays": replays}


def phase_parity_cut(seed: int, out_dir):
    """Phase 25: one seed of every parity row on both routes, judged
    against the JAX package's column by PARITY.md's rule, the port's seed
    band the card's from the whole protocol (PARITY_TORCH.json) where one
    seed has none (module docstring, phase 25)."""
    runner, columns, seconds, launches = parity_run(PARITY_CUT_SEEDS, PARITY_CUT_SEEDS,
                                                    "parity_cut")
    with open(runner.OUT_JSON) as f:
        full = json.load(f)["configs"]
    banded = copy.deepcopy(columns)
    for config, models in banded.items():
        for name, by_route in models.items():
            for route, cell in by_route.items():
                if "auc_band" in cell:
                    cell["auc_band"] = full[config][name]["port"]["cuda"][route]["auc_band"]
    verdicts = runner.judged(banded)
    missed = []
    for config, models in verdicts.items():
        for name, by_route in models.items():
            for route, verdict in by_route.items():
                v = verdict["jax"]
                log(f"[parity_cut] {name} / {route}: {verdict}")
                if not v.get("within_band", v.get("bands_overlap")) and \
                        name not in runner.BOTH_COLUMNS:
                    missed.append((name, route))
    if missed:
        raise AssertionError(f"parity_cut: outside the JAX package's band: {missed}")
    out = {"card": card_line(), "columns": columns, "judged": verdicts, "seconds": seconds,
           **launches}
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke_parity_cut.json"), "w") as f:
            json.dump(out, f, indent=1)
    return out


def phase_parity(seed: int, out_dir):
    """``--phases parity``: the whole protocol on the card, both routes and
    every seed, written to ``out_dir``/PARITY_TORCH.json over the
    repository's copy (its CPU columns kept)."""
    from parity import run_parity_torch as runner

    runner, columns, seconds, launches = parity_run(runner.N_SEEDS, runner.NCF_SEEDS, "parity")
    card = card_line()
    if out_dir:
        path = os.path.join(out_dir, "PARITY_TORCH.json")
        doc = runner.write(columns, DEVICE, card, seconds, path)
        for config, models in columns.items():
            for name in models:
                log(f"[parity] {name}: {doc['configs'][config][name]['judged'][DEVICE]}")
    return {"card": card, "seconds": seconds, **launches}


# ---- phase 26: the dense optimizer's multi-tensor Adam ---------------------

# The benchmark's cells (h100_bench/configs): 26 Criteo fields at E = 10;
# the tables are capped (their rows go to the row optimizer, not this one).
ADAM_FIELDS = (100,) * 26
ADAM_EMBED = 10
ADAM_MODELS = {"deepfm": ("DeepFM", {"deep_layer_sizes": TOWER}), "xdeepfm": ("xDeepFM", XDEEPFM)}
ADAM_STEPS = 100
ADAM_LR = 1e-3
ADAM_ITERS = 50
# The kernel against torch's per-op capturable Adam.  The two round the same
# operations, in the same order, once each, but torch's kernels may contract
# a multiply-add where the kernel's fmaf does not, or the reverse: about 10
# roundings a step that can fall one ulp apart, each at most 2^-24 of its
# value.  The quadratic loss draws each side back to its target (its
# gradient moves the update by under lr * (1 - b1) / sqrt(v_hat), far under
# 1 a step), so over 100 steps the parameters part by a few ulps at most:
# each of p, m and v within ADAM_ULPS ulps of the element's magnitude, plus
# ADAM_FLOOR of the tensor's largest value (an element that crosses zero has
# no ulp to speak of); the loss within ADAM_LOSS_RTOL; the counts equal.
ADAM_ULPS = 64
ADAM_FLOOR = 1e-6
ADAM_LOSS_RTOL = 1e-5
ADAM_BYTES_PER_ELEMENT = 28  # p, g, m, v read; p, m, v written; float32
# The edges: sizes off the 4-element unit, tensors off the 16-byte boundary
# (a view one element into its storage: the scalar path), more tensors than
# one launch's table takes (three launches a step), and one tensor of more
# than 2^31 elements (8.6 GB; its offsets need 64 bits), its first and last
# elements held against torch's step on copies of them.
ADAM_EDGE_SIZES = (1, 3, 4, 5, 7, 8, 1023, 4099, 65537)
ADAM_EDGE_TENSORS = 130
ADAM_EDGE_STEPS = 5
ADAM_HUGE = (1 << 31) + 5
ADAM_HUGE_HELD = 4101


def adam_shapes(model: str, kwargs):
    """The shapes of ``model``'s dense optimizer's parameters, in order, as
    the Trainer hands them to it (the sparse route: tables left out)."""
    from torecsys_tpu_torch import Trainer

    trainer = Trainer(ctr_pipeline(model, kwargs, ADAM_FIELDS, sparse=True, embed=ADAM_EMBED),
                      log_every=10**9, seed=0)
    trainer.init_state()
    dense, _ = _optimizers(trainer)
    shapes = [tuple(p.shape) for group in dense.param_groups for p in group["params"]]
    del trainer
    release()
    return shapes


def adam_gap(ref, got) -> float:
    """The worst element of ``got`` against ``ref`` over its tolerance
    (ADAM_ULPS ulps of its magnitude plus ADAM_FLOOR of ``ref``'s largest)."""
    import torch

    mag = torch.maximum(ref.abs(), got.abs())
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    tol = ADAM_ULPS * ulp + ADAM_FLOOR * ref.abs().max()
    err = (got - ref).abs()
    return torch.where(err == 0, torch.zeros_like(err), err / tol).max().item()


class AdamSide:
    """One optimizer over its own copy of the parameters, stepped on the
    quadratic ``0.5 * sum(curv * (p - target)^2)``; ``missing``: the index
    of a parameter that never has a gradient (the reference, torch's Adam,
    which would skip it, takes zeros there, as the port does)."""

    def __init__(self, p0, make_opt, missing=None, zeros_for_missing=False):
        import torch

        self.params = [torch.nn.Parameter(p.clone()) for p in p0]
        for i, p in enumerate(self.params):
            p.grad = None if i == missing and not zeros_for_missing else torch.zeros_like(p)
        self.missing = missing
        self.opt = make_opt(self.params)
        self.losses = []
        self.graph = None

    def grads(self, target, curv):
        import torch

        with torch.no_grad():
            loss = torch.zeros((), dtype=torch.float64, device=self.params[0].device)
            for i, (p, t, c) in enumerate(zip(self.params, target, curv)):
                d = p - t
                loss += (0.5 * c * d * d).sum(dtype=torch.float64)
                if i != self.missing:
                    p.grad.copy_(c * d)
        self.losses.append(loss)

    def step(self):
        if self.graph is None:
            self.opt.step()
        else:
            self.graph.replay()

    def capture(self):
        import torch

        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.opt.step()

    def kept(self):
        """Parameters, moments and counts in parameter order."""
        state = self.opt.state
        return {"p": list(self.params), "m": [state[p]["exp_avg"] for p in self.params],
                "v": [state[p]["exp_avg_sq"] for p in self.params],
                "step": [state[p]["step"] for p in self.params]}


def adam_launches_a_step(opt) -> list:
    """The names of the kernels one ``opt.step()`` runs on the card."""
    import torch

    with card_profile() as prof:
        opt.step()
        torch.cuda.synchronize()
    return [e.name for e in device_events(prof)]


def adam_run(label: str, shapes, name: str, seed: int, missing=None):
    """100 quadratic steps of torch's capturable Adam (or AdamW), the port's
    eager and the port's in a CUDA graph (its first step eager, then one
    captured step replayed), from the same parameters; held as the
    constants above say, the port's two runs to the bit."""
    import torch

    from torecsys_tpu_torch.train.optimizers import get_optimizer

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p0 = [0.05 * torch.randn(s, generator=gen, device=dev) for s in shapes]
    target = [0.05 * torch.randn(s, generator=gen, device=dev) for s in shapes]
    curv = [torch.rand(s, generator=gen, device=dev) for s in shapes]
    wd = {"weight_decay": 1e-4} if name == "adamw" else {}
    torch_cls = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
    ref = AdamSide(p0, lambda ps: torch_cls(ps, lr=ADAM_LR, foreach=False, capturable=True,
                                            **wd), missing, zeros_for_missing=True)
    port = get_optimizer(name, lr=ADAM_LR, **wd)
    eager = AdamSide(p0, port, missing)
    graphed = AdamSide(p0, port, missing)
    sides = (ref, eager, graphed)
    for i in range(ADAM_STEPS):
        for side in sides:
            side.grads(target, curv)
            side.step()
        if i == 0:
            graphed.capture()
    torch.cuda.synchronize()
    kept = [side.kept() for side in sides]
    same = all(torch.equal(a, b) for k in kept[1] for a, b in zip(kept[1][k], kept[2][k]))
    same = same and torch.equal(torch.stack(eager.losses), torch.stack(graphed.losses))
    if not same:
        raise AssertionError(f"[adam] {label}: the replayed kernel differs from the eager one")
    gaps = {k: max(adam_gap(a, b) for a, b in zip(kept[0][k], kept[1][k])) for k in ("p", "m", "v")}
    bits = {k: sum(int(torch.equal(a, b)) for a, b in zip(kept[0][k], kept[1][k]))
            for k in ("p", "m", "v")}
    losses = torch.stack(ref.losses), torch.stack(eager.losses)
    loss_gap = ((losses[1] - losses[0]).abs() / losses[0].abs()).max().item()
    counts = {float(t) for t in kept[1]["step"]} | {float(t) for t in kept[0]["step"]}
    n = sum(p.numel() for p in p0)
    log(f"[adam] {label}: {len(shapes)} tensors, {n} elements, {ADAM_STEPS} steps; port against "
        f"torch's capturable {torch_cls.__name__}: worst p/m/v over tolerance "
        + " ".join(f"{k}={v:.3g}" for k, v in gaps.items())
        + f" (tensors bit-identical {bits} of {len(shapes)}), loss gap {loss_gap:.3g} (rtol "
        f"{ADAM_LOSS_RTOL}), counts {sorted(counts)}; eager and replayed port bit-identical")
    if max(gaps.values()) > 1 or not loss_gap <= ADAM_LOSS_RTOL or counts != {float(ADAM_STEPS)}:
        raise AssertionError(f"[adam] {label}: the port's Adam is off torch's: gaps {gaps}, "
                             f"loss {loss_gap}, counts {counts}")
    return {"tensors": len(shapes), "elements": n, "gaps": gaps, "bit_identical": bits,
            "loss_gap": loss_gap}, sides


def adam_edges(seed: int):
    """The edges above, each step against torch's capturable Adam to the bit."""
    import torch

    from torecsys_tpu_torch.ops.kernels import adam as KA
    from torecsys_tpu_torch.train.optimizers import get_optimizer

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def off(size, i):  # odd tensors start one element into their storage
        return torch.randn(size + i % 2, generator=gen, device=dev)[i % 2:]

    sizes = [ADAM_EDGE_SIZES[i % len(ADAM_EDGE_SIZES)] for i in range(ADAM_EDGE_TENSORS)]
    ours = [torch.nn.Parameter(off(n, i)) for i, n in enumerate(sizes)]
    theirs = [torch.nn.Parameter(p.detach().clone()) for p in ours]
    port = get_optimizer("adam", lr=ADAM_LR)(ours)
    ref = torch.optim.Adam(theirs, lr=ADAM_LR, foreach=False, capturable=True)
    before = KA.adam_update.launches
    for _ in range(ADAM_EDGE_STEPS):
        for i, (p, q) in enumerate(zip(ours, theirs)):
            p.grad = off(p.numel(), i)
            q.grad = p.grad.clone()
        port.step()
        ref.step()
    launches = (KA.adam_update.launches - before) / ADAM_EDGE_STEPS
    same = all(torch.equal(p, q) and torch.equal(port.state[p]["exp_avg_sq"],
                                                 ref.state[q]["exp_avg_sq"])
               for p, q in zip(ours, theirs))
    aligned = sum(p.data_ptr() % 16 == 0 for p in ours)
    del ours, theirs, port, ref
    release()
    huge = torch.nn.Parameter(torch.rand(ADAM_HUGE, generator=gen, device=dev))
    huge.grad = torch.randn(ADAM_HUGE, generator=gen, device=dev)
    held = (slice(0, ADAM_HUGE_HELD), slice(ADAM_HUGE - ADAM_HUGE_HELD, ADAM_HUGE))
    copies = [torch.nn.Parameter(huge.detach()[h].clone()) for h in held]
    for c, h in zip(copies, held):
        c.grad = huge.grad[h].clone()
    port = get_optimizer("adam", lr=ADAM_LR)([huge])
    ref = torch.optim.Adam(copies, lr=ADAM_LR, foreach=False, capturable=True)
    for _ in range(2):
        port.step()
        ref.step()
    huge_same = all(torch.equal(huge.detach()[h], c) for h, c in zip(held, copies))
    del huge, copies, port, ref
    release()
    log(f"[adam] edges: {ADAM_EDGE_TENSORS} tensors of {sorted(set(sizes))} elements, "
        f"{ADAM_EDGE_TENSORS - aligned} off the 16-byte boundary, {ADAM_EDGE_STEPS} steps, "
        f"{launches:g} launches a step: bit-identical to torch's {same}; a tensor of "
        f"{ADAM_HUGE} elements, its first and last {ADAM_HUGE_HELD} after 2 steps: "
        f"bit-identical {huge_same}")
    want = -(-ADAM_EDGE_TENSORS // KA.MAX_TENSORS)
    if not (same and huge_same and launches == want):
        raise AssertionError(f"[adam] edges: bit-identical {same}, huge {huge_same}, "
                             f"launches a step {launches} (expected {want})")
    return {"edge_launches_a_step": launches, "edge_unaligned": ADAM_EDGE_TENSORS - aligned,
            "huge_elements": ADAM_HUGE}


def adam_times(label: str, sides, n_elements: int, fused_opt):
    """The kernel warm, cold and in the graph; torch's per-op capturable Adam
    eager and in a graph; torch's fused Adam (a yardstick only); the bound."""
    import torch

    ref, eager, graphed = sides
    ref.capture()
    launches = adam_launches_a_step(eager.opt)
    if len(launches) > 2 or not all("multi_tensor_adam" in x for x in launches):
        raise AssertionError(f"[adam] {label}: one step launched {launches}")
    rec = {"launches_a_step": len(launches), "kernels": sorted(set(launches)),
           "bound_ms": ADAM_BYTES_PER_ELEMENT * n_elements / HBM_BYTES_PER_S * 1e3}
    timings = (("kernel_ms", eager.opt.step), ("graph_ms", graphed.graph.replay),
               ("plain_ms", ref.opt.step), ("plain_graph_ms", ref.graph.replay),
               ("library_ms", fused_opt.step))
    for key, fn in timings:
        rec.update(time_keys(key, time_ms(fn, ADAM_ITERS)))
    rec["cold_ms"] = cold_time_ms(eager.opt.step, ADAM_ITERS)
    log(f"[adam] {label}: launches a step {launches}; "
        + " ".join(times_text(key, (rec[key], rec[f"{key}_events"])) for key, _ in timings)
        + f" (library: torch's fused=True Adam, a yardstick); cold_ms={rec['cold_ms']:.4f}; "
        f"bound {rec['bound_ms']:.5f} ms (bytes); in the graph "
        f"{rec['graph_ms'] / rec['bound_ms']:.2f}x the bound")
    return rec


def phase_adam(seed: int, out_dir):
    """Phase 26: the multi-tensor Adam on the benchmark's parameter lists,
    then its counter through a DeepFM fit (module docstring)."""
    import torch

    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.ops.kernels import adam as KA

    record = {}
    for label, (model, kwargs) in ADAM_MODELS.items():
        shapes = adam_shapes(model, kwargs)
        run, sides = adam_run(label, shapes, "adam", seed + 26)
        fused_params = [torch.nn.Parameter(p.detach().clone()) for p in sides[1].params]
        for p, q in zip(fused_params, sides[1].params):
            p.grad = q.grad.clone()
        fused = torch.optim.Adam(fused_params, lr=ADAM_LR, fused=True)
        run.update(adam_times(label, sides, run["elements"], fused))
        record[label] = run
        del sides, fused, fused_params
        release()
    record["edges"] = adam_edges(seed + 28)
    shapes = adam_shapes(*ADAM_MODELS["deepfm"])
    record["deepfm_adamw_missing"], _ = adam_run("deepfm adamw, a parameter without a gradient",
                                                 shapes, "adamw", seed + 27, missing=1)
    release()
    k = GRAPH_K
    trainer = Trainer(ctr_pipeline("DeepFM", {"deep_layer_sizes": TOWER}, ADAM_FIELDS,
                                   sparse=True, compute="bfloat16", embed=ADAM_EMBED),
                      log_every=10**9, seed=seed, steps_per_execution=k)
    KA.adam_update.launches = 0
    trainer.fit(make_batches(seed + 26, 4 * k, ADAM_FIELDS), max_epochs=1)
    launches = KA.adam_update.launches
    log(f"[adam] DeepFM fit, {4 * k} steps at K = {k}: adam_update.launches {launches} "
        f"(the warm-up's and the capture's steps, one a step; replays are not counted)")
    if launches != 2 * k:
        raise AssertionError(f"[adam] the fit counted {launches} launches, expected {2 * k}")
    record["fit_launches"] = launches
    del trainer
    release()
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke_adam.json"), "w") as f:
            json.dump(record, f, indent=1)
    return record


# ---- phase 27: DLRM-DCNv2's multi-hot input and its four-card mesh -----------

# MLPerf Training's DLRM-DCNv2 (h100_bench/configs/dlrm_dcnv2_criteo1tb.json)
DLRM_FIELDS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000, 3067956,
               405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000, 40000000, 40000000, 590152,
               12973, 108, 36)
DLRM_HOTS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1)
DLRM_EMBED = 128
DLRM_BATCH = 16384
DLRM_WORLD = 4
DLRM_BIG_ROWS = 17_000_000      # 17M x 128 = 2.18e9 elements: offsets past 2^31
DLRM_SPILL = 1_000_000          # ids drawn this far past each end of the served rows
DLRM_ITERS = 20
DLRM_CAP = 1_000_000            # the graphed-against-eager world's fields capped here
DLRM_K = 2
DLRM_STEPS = 4
DLRM_CELL = "dlrm_dcnv2_criteo1tb.train_multihot"
DLRM_TIMEOUT_S = 900


def dlrm_ids(rng, batch: int, field_sizes, hots):
    """``(B, S)`` int64 logical ids of the fused table: each field's first
    id Zipf(1.2) clipped to the field, the rest of its bag uniform over it."""
    offsets = np.concatenate([[0], np.cumsum(field_sizes)[:-1]]).astype(np.int64)
    cols = []
    for v, h, off in zip(field_sizes, hots, offsets):
        first = np.minimum(rng.zipf(1.2, size=batch) - 1, v - 1)
        rest = rng.integers(0, v, size=(batch, h - 1))
        cols.append(np.concatenate([first[:, None], rest], axis=1).astype(np.int64) + off)
    return np.concatenate(cols, axis=1)


def dlrm_batches(seed: int, n: int, field_sizes):
    """Host batches of the multi-hot fields (``cat_{i}`` ``(B, h_i)`` int32),
    13 dense values and labels."""
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(field_sizes)[:-1]]).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum(DLRM_HOTS)])
    out = []
    for _ in range(n):
        ids = dlrm_ids(rng, DLRM_BATCH, field_sizes, DLRM_HOTS)
        b = {f"cat_{i}": (ids[:, bounds[i]:bounds[i + 1]] - offsets[i]).astype(np.int32)
             for i in range(len(field_sizes))}
        for j in range(NUM_DENSE):
            b[f"dense_{j}"] = rng.normal(size=DLRM_BATCH).astype(np.float32)
        b["label"] = (rng.uniform(size=DLRM_BATCH) < 0.5).astype(np.float32)
        out.append(b)
    return out


def dlrm_starts():
    import torch

    from torecsys_tpu_torch.ops.embedding import bag_starts

    return torch.as_tensor(bag_starts(DLRM_HOTS), device=DEVICE)


def dlrm_gather_checks(seed: int):
    """The pooled gather against its plain twin, to the bit: a shard of
    ``DLRM_BIG_ROWS`` rows of 128 (offsets past 2^31 elements) serving its
    own logical range, ids spilling past both ends; int64 and int32 ids; a
    width of 10 (4-byte vectors) and a table off the 16-byte boundary.
    Then two planted faults (the served range off by one row, a bag's last
    slot dropped) that the same comparison must refuse."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    rng = np.random.default_rng(seed + 27)
    starts = dlrm_starts()
    base = 90_000_000
    lo, hi = base, base + DLRM_BIG_ROWS
    table = torch.empty((DLRM_BIG_ROWS, DLRM_EMBED), device=DEVICE).normal_()
    ids = rng.integers(lo - DLRM_SPILL, hi + DLRM_SPILL, size=(DLRM_BATCH, sum(DLRM_HOTS)))
    ids[:, 0] = hi - 1 - rng.integers(0, 1000, size=DLRM_BATCH)  # rows past element 2^31
    ids[:64, 1], ids[64:128, 1], ids[128:192, 1] = lo, lo - 1, hi  # each edge of the range
    ids_t = torch.as_tensor(ids, device=DEVICE)
    cases = {}
    for label, t, idx in (("int64", table, ids_t), ("int32", table, ids_t.to(torch.int32))):
        got = KE.pooled_row_gather(t, idx, starts, lo, hi, base)
        want = KE.pooled_row_gather_plain(t, idx, starts, lo, hi, base)
        cases[label] = bool(torch.equal(got, want))
    served = float(((ids >= lo) & (ids < hi)).mean())
    faults = {"range_off_by_one": not torch.equal(
        KE.pooled_row_gather(table, ids_t, starts, lo + 1, hi, base),
        KE.pooled_row_gather_plain(table, ids_t, starts, lo, hi, base))}
    dropped = starts.clone()
    dropped[21:] -= 1  # bag 20 (100 slots) loses its last; the bags after shift by one
    dropped[-1] = starts[-1]
    faults["slot_dropped"] = not torch.equal(
        KE.pooled_row_gather(table, ids_t, dropped, lo, hi, base),
        KE.pooled_row_gather_plain(table, ids_t, starts, lo, hi, base))
    del table
    release()
    small = torch.empty(1_000_000 * 10 + 1, device=DEVICE).normal_()
    for label, t in (("width10", small[:-1].view(-1, 10)),
                     ("offset_pointer", small[1:].view(-1, 10))):
        idx = torch.as_tensor(rng.integers(-5, t.shape[0] + 5, size=(4096, sum(DLRM_HOTS))),
                              device=DEVICE)
        cases[label] = bool(torch.equal(KE.pooled_row_gather(t, idx, starts),
                                        KE.pooled_row_gather_plain(t, idx, starts, 0,
                                                                   t.shape[0], 0)))
    del small
    release()
    log(f"[dlrm-gather] kernel against its twin, to the bit: {cases}; served share "
        f"{served:.3f}; planted faults refused: {faults}")
    if not all(cases.values()):
        raise AssertionError(f"[dlrm-gather] the pooled gather differs from its twin: {cases}")
    if not all(faults.values()):
        raise AssertionError(f"[dlrm-gather] a planted fault passed the comparison: {faults}")
    return {"bit_equal": cases, "faults_refused": faults, "served_share": served}


def dlrm_gather_times(seed: int):
    """The pooled gather at rank 0's shape of the bench cell (a quarter of
    the table, the batch's ids over the whole): warm, cold, in a CUDA graph
    and its bound; its twin; ``F.embedding_bag`` (sum, the unserved slots
    weighted 0), a yardstick the port never calls."""
    import torch
    import torch.nn.functional as F

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    rows = sum(DLRM_FIELDS) // DLRM_WORLD
    rng = np.random.default_rng(seed + 28)
    ids = torch.as_tensor(dlrm_ids(rng, DLRM_BATCH, DLRM_FIELDS, DLRM_HOTS), device=DEVICE)
    starts = dlrm_starts()
    table = torch.empty((rows, DLRM_EMBED), device=DEVICE).normal_()
    call = lambda: KE.pooled_row_gather(table, ids, starts, 0, rows, 0)  # noqa: E731
    rec = time_keys("kernel_ms", time_ms(call, DLRM_ITERS))
    rec["cold_ms"] = cold_time_ms(call, DLRM_ITERS)
    graph = torch.cuda.CUDAGraph()
    call()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        call()
    rec.update(time_keys("graph_ms", time_ms(graph.replay, DLRM_ITERS)))
    owned = ids[ids < rows]
    n_rows = int(torch.unique(owned).numel())
    n_bytes = (ids.numel() * 8 + n_rows * DLRM_EMBED * 4
               + DLRM_BATCH * len(DLRM_FIELDS) * DLRM_EMBED * 4)
    rec["bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
    rec["served_share"] = owned.numel() / ids.numel()
    rec.update(time_keys("plain_ms", time_ms(
        lambda: KE.pooled_row_gather_plain(table, ids, starts, 0, rows, 0), 2)))
    ok = (ids < rows).reshape(-1)
    flat = torch.where(ok, ids.reshape(-1), torch.zeros_like(ok, dtype=ids.dtype))
    offsets = (torch.arange(DLRM_BATCH, device=DEVICE)[:, None] * ids.shape[1]
               + starts[:-1][None, :].long()).reshape(-1)
    weights = ok.float()
    lib = lambda: F.embedding_bag(flat, table, offsets, mode="sum",  # noqa: E731
                                  per_sample_weights=weights)
    rec.update(time_keys("library_ms", time_ms(lib, DLRM_ITERS)))
    gap = (lib().reshape(DLRM_BATCH, -1, DLRM_EMBED) - call()).abs().max().item()
    log(f"[dlrm-gather] rank 0's shape ({rows} rows, {ids.numel()} ids, served share "
        f"{rec['served_share']:.3f}, {n_rows} distinct rows): "
        + " ".join(times_text(k, (rec[k], rec[f"{k}_events"]))
                   for k in ("kernel_ms", "graph_ms", "plain_ms", "library_ms"))
        + f" cold_ms={rec['cold_ms']:.4f} bound {rec['bound_ms']:.4f} ms (bytes); the "
        f"library's sums within {gap:.2e} of the kernel's")
    del table
    release()
    return rec


def dlrm_pipeline(field_sizes, device):
    """The bench configuration's pipeline over ``field_sizes``."""
    from torecsys_tpu_torch import Inputs, Pipeline, ValueInput
    from torecsys_tpu_torch.inputs import MultiHotIndicesEmbedding

    fields = tuple(f"cat_{i}" for i in range(len(field_sizes)))
    schema = {"feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(NUM_DENSE))),
              "emb_inputs": MultiHotIndicesEmbedding(DLRM_EMBED, field_sizes, DLRM_HOTS, fields,
                                                     device=device)}
    return (Pipeline(device=device).set_objective("ctr").set_inputs(Inputs(schema))
            .set_model("DLRM_DCNv2").set_criterion("BCEWithLogitsLoss")
            .set_optimizer("Adagrad", lr=0.004, initial_accumulator_value=0.0, eps=1e-8)
            .set_sparse_embeddings(True).set_compute_dtype("bfloat16")
            .set_target_fields("label"))


def dlrm_rank(job_path: str, rank: int) -> None:
    """One rank of phase 27's graphed-against-eager world (``--dlrm-rank``):
    the bench DLRM-DCNv2 over fields capped at ``DLRM_CAP`` rows, a
    graphed fit at K = 2 and eager steps from the same seed; every tensor
    of the rank's state to the bit."""
    import torch

    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.ops.kernels import cross as KC
    from torecsys_tpu_torch.ops.kernels import embedding as KE
    from torecsys_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    with open(job_path) as f:
        job = json.load(f)
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    initialize_distributed(init_method=job["init"], world_size=job["world"], rank=rank,
                           backend="nccl", timeout=DLRM_TIMEOUT_S)
    fields = tuple(min(v, DLRM_CAP) for v in DLRM_FIELDS)
    batches = dlrm_batches(job["seed"], DLRM_STEPS, fields)
    sides = {}
    for label, k in (("graphed", DLRM_K), ("eager", 1)):
        KE.pooled_row_gather.launches = 0
        KC.low_rank_cross_forward.launches = KC.low_rank_cross_backward.launches = 0
        trainer = Trainer(dlrm_pipeline(fields, device), log_every=10**9, seed=job["seed"],
                          steps_per_execution=k, presort=False, mesh=make_mesh(1, job["world"]),
                          lookup_options={"strategy": "psum"})
        losses = [float(x) for x in trainer.train_steps(batches)]
        seq = trainer.pipeline.sequential
        opt = trainer.state.opt_state
        state = {n: p.detach().clone() for n, p in seq.named_parameters()}
        state.update({f"{n}/sum_of_squares": opt["dense"].state[p]["sum_of_squares"].clone()
                      for n, p in seq.named_parameters() if p in opt["dense"].state})
        state.update({f"{n}/v": s["v"].clone() for n, s in opt["sparse"].items()})
        sides[label] = {"losses": losses, "state": state, "graphs": dict(trainer.graph_stats),
                        "launches": KE.pooled_row_gather.launches,
                        "cross": [KC.low_rank_cross_forward.launches,
                                  KC.low_rank_cross_backward.launches],
                        "layout": str(seq.inputs.schema["emb_inputs"].row_layout)}
        del trainer, seq, opt
        release()
    a, b = sides["graphed"], sides["eager"]
    differ = sorted(n for n in a["state"] if not torch.equal(a["state"][n], b["state"][n]))
    rec = {"rank": rank, "losses": a["losses"], "eager_losses": b["losses"],
           "differ": differ, "graphs": a["graphs"], "launches": a["launches"],
           "eager_launches": b["launches"], "cross": a["cross"], "eager_cross": b["cross"],
           "layout": a["layout"],
           "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9}
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def dlrm_graph_world(seed: int):
    """Phase 27's four NCCL ranks (:func:`dlrm_rank`), one a card."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_dlrm_")
    job = os.path.join(work, "job.json")
    with open(job, "w") as f:
        json.dump({"world": DLRM_WORLD, "init": f"file://{os.path.join(work, 'init')}",
                   "seed": seed, "out": work}, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "RANK", "WORLD_SIZE",
                        "LOCAL_WORLD_SIZE", "TORCHELASTIC_RUN_ID")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dlrm-rank", job,
                               str(r)], env=env) for r in range(DLRM_WORLD)]
    deadline = time.monotonic() + DLRM_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"the DLRM ranks ran past {DLRM_TIMEOUT_S} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"the DLRM ranks exited with {codes}")
    recs = []
    for r in range(DLRM_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    shutil.rmtree(work, ignore_errors=True)
    # forward steps that launch kernels: the graphed fit's K warm-up and K
    # captured steps (its replays launch none), and every eager step; each
    # gathers the multi-hot bags once and runs the cross's CROSS_LAYERS
    # combines forward and backward
    forwards = {"graphed": 2 * DLRM_K, "eager": DLRM_STEPS}
    for rec in recs:
        log(f"[dlrm-graph] rank {rec['rank']} ({rec['layout']}): graphed losses {rec['losses']}, "
            f"eager {rec['eager_losses']}; tensors that differ {rec['differ']}; graphs "
            f"{rec['graphs']}; pooled_row_gather launches {rec['launches']} graphed (warm-up "
            f"and capture), {rec['eager_launches']} eager; low_rank_cross launches forward/"
            f"backward {rec['cross']} graphed, {rec['eager_cross']} eager; peak "
            f"{rec['peak_gb']:.2f} GB")
        got = {"graphed": (rec["launches"], rec["cross"]),
               "eager": (rec["eager_launches"], rec["eager_cross"])}
        want = {k: (n, [CROSS_LAYERS * n] * 2) for k, n in forwards.items()}
        if got != want:
            raise AssertionError(f"[dlrm-graph] rank {rec['rank']}: launches (pooled gather, "
                                 f"[cross forward, backward]) {got}, expected {want}")
        if rec["differ"] or rec["losses"] != rec["eager_losses"]:
            raise AssertionError(f"[dlrm-graph] rank {rec['rank']}: the graphed fit differs "
                                 f"from its eager steps")
        if rec["graphs"] != {"captures": 1, "replays": DLRM_STEPS // DLRM_K - 1}:
            raise AssertionError(f"[dlrm-graph] rank {rec['rank']} ran {rec['graphs']}")
    return recs


def dlrm_held(seed: int):
    """The bench cell's compared steps at published widths on four cards
    (``h100_bench``'s mesh run: the K-step graph's capture and a replay),
    held to the plain reference on the touched rows by the cell's limits."""
    import torch

    bench = os.path.join(os.path.dirname(os.path.abspath(__file__)), "h100_bench")
    sys.path[:0] = [bench, os.path.dirname(bench)]
    from harness import cell as cells, check

    cell = cells.load(DLRM_CELL)
    run = cell.model.make_run(cell, torch.device("cuda", 0), seed)
    t0 = time.perf_counter()
    run.setup(warm=False)
    setup_s = time.perf_counter() - t0
    run.free()
    reference = run.reference()
    numbers = check.compare(run.readings, reference)
    ok = check.judge(numbers, cell.limits)
    log(f"[dlrm-held] {DLRM_CELL}: set-up {setup_s:.1f} s, ranks' peak GB {run.peaks_gb}; "
        f"losses {run.readings['losses']} against {reference['losses']}; numbers {numbers} "
        f"(limits {cell.limits}); worst {check.worst_leaves(run.readings, reference)}")
    if not ok:
        raise AssertionError(f"[dlrm-held] the program is outside the cell's limits: {numbers}")
    return {"numbers": numbers, "peaks_gb": run.peaks_gb, "setup_s": setup_s,
            "losses": run.readings["losses"], "reference_losses": reference["losses"]}


def phase_dlrm(seed: int, out_dir, mesh_only: bool = False):
    """Phase 27: DLRM-DCNv2's multi-hot input (module docstring)."""
    import torch

    record = {}
    if not mesh_only:
        record = {"gather": dlrm_gather_checks(seed), "times": dlrm_gather_times(seed)}
    if torch.cuda.device_count() >= DLRM_WORLD:
        record["graph"] = dlrm_graph_world(seed)
        record["held"] = dlrm_held(seed)
    else:
        log(f"[dlrm] {torch.cuda.device_count()} card(s): the four-card checks need "
            f"{DLRM_WORLD}")
    if out_dir:
        name = "chip_smoke_dlrm_mesh.json" if mesh_only else "chip_smoke_dlrm.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(record, f, indent=1)
    return record


def phase_dlrm_mesh(seed: int, out_dir):
    """Phase 27's four-card part alone (``--phases dlrm_mesh``)."""
    return phase_dlrm(seed, out_dir, mesh_only=True)


# ---- phase 28: the low-rank cross's combine kernels --------------------------

# DLRM-DCNv2's cross at the bench cell's shape: the bottom MLP's row and 26
# bags of 128, three layers at rank 512, batch 16,384
CROSS_BATCH = DLRM_BATCH
CROSS_WIDTH = (len(DLRM_FIELDS) + 1) * DLRM_EMBED
CROSS_RANK = 512
CROSS_LAYERS = 3
# (B, D) off the cell's shape: one row; a width off the 8-column vector; a
# ragged last column block; a ragged last row block
CROSS_ODD = ((1, 24), (5, 12), (1000, 3461), (333, 3456))
CROSS_ITERS = 20
# x0's float32 gradient sums its terms in another order than autograd's:
# within this share of its largest element (tests/test_torch_cross_kernel.py's
# tolerance)
CROSS_X0_TOL = 1e-6
# The weights' and biases' gradients of the whole cross against autograd over
# the composition: the weights' should be the same bits (dy is); a bias' is
# the same bf16 values summed in another order, at most a bf16 step of the
# largest apart for columns that do not cancel
CROSS_PARAM_TOL = 1e-2
# the routes the layer takes: (x0 dtype, y dtype, bias given)
CROSS_ROUTES = (("float32", "bfloat16", True), ("float32", "float32", False),
                ("bfloat16", "bfloat16", True))
UNIT_ROUNDOFF = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8}


def cross_bytes(rows: int, cols: int, t_size: int, y_size: int, what: str, **on) -> float:
    """Bytes one combine kernel must move, each read and write once:
    ``what`` "forward" (x0, x unless it is x0, y, the bias, x' and its copy)
    or "backward" (G, its copy's gradient, x0's later gradient, x0, y, the
    bias, dx0, dx where written, dy, and the bias' float32 partials written
    and read)."""
    n = rows * cols
    if what == "forward":
        per = t_size * (2 + on["x"]) + y_size * (1 + on["copy"])
        return n * per + on["bias"] * cols * y_size
    per = t_size * (3 + on["dx"] + on["grad_x0"]) + y_size * (2 + on["grad_copy"])
    blocks = -(-rows // 64)
    return n * per + on["bias"] * (2 * cols * y_size + 2 * blocks * cols * 4)


def cross_args(rows: int, cols: int, route, gen, with_x=True, copy=True, grad_copy=True,
               grad_x0=True):
    """Inputs of one layer's combine and its backward on the card."""
    import torch

    t, yt, has_bias = (getattr(torch, n) if isinstance(n, str) else n for n in route)
    dev = torch.device(DEVICE)

    def draw(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    x0 = draw(rows, cols, dtype=t)
    return {"x0": x0, "x": draw(rows, cols, dtype=t) if with_x else None,
            "y": draw(rows, cols, dtype=yt), "bias": draw(cols, dtype=yt) if has_bias else None,
            "copy": copy and yt != t, "grad": draw(rows, cols, dtype=t),
            "grad_copy": draw(rows, cols, dtype=yt) if grad_copy and yt != t else None,
            "grad_x0": draw(rows, cols, dtype=t) if grad_x0 else None}


def cross_pair(a, kernel=True, **change):
    """The combine and its backward on ``a`` (``change``: arguments the call
    gets instead, for a planted fault): the kernels' or the plain versions'."""
    from torecsys_tpu_torch.ops.kernels import cross as KC

    a = {**a, **change}
    fwd = KC.low_rank_cross_forward if kernel else KC.low_rank_cross_forward_plain
    bwd = KC.low_rank_cross_backward if kernel else KC.low_rank_cross_backward_plain
    out = fwd(a["x0"], a["x"], a["y"], a["bias"], a["copy"])
    grads = bwd(a["grad"], a["grad_copy"], a["grad_x0"], a["x0"], a["y"], a["bias"],
                a["x"] is None)
    return out, grads


def cross_gaps(kernel_side, plain_side, y_dtype: str):
    """Whether the forward's outputs and the backward's dx0, dx and dy are
    the same bits, and the bias gradient's worst gap over its bound (the
    float32 sum of B terms reordered, B u sum|dy|, plus a rounding of the
    result): ``(bits, bias_gap)``."""
    import torch

    (out_k, grads_k), (out_p, grads_p) = kernel_side, plain_side
    bits = all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip((*out_k, *grads_k[:3]), (*out_p, *grads_p[:3])))
    if grads_p[3] is None or grads_k[3] is None:
        return bits, 0.0 if grads_p[3] is grads_k[3] else float("inf")
    dy = grads_p[2].float()
    want = grads_p[3].float()
    bound = (dy.shape[0] * 2.0 ** -24 * dy.abs().sum(0) + UNIT_ROUNDOFF[y_dtype] * want.abs()
             + 1e-30)
    return bits, ((grads_k[3].float() - want).abs() / bound).max().item()


def cross_checks(seed: int):
    """Each route's kernels against their twins at the cell's shape and the
    odd shapes, as a first, a middle and a last layer: the forward, dx0, dx
    and dy to the bit, the bias gradient within its bound; then three
    planted faults (the bias add dropped, the copy's gradient ignored, the
    later layers' gradient of x0 ignored) that the comparison must refuse."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 28)
    cases = {}
    for rows, cols in ((CROSS_BATCH, CROSS_WIDTH),) + CROSS_ODD:
        for route in CROSS_ROUTES:
            # the first layer (x is x0), a middle one, the last (no later
            # layer reads x0 or the copy)
            for where in ("first", "middle", "last"):
                a = cross_args(rows, cols, route, gen, with_x=where != "first",
                               copy=where != "last", grad_copy=where != "last",
                               grad_x0=where != "last")
                bits, gap = cross_gaps(cross_pair(a), cross_pair(a, kernel=False), route[1])
                cases[f"{rows}x{cols} {route[0]}/{route[1]}{'+b' if route[2] else ''} "
                      f"{where}"] = (bits, gap)
                del a
        release()
    a = cross_args(CROSS_BATCH, CROSS_WIDTH, CROSS_ROUTES[0], gen)
    plain = cross_pair(a, kernel=False)
    no_bias = cross_pair(a, bias=None, grad_copy=a["grad_copy"])
    no_copy_grad = cross_pair(a, grad_copy=None)
    no_x0_grad = cross_pair(a, grad_x0=None)
    faults = {"bias_dropped": not cross_gaps(no_bias, plain, "bfloat16")[0],
              "grad_copy_ignored": not cross_gaps(no_copy_grad, plain, "bfloat16")[0],
              "grad_x0_ignored": not cross_gaps(no_x0_grad, plain, "bfloat16")[0]}
    del a, plain, no_bias, no_copy_grad, no_x0_grad
    release()
    worst = max(gap for _, gap in cases.values())
    log(f"[cross] kernels against their twins: forward, dx0, dx, dy bit-identical in "
        f"{sum(b for b, _ in cases.values())} of {len(cases)} cases; bias gradient's worst "
        f"gap {worst:.3g} of its bound; planted faults refused: {faults}")
    bad = {k: v for k, v in cases.items() if not v[0] or v[1] > 1}
    if bad:
        raise AssertionError(f"[cross] the kernels differ from their twins: {bad}")
    if not all(faults.values()):
        raise AssertionError(f"[cross] a planted fault passed the comparison: {faults}")
    return {"cases": {k: {"bits": b, "bias_gap": g} for k, (b, g) in cases.items()},
            "faults_refused": faults}


def cross_layer(seed: int, compute="bfloat16"):
    """The bench cell's cross, 3 layers at rank 512, as the DLRM model builds
    it, with biases drawn away from 0; its input and the output's gradient."""
    import torch

    from torecsys_tpu_torch.layers.ctr import LowRankCrossNetworkLayer
    from torecsys_tpu_torch.layers.precision import apply_compute_dtype

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 29)
    layer = LowRankCrossNetworkLayer(CROSS_LAYERS, CROSS_WIDTH, CROSS_RANK, device=DEVICE,
                                     generator=gen)
    with torch.no_grad():
        for i in range(CROSS_LAYERS):
            getattr(layer, f"u_{i}").bias.normal_(0.0, 0.1, generator=gen)
    apply_compute_dtype(layer, compute)
    x0 = torch.randn(CROSS_BATCH, CROSS_WIDTH, generator=gen, device=DEVICE)
    upstream = torch.randn(CROSS_BATCH, CROSS_WIDTH, generator=gen, device=DEVICE)
    return layer, x0, upstream


def cross_composed(layer, x0):
    """The cross as ATen's ops composed it before the kernels: a layer's
    ``x0 * u(v(x)).to(x0.dtype) + x``, autograd's backward."""
    x = x0
    for i in range(layer.num_layers):
        x = x0 * getattr(layer, f"u_{i}")(getattr(layer, f"v_{i}")(x)).to(x0.dtype) + x
    return x


class CrossStep:
    """One forward and backward of the cross (``fn``: the layer's own, or
    :func:`cross_composed`), eager from zeroed gradients, or replayed from a
    CUDA graph whose gradients it writes; :meth:`result` is the output and
    every gradient."""

    def __init__(self, layer, x0, upstream, fn):
        self.layer, self.upstream, self.fn = layer, upstream, fn
        self.x = x0.clone().requires_grad_()
        self.graph = None
        self.out = None

    def _leaves(self):
        return (self.x, *self.layer.parameters())

    def _run(self):
        out = self.fn(self.layer, self.x)
        (out * self.upstream).sum().backward()
        self.out = out.detach()  # keeps no autograd graph alive

    def eager(self):
        for t in self._leaves():
            if t.grad is not None:
                t.grad.zero_()
        self._run()

    def capture(self):
        """Warm up on a side stream, then capture from no gradients, so the
        graph's backward makes them (torch's whole-network capture)."""
        import torch

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.eager()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        for t in self._leaves():
            t.grad = None
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._run()

    def replay(self):
        self.graph.replay()

    def result(self):
        return {"out": self.out.clone(), "x0": self.x.grad.clone(),
                **{n: p.grad.clone() for n, p in self.layer.named_parameters()}}


def cross_module_checks(seed: int):
    """The cross at the cell's shape, kernels against the composition they
    replaced: the forward to the bit, x0's gradient within CROSS_X0_TOL, the
    parameters' within CROSS_PARAM_TOL of their largest; a graph replay
    against eager steps of the kernels' cross to the bit; 3 + 3 launches."""
    import torch

    from torecsys_tpu_torch.ops.kernels import cross as KC

    layer, x0, upstream = cross_layer(seed)
    kernel = CrossStep(layer, x0, upstream, lambda m, x: m(x))
    KC.low_rank_cross_forward.launches = KC.low_rank_cross_backward.launches = 0
    kernel.eager()
    launches = (KC.low_rank_cross_forward.launches, KC.low_rank_cross_backward.launches)
    got = kernel.result()
    composed = CrossStep(layer, x0, upstream, cross_composed)
    composed.eager()
    want = composed.result()
    forward_bits = torch.equal(got["out"], want["out"])
    x0_gap = ((got["x0"] - want["x0"]).abs().max() / want["x0"].abs().max()).item()
    params = [n for n in got if n not in ("out", "x0")]
    param_gaps = {n: ((got[n] - want[n]).abs().max() / want[n].abs().max()).item()
                  for n in params}
    param_bits = [n for n in params if torch.equal(got[n], want[n])]
    kernel.capture()
    kernel.replay()
    replayed = kernel.result()
    kernel.eager()
    eager = kernel.result()
    replay_bits = all(torch.equal(replayed[k], eager[k]) for k in eager)
    replay_vs_first = all(torch.equal(replayed[k], got[k]) for k in got)
    log(f"[cross] the cell's cross ({CROSS_BATCH}x{CROSS_WIDTH}, rank {CROSS_RANK}, "
        f"{CROSS_LAYERS} layers, bf16 products) against the composition: forward bit-identical "
        f"{forward_bits}; x0's gradient gap {x0_gap:.3g} of its largest (tolerance "
        f"{CROSS_X0_TOL}); parameters' worst gap {max(param_gaps.values()):.3g} "
        f"(tolerance {CROSS_PARAM_TOL}), bit-identical {len(param_bits)} of {len(params)}; "
        f"launches forward/backward {launches}; a graph replay against eager steps "
        f"bit-identical {replay_bits} (and against the first eager step {replay_vs_first})")
    if not (forward_bits and x0_gap <= CROSS_X0_TOL
            and max(param_gaps.values()) <= CROSS_PARAM_TOL):
        raise AssertionError(f"[cross] the kernels' cross is off the composition's: forward "
                             f"{forward_bits}, x0 {x0_gap}, parameters {param_gaps}")
    if not (replay_bits and replay_vs_first) or launches != (CROSS_LAYERS, CROSS_LAYERS):
        raise AssertionError(f"[cross] replay bit-identical {replay_bits}/{replay_vs_first}, "
                             f"launches {launches}")
    rec = {"forward_bits": forward_bits, "x0_gap": x0_gap, "param_gaps": param_gaps,
           "param_bits": param_bits, "replay_bits": replay_bits, "launches": launches}
    return rec, (layer, x0, upstream, kernel, composed)


def graph_of(fn):
    """A CUDA graph of one call of ``fn`` (after an eager one)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def cross_kernel_times(seed: int):
    """The middle layer's two kernels at the cell's shape (x distinct from
    x0, the bf16 copy, its gradient and x0's from the last layer, the bias):
    warm, cold and in a CUDA graph, beside their bounds."""
    import torch

    from torecsys_tpu_torch.ops.kernels import cross as KC

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 30)
    a = cross_args(CROSS_BATCH, CROSS_WIDTH, CROSS_ROUTES[0], gen)
    calls = {
        "forward": (lambda: KC.low_rank_cross_forward(a["x0"], a["x"], a["y"], a["bias"], True),
                    cross_bytes(CROSS_BATCH, CROSS_WIDTH, 4, 2, "forward", x=True, copy=True,
                                bias=True)),
        "backward": (lambda: KC.low_rank_cross_backward(a["grad"], a["grad_copy"],
                                                        a["grad_x0"], a["x0"], a["y"],
                                                        a["bias"]),
                     cross_bytes(CROSS_BATCH, CROSS_WIDTH, 4, 2, "backward", dx=True,
                                 grad_copy=True, grad_x0=True, bias=True)),
    }
    rec = {}
    for name, (call, n_bytes) in calls.items():
        r = time_keys("kernel_ms", time_ms(call, CROSS_ITERS))
        r["cold_ms"] = cold_time_ms(call, CROSS_ITERS)
        r.update(time_keys("graph_ms", time_ms(graph_of(call).replay, CROSS_ITERS)))
        r["bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
        r["graph_over_bound"] = r["graph_ms"] / r["bound_ms"]
        log(f"[cross] {name} at {CROSS_BATCH}x{CROSS_WIDTH} (float32 x0, bf16 y and copy, "
            f"bias): " + " ".join(times_text(k, (r[k], r[f"{k}_events"]))
                                  for k in ("kernel_ms", "graph_ms"))
            + f" cold_ms={r['cold_ms']:.4f}; bound {r['bound_ms']:.4f} ms ({n_bytes / 1e9:.3f} "
            f"GB); in the graph {r['graph_over_bound']:.2f}x the bound")
        rec[name] = r
    del a, calls
    release()
    return rec


GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")


def cross_step_split(graph) -> dict:
    """Device ms of one replay of ``graph``, by kernel: the GEMMs' and the
    rest's, and the largest names."""
    import torch

    graph.replay()
    torch.cuda.synchronize()
    by_name = Counter()
    for _ in range(3):  # a window now and then comes back without its kernels
        with card_profile() as prof:
            graph.replay()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events:
            break
    for e in events:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    gemm = sum(ms for n, ms in by_name.items() if any(m in n.lower() for m in GEMM_MARKS))
    total = sum(by_name.values())
    return {"total_ms": total, "gemm_ms": gemm, "other_ms": total - gemm, "kernels": len(events),
            "top": [(n[:60], round(ms, 4)) for n, ms in by_name.most_common(8)]}


def cross_step_times(steps):
    """The cross's forward and backward at the cell's shape, each side in a
    CUDA graph: the kernels' and the composition's device ms, split into
    GEMMs and the rest."""
    _, _, _, kernel, composed = steps
    composed.capture()
    rec = {}
    for name, side in (("kernel", kernel), ("composed", composed)):
        r = time_keys("graph_ms", time_ms(side.graph.replay, CROSS_ITERS))
        r.update(cross_step_split(side.graph))
        rec[name] = r
        log(f"[cross] the cell's cross, forward and backward, {name}: "
            + times_text("graph_ms", (r["graph_ms"], r["graph_ms_events"]))
            + f"; one replay {r['total_ms']:.4f} ms on the card in {r['kernels']} kernels: GEMMs "
            f"{r['gemm_ms']:.4f}, the rest {r['other_ms']:.4f}; largest {r['top']}")
    return rec


def phase_cross(seed: int, out_dir):
    """Phase 28: the low-rank cross's combine kernels (module docstring)."""
    record = {"checks": cross_checks(seed)}
    record["module"], steps = cross_module_checks(seed)
    record["step"] = cross_step_times(steps)
    del steps
    release()
    record["kernels"] = cross_kernel_times(seed)
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke_cross.json"), "w") as f:
            json.dump(record, f, indent=1)
    return record


# ---- phase 29: the CIN's kernels ----------------------------------------------

# The benchmark cell xdeepfm_criteo.train's CIN: Criteo's 26 fields at E = 10,
# batch 4096, 200 maps a layer split in half: the first layer compresses x0
# with itself (H = 26), the other two the second half of the map before (H =
# 100, a strided view).  (B, N, E, H, O, what xk is)
CIN_FIELDS = 26
CIN_EMBED = 10
CIN_LAYER_SHAPES = ((BATCH, CIN_FIELDS, CIN_EMBED, CIN_FIELDS, 200, "x0"),
                    (BATCH, CIN_FIELDS, CIN_EMBED, 100, 200, "half"))
# E 1 and 16, B 1 and 4097, the direct variant, O and H off every tile, N
# below a stage's 16 steps
CIN_ODD = ((4097, 26, 10, 100, 200, "half"), (1, 26, 10, 100, 200, "half"),
           (64, 26, 1, 100, 200, "half"), (64, 26, 16, 100, 200, "half"),
           (50, 26, 10, 200, 200, "direct"), (37, 7, 3, 13, 11, "half"),
           (33, 5, 16, 9, 21, "direct"), (3, 2, 1, 1, 1, "direct"))
CIN_KERNEL_ITERS = 10
CIN_ROWS_CAP = 100_000  # the graphed step's fields capped: its table is not the point
CIN_DISPATCHES = 3
# Each float32 sum of K products is held to CIN_SPREAD sqrt(K) u sum|terms|
# (u = 2^-24) against the plain version's, sum|terms| computed by the plain
# version on |inputs|: rounding errors of a sum taken in two orders add up
# like a random walk, about sqrt(K) u of the terms' magnitude, where the
# worst case K u would let a wrong kernel through (at dW's K = 40,961 that
# bound is half a typical dW).  K: H N + 1 for the forward (2,601 at the
# middle layer; the outer product's rounding is the same on both sides), O +
# N + 2 for dxk and O + H + 2 for dx0 (dz's sum over O, then over N or H), B
# E + 1 for dW (40,961).  Readings it was set from (H100, seed 2147525301):
# the worst gap over this bound 0.23 (the forward at B 33, E 16, K = 46, and
# dW at B 64, E 1, K = 65), 0.05 or less at the cell's shapes; a 1% error
# reads 11.8 times the bound or more at every shape (dW at the first layer's
# shape the least), which each case checks (``power``).
CIN_UNIT = 2.0 ** -24
CIN_SPREAD = 3.0
CIN_POWER = 1e-2  # a relative error each case's bound must catch


def cin_inputs(shape, gen):
    """One call's float32 inputs on the card: x0, xk (x0 itself, the second
    half of a (B, 2H, E) map, or a whole map), the weight, the output's
    gradient."""
    import torch

    b, n, e, h, o, kind = shape
    dev = torch.device(DEVICE)
    x0 = torch.randn(b, n, e, generator=gen, device=dev)
    if kind == "x0":
        xk = x0
    elif kind == "half":
        xk = torch.randn(b, 2 * h, e, generator=gen, device=dev)[:, h:]
    else:
        xk = torch.randn(b, h, e, generator=gen, device=dev)
    w = torch.randn(o, h, n, generator=gen, device=dev) * (1.0 / (h * n)) ** 0.5
    return x0, xk, w, torch.randn(b, o, e, generator=gen, device=dev)


def cin_gaps(shape, x0, xk, w, g):
    """The kernels against the plain versions: each output's worst gap over
    its bound (``CIN_UNIT``'s comment), that gap for the plain output off by
    ``CIN_POWER`` (above 1: the bound catches such an error), and whether
    two runs of the kernels gave the same bits."""
    import torch

    from torecsys_tpu_torch.ops.kernels import cin as KN

    b, n, e, h, o, _ = shape
    got = [KN.cin_forward(x0, xk, w), *KN.cin_backward(g, x0, xk, w)]
    again = [KN.cin_forward(x0, xk, w), *KN.cin_backward(g, x0, xk, w)]
    want = [KN.cin_forward_plain(x0, xk, w), *KN.cin_backward_plain(g, x0, xk, w)]
    mags = [KN.cin_forward_plain(x0.abs(), xk.abs(), w.abs()),
            *KN.cin_backward_plain(g.abs(), x0.abs(), xk.abs(), w.abs())]
    terms = (h * n + 1, o + h + 2, o + n + 2, b * e + 1)
    gaps, power = {}, {}
    for name, a, ref, mag, k in zip(("out", "dx0", "dxk", "dw"), got, want, mags, terms):
        bound = CIN_SPREAD * k ** 0.5 * CIN_UNIT * mag + 1e-30
        gaps[name] = ((a - ref).abs() / bound).max().item()
        power[name] = (CIN_POWER * ref.abs() / bound).max().item()
    bits = all(torch.equal(a, c) for a, c in zip(got, again))
    return gaps, power, bits


def cin_checks(seed: int):
    """Each kernel against the plain versions at the cell's layer shapes and
    the odd shapes, within the reordered sums' bounds, two runs to the bit."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 31)
    cases = {}
    for shape in CIN_LAYER_SHAPES + CIN_ODD:
        x0, xk, w, g = cin_inputs(shape, gen)
        gaps, power, bits = cin_gaps(shape, x0, xk, w, g)
        cases["x".join(str(v) for v in shape[:5]) + f" {shape[5]}"] = {
            "gaps": gaps, "power": power, "bits": bits}
        del x0, xk, w, g
        release()
    outputs = ("out", "dx0", "dxk", "dw")
    worst = {k: max(c["gaps"][k] for c in cases.values()) for k in outputs}
    weakest = {k: min(c["power"][k] for c in cases.values()) for k in outputs}
    log(f"[cin] kernels against their plain versions at {len(cases)} shapes: worst gap over "
        f"the reordered sums' bound {worst}; a {CIN_POWER:g} error's least gap over it "
        f"{weakest}; two runs bit-identical in {sum(c['bits'] for c in cases.values())} of "
        f"{len(cases)}")
    bad = {k: c for k, c in cases.items() if not c["bits"] or max(c["gaps"].values()) > 1}
    if bad:
        raise AssertionError(f"[cin] the kernels differ from their plain versions: {bad}")
    blind = {k: c["power"] for k, c in cases.items() if min(c["power"].values()) <= 1}
    if blind:
        raise AssertionError(f"[cin] a bound lets a {CIN_POWER:g} error through: {blind}")
    return {"cases": cases, "worst": worst, "weakest_power": weakest}


def cin_graphed_step(seed: int):
    """A graphed xDeepFM train step (the benchmark cell's CIN and DNN, bf16
    tower, K steps a replay, fields capped at ``CIN_ROWS_CAP``): the
    wrappers' launches, 3 forward and 3 backward a step the fit ran eagerly
    or captured (its K warm-up and K captured steps; replays launch
    nothing), and one replay's kernels by name on the card, 3 of each CIN
    kernel a step; one replay against K eager steps from one state, to the
    bit."""
    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.ops.kernels import cin as KN

    k = GRAPH_K
    fields = tuple(min(v, CIN_ROWS_CAP) for v in FIELD_SIZES)
    batches = make_batches(seed + 32, CIN_DISPATCHES * k, fields)
    trainer = Trainer(ctr_pipeline("xDeepFM", XDEEPFM, fields, compute="bfloat16"),
                      log_every=10**9, seed=seed, steps_per_execution=k)
    trainer.init_state()
    KN.cin_forward.launches = KN.cin_backward.launches = 0
    trainer.train_steps(batches)
    launches = (KN.cin_forward.launches, KN.cin_backward.launches)
    graphs = dict(trainer.graph_stats)
    layers = len(XDEEPFM["cin_layer_sizes"])
    want = (layers * 2 * k, layers * 2 * k)
    profile = cin_replay_kernels(trainer, batches[:k])
    per_step = {name: n / k for name, n in profile.items()}
    start = snapshot(trainer)
    replay_vs_eager(trainer, batches[:k], start, "cin")
    restore(trainer, start)
    del start
    log(f"[cin] graphed xDeepFM fit ({CIN_DISPATCHES} dispatches of {k}): cin_forward/"
        f"cin_backward launches {launches} (expected {want}: {layers} layers x the {k} "
        f"warm-up and {k} captured steps), graphs {graphs}; one replay's kernels a step "
        f"{per_step}")
    if launches != want or graphs != {"captures": 1, "replays": CIN_DISPATCHES - 1}:
        raise AssertionError(f"[cin] launches {launches}, graphs {graphs}")
    for name in ("cin_forward_kernel", "cin_backward_input_kernel", "cin_backward_weight_kernel"):
        if per_step.get(name) != layers:
            raise AssertionError(f"[cin] a replay ran {per_step} kernels a step")
    gemms = sorted(n for n in profile if any(m in n.lower() for m in ("xmma_gemm_f32",
                                                                      "simt_sgemm")))
    if gemms:
        raise AssertionError(f"[cin] a replay still runs float32 library GEMMs: {gemms}")
    del trainer
    release()
    return {"launches": launches, "graphs": graphs, "kernels_a_step": per_step}


def cin_replay_kernels(trainer, group) -> Counter:
    """The kernels one replay of the trainer's graph over ``group`` runs on
    the card, counted by name (a CIN kernel by its short name)."""
    import torch

    trainer.train_steps(group)
    torch.cuda.synchronize()
    for _ in range(3):  # a window now and then comes back without its kernels
        with card_profile() as prof:
            trainer.train_steps(group)
            torch.cuda.synchronize()
        events = device_events(prof)
        if events:
            break
    counts = Counter()
    for e in events:
        short = next((m for m in ("cin_forward_kernel", "cin_backward_input_kernel",
                                  "cin_backward_weight_kernel", "cin_transpose_kernel",
                                  "cin_weight_grad_sum_kernel") if m in e.name), e.name[:60])
        counts[short] += 1
    return counts


def cin_split(graph) -> dict:
    """Device ms of one replay of ``graph``, by kernel (CIN kernels by their
    short names)."""
    import torch

    graph.replay()
    torch.cuda.synchronize()
    for _ in range(3):
        with card_profile() as prof:
            for _ in range(CIN_KERNEL_ITERS):
                graph.replay()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events:
            break
    by_name = Counter()
    for e in events:
        short = next((m for m in ("cin_forward_kernel", "cin_backward_input_kernel",
                                  "cin_backward_weight_kernel", "cin_transpose_kernel",
                                  "cin_weight_grad_sum_kernel") if m in e.name), e.name[:60])
        by_name[short] += (e.time_range.end - e.time_range.start) / 1e3 / CIN_KERNEL_ITERS
    return dict(by_name)


def cin_times(seed: int):
    """The middle layer's kernels (B 4096, N 26, E 10, H 100 strided, O 200):
    the forward and backward calls warm, cold and in a CUDA graph, each
    kernel's in-graph ms beside the float32 FFMA bound of its product (2 O H
    N B E operations at 67 TFLOP/s), and the composition the port ran before
    (``*_plain``: ATen's product and cuBLAS's float32 GEMMs, TF32 off; a
    yardstick the port no longer calls), in a graph too; the tilings
    ``csrc/cin.cu`` chose."""
    import ctypes

    import torch

    from torecsys_tpu_torch.ops.kernels import cin as KN

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 33)
    shape = CIN_LAYER_SHAPES[1]
    b, n, e, h, o, _ = shape
    x0, xk, w, g = cin_inputs(shape, gen)
    bound_ms = 2.0 * o * h * n * b * e / FP32_OPS_PER_S * 1e3
    text = ctypes.create_string_buffer(512)
    KN._lib().trs_cin_plans(b, n, e, h, o, text, len(text))
    plans = text.value.decode()
    calls = {"forward": (lambda: KN.cin_forward(x0, xk, w),
                         lambda: KN.cin_forward_plain(x0, xk, w)),
             "backward": (lambda: KN.cin_backward(g, x0, xk, w),
                          lambda: KN.cin_backward_plain(g, x0, xk, w))}
    rec = {"bound_ms_a_product": bound_ms, "plans": plans}
    for name, (call, plain) in calls.items():
        r = time_keys("kernel_ms", time_ms(call, CIN_KERNEL_ITERS))
        r["cold_ms"] = cold_time_ms(call, CIN_KERNEL_ITERS)
        graph = graph_of(call)
        r.update(time_keys("graph_ms", time_ms(graph.replay, CIN_KERNEL_ITERS)))
        r["in_graph"] = cin_split(graph)
        del graph
        library = graph_of(plain)
        r.update(time_keys("library_graph_ms", time_ms(library.replay, CIN_KERNEL_ITERS)))
        r["library_in_graph"] = cin_split(library)
        del library
        release()
        log(f"[cin] {name} at {shape[:5]}: " + " ".join(
            times_text(k, (r[k], r[f"{k}_events"])) for k in ("kernel_ms", "graph_ms"))
            + f" cold_ms={r['cold_ms']:.4f}; in the graph {r['in_graph']}; the composition "
            f"it replaced {times_text('library_graph_ms', (r['library_graph_ms'], r['library_graph_ms_events']))}"
            f" ({r['library_in_graph']}); each product's FFMA bound {bound_ms:.4f} ms")
        rec[name] = r
    for kernel in ("cin_forward_kernel", "cin_backward_input_kernel",
                   "cin_backward_weight_kernel"):
        side = rec["forward" if kernel == "cin_forward_kernel" else "backward"]["in_graph"]
        rec[f"{kernel}_over_bound"] = side.get(kernel, float("nan")) / bound_ms
    log(f"[cin] in-graph ms over the FFMA bound: "
        + ", ".join(f"{k} {rec[f'{k}_over_bound']:.2f}x" for k in (
            "cin_forward_kernel", "cin_backward_input_kernel", "cin_backward_weight_kernel"))
        + f"; plans {plans}")
    del x0, xk, w, g
    release()
    return rec


def phase_cin(seed: int, out_dir):
    """Phase 29: the CIN's kernels (module docstring)."""
    record = {"checks": cin_checks(seed), "graphed": cin_graphed_step(seed),
              "times": cin_times(seed)}
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke_cin.json"), "w") as f:
            json.dump(record, f, indent=1)
    return record


# the phases --phases runs alone: the graphed throughput paths, the quality
# phase and the whole parity protocol
ALONE_PHASES = {"headline": phase_headline, "mmoe": phase_mmoe, "dsin": phase_dsin,
                "image": phase_image, "optim": phase_optim_sweep, "parallel": phase_parallel,
                "quality": phase_quality, "parity": phase_parity, "adam": phase_adam,
                "dlrm": phase_dlrm, "dlrm_mesh": phase_dlrm_mesh, "cross": phase_cross,
                "cin": phase_cin}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None, help="directory for the full JSON record")
    ap.add_argument("--profile", action="store_true",
                    help="trace 3 steps of each training route with torch.profiler")
    ap.add_argument("--auto-sweep", action="store_true",
                    help="only build and measure the automatic dense/sparse choice's "
                         "crossover (dense against both sparse routes, 62.5k-16M rows)")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone after the build, of "
                         f"{sorted(ALONE_PHASES)}: a change's before-and-after timings; "
                         "prints their throughput records, not the kernels line")
    ap.add_argument("--parallel-rank", nargs=2, metavar=("JOB", "RANK"), default=None,
                    help="internal: run one rank of phase 23 (the parallel phase)")
    ap.add_argument("--dlrm-rank", nargs=2, metavar=("JOB", "RANK"), default=None,
                    help="internal: run one rank of phase 27 (DLRM-DCNv2's graphed world)")
    args = ap.parse_args(argv)

    import torch

    if args.parallel_rank:
        parallel_rank(args.parallel_rank[0], int(args.parallel_rank[1]))
        return 0
    if args.dlrm_rank:
        dlrm_rank(args.dlrm_rank[0], int(args.dlrm_rank[1]))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the card",
              file=sys.stderr)
        return 1
    import torecsys_tpu_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[setup] torch", torch.__version__, "cuda", torch.version.cuda,
        "| float32 matmul and cuDNN TF32 off (allow_tf32 = False)")
    card = card_line()
    log(f"[setup] card {card}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        log(f"[time] {name} {phase_s[name]:.1f} s")
        return out

    timed("build", phase_build)
    if args.auto_sweep:
        sweep = timed("auto_sweep", phase_auto_sweep, args.seed)
        if args.out:
            with open(os.path.join(args.out, "chip_smoke_auto_sweep.json"), "w") as f:
                json.dump({"card": card, "sweep": sweep}, f, indent=1)
        print(json.dumps({"auto_sweep": sweep}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phases:
        runs = {name: timed(name, ALONE_PHASES[name], args.seed, args.out)
                for name in args.phases.split(",")}
        summary = {name: {key: rec.get(key) for key in (
            "examples_per_sec", "step_ms", "device_busy_share", "peak_memory_gb")}
            for name, rec in runs.items()}
        log(f"[phases] {summary}")
        print(json.dumps({"phases": summary, "phase_s": phase_s}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    batch = make_batches(args.seed, 1)[0]
    records = timed("kernels", phase_kernels, batch, args.seed)
    presort = timed("presort", phase_presort, args.seed)
    adam = timed("adam", phase_adam, args.seed, args.out)
    timed("cross", phase_cross, args.seed, args.out)
    timed("cin", phase_cin, args.seed, args.out)
    trainer, train = timed("train", phase_train, args.seed, args.steps, args.out, args.profile)
    evaluation = timed("eval", phase_eval, trainer, args.seed)
    del trainer
    release()
    ondevice = timed("ondevice", phase_ondevice, args.seed, args.steps,
                     train["examples_per_sec"], args.out, args.profile)
    dense = timed("dense", phase_dense, args.seed, args.steps, train["examples_per_sec"],
                  args.out, args.profile)
    pack1 = timed("pack1", phase_pack1, args.seed, args.out, args.profile)
    graph = timed("graph", phase_graph, args.seed, args.out)
    headline = timed("headline", phase_headline, args.seed, args.out)
    xdeepfm = timed("xdeepfm", phase_xdeepfm, args.seed, args.out)
    dcn = timed("dcn", phase_dcn, args.seed, args.out)
    ffm_held = timed("ffm_held", phase_ffm_held, args.seed, args.out)
    ffm = timed("ffm", phase_ffm, args.seed, args.out)
    ncf_bpr = timed("ncf_bpr", phase_ncf_ltr, args.seed, args.out)
    fat_held = timed("fat_held", phase_fat_held, args.seed, args.out)
    fat = timed("fat_deepffm", phase_fat, args.seed, args.out)
    fibinet = timed("fibinet", phase_fibinet, args.seed, args.out)
    optim = timed("optim_sweep", phase_optim_sweep, args.seed, args.out)
    mmoe = timed("mmoe", phase_mmoe, args.seed, args.out)
    multitask = timed("multitask", phase_multitask, args.seed, args.out)
    dsin = timed("dsin", phase_dsin, args.seed, args.out)
    image = timed("image", phase_image, args.seed, args.out)
    parallel = timed("parallel", phase_parallel, args.seed, args.out)
    file_fed = timed("file", phase_file, args.seed, args.out)
    quality = timed("quality", phase_quality, args.seed, args.out)
    parity_cut = timed("parity_cut", phase_parity_cut, args.seed, args.out)
    paths = {"train": train, "eval": evaluation, **ondevice, "dense": dense, "pack1": pack1,
             **graph, "headline": headline, "xdeepfm": xdeepfm, "dcn": dcn, "ffm": ffm,
             "ncf_bpr": ncf_bpr, "fat_deepffm_adagrad": fat,
             "fat_deepffm_adagrad_fused": fat["fused"], "fibinet": fibinet,
             "fibinet_fused": fibinet["fused"], "optim_sweep": optim, "mmoe": mmoe,
             "mmoe_fused": mmoe["fused"], "dsin": dsin, "seq_deepfm": dsin["seq_deepfm"],
             "image_deepfm": image, "parallel": parallel,
             "file_fed": file_fed["fed"], "cli": file_fed["cli"], "quality": quality,
             "parity_cut": parity_cut}
    # launches_by_path: each path's own run (a fit: the wrappers' counts of
    # its warm-up and capture plus its replays x a traced replay's; the
    # _fused paths: the fused dedup's capture after it; optim_sweep: its
    # eager steps); check_launches: the held steps and replay checks of
    # phases 16-22, apart from the paths' runs (phase 20's models run no
    # other path).
    checks = {"fat_held": fat_held["launches"], "fibinet_held": fibinet["held_launches"],
              "optim_sweep_graphs": optim["graph_launches"], "mmoe_held": mmoe["held_launches"],
              "multitask_held": multitask["launches"], "dsin_held": dsin["held_launches"],
              "seq_deepfm_held": dsin["seq_deepfm"]["held_launches"],
              "image_held": image["held_launches"]}
    # Each kernel's launches are those of the path that carries it: the
    # headline configuration (phase 10: the wrappers' counts of its warm-up
    # and capture, plus its replays x the launches of a traced replay), the
    # pack == 1 route for segment_sum_wide, the fused on-device route for
    # fused_sorted_dedup_update.  unique_stored_gather is on no path of
    # either package (0 everywhere).
    home = {"widen_segment_sum": "headline", "fused_rowwise_update": "headline",
            "row_gather": "headline", "segment_sum_wide": "pack1",
            "unique_stored_gather": "headline", "fused_sorted_dedup_update": "ondevice_fused"}
    kernel_lines = []
    for name in KERNEL_NAMES:
        by_path = {p: rec["launches"][name] for p, rec in paths.items()}
        line = {**records[name], "launches": by_path[home[name]], "launches_by_path": by_path,
                "check_launches": {p: c[name] for p, c in checks.items()}}
        if name in ffm["in_graph_us"]:  # at FFM's shape: 3.2M ids a step, pack 32
            line["ffm_in_graph_us"] = ffm["in_graph_us"][name]
            line["ffm_bound_ms"], line["ffm_bound_by"] = ffm["bounds"][name]
        if name in LTR_PER_STEP:  # NCF + BPR's step: two applications, E = 64, pack 2
            line["ltr_in_graph_us"] = ncf_bpr["in_graph_us"].get(name, 0.0)
            line["ltr_bound_ms"], line["ltr_bound_by"] = ncf_bpr["bounds"][name]
        # FAT-DeepFFM under Adagrad at FFM's shape; FiBiNET at E = 10, W = 80
        # (the scalar instantiations and the 4-byte gather)
        for key, rec in (("fat_deepffm", fat), ("fibinet", fibinet), ("mmoe", mmoe),
                         ("image", image)):
            if name in rec["in_graph_us"]:
                line[f"{key}_in_graph_us"] = rec["in_graph_us"][name]
                line[f"{key}_bound_ms"], line[f"{key}_bound_by"] = rec["bounds"][name]
        # ESMM at E = 18, W = 72 (its graphed steps, the on-device route)
        esmm_us = multitask["esmm_timed"]["profile"]["kernel_us_per_step"]
        if name in esmm_us:
            line["esmm_in_graph_us"] = esmm_us[name]
            line["esmm_bound_ms"], line["esmm_bound_by"] = multitask["esmm_timed"]["bounds"][name]
        # DSIN's graphed steps: the behaviour table's lookup and gradient
        # (E = 8, 32-byte rows, pack 1) on the dense route
        if name in DENSE_PER_STEP:
            line["dsin_in_graph_us"] = dsin["in_graph_us"].get(name, 0.0)
            line["dsin_bound_ms"], line["dsin_bound_by"] = dsin["bounds"][name]
        if name in ("fused_rowwise_update", "fused_sorted_dedup_update"):
            # the row rules each path launched it under ("table_grad": the
            # dense route's table gradient, the sgd rule at lr -1)
            line["launches_by_rule"] = {"optim_sweep": optim["launches_by_rule"].get(name, {})}
            for path, rule in (("fat_deepffm_adagrad", "adagrad"),
                               ("fat_deepffm_adagrad_fused", "adagrad"), ("fibinet", "adam"),
                               ("fibinet_fused", "adam"), ("mmoe", "adam"),
                               ("mmoe_fused", "adam"), ("headline", "adam"),
                               ("seq_deepfm", "adam"), ("image_deepfm", "adam")):
                line["launches_by_rule"][path] = {rule: by_path[path]}
            if name == "fused_sorted_dedup_update":
                # the dense history tables' gradients: DSIN's, the mixed path's
                for path in ("dsin", "seq_deepfm"):
                    line["launches_by_rule"][path] = {"table_grad": by_path[path]}
        kernel_lines.append(line)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "kernels": kernel_lines, "phase_s": phase_s,
                       "presort": presort, "adam": adam, **paths, "ffm_held": ffm_held,
                       "fat_held": fat_held,
                       "multitask": multitask, "file": file_fed}, f, indent=1)
    print(json.dumps({"kernels": kernel_lines}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
