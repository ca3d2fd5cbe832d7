"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of the repository, on a machine with one CUDA device:

    python3 chip_smoke.py

It builds the eleven CUDA kernels from ``src/repro_torch/kernels/csrc``
(the ten ports of the TPU kernels and the flash-attention backward) and
drives fifteen paths, each with the kernels' launch counts zeroed just before
it and read just after it (the families and Table 2 paths once per
engine they serve, the training path once per step):

* **solve** (``PlanBuilder.build`` → ``execute_plan`` with
  ``backend="pipelined"``, ``sweep="device"``, ``solve_dtype="fp32_refine"``)
  on ``grid3d(20,20,20)`` under ``amd``, ``scotch``, ``nd`` and ``rcm`` and on
  ``grid3d(32,32,32)`` under ``nd`` (n = 32,768), each for one RHS and for
  eight: residual ≤ 1e-10 (fp64, scipy), refinement converged, and the four
  solve kernels launched; then, counted apart, Table 2's other orderings
  with the same gates, each ordering's plan time printed: ``md``,
  ``qamd`` and ``amf`` on ``grid3d(16,16,16)`` (at 20³ their host
  orderings alone take 48 s on the card's machine), ``cm`` and
  ``natural`` on ``grid3d(20,20,20)``;
* **select**: a ``SolverEngine`` trained on the tracked label set
  ``artifacts/labels_c36_s7_x0.35_r1.npz`` (``fast_grids=True``, ``cv=3``)
  selects for one served batch of 16 matrices,
  ``generate_suite(16, seed=1, size_scale=8)`` (all 12 families, n up to
  131,072, padded to E = 2^20 entries): the ``entry_stats`` and ``row_stats``
  kernels launched, device features within 1e-4 relative of the host float64
  featurizer, and names equal to the host path's (a mismatch passes only
  where a split threshold on the host route lies between the host and
  device values of a feature that differ by float32 rounding, and is
  printed);
* **engine**: ``SolverEngine.solve_batch`` over
  ``generate_suite(16, seed=1, size_scale=4)`` with seeded right-hand sides:
  every residual ≤ 1e-10 with refinement converged, the six kernels of the
  served path launched, and a second ``plan_batch`` answered from the cache;
* **serving**: the engine's selector behind ``SolverEngine.serve(rpc=True)``
  on 127.0.0.1 with a fresh two-tier plan cache in a temporary directory,
  cold, under ``SERVING``'s traffic over the engine path's 16 matrices (150
  requests, Zipf alpha 1.1, bursts of 24 with 50 ms pauses over 4 client
  threads, batch 8, 5 ms wait, queue bound 256, 2 build workers, 60 s
  deadlines): all 150 answered with no shed, rejection or error, each plan
  equal to ``engine.plan``'s and its algorithm to ``engine.select``'s
  (unless float32 rounding at a split explains it), ``entry_stats`` and
  ``row_stats`` launched; then one cold request with a 1 ms deadline shed as
  ``DeadlineExceeded``; an engine loaded from the saved bundle over the
  same disk tier serving all 16 from disk with no plan built and no
  ``entry_stats`` launch; and one ``solve(ctx=...)`` at the residual gate;
  requests/s, client and per-stage p50/p99, hit rates per tier and the
  card's name and power limit printed;
* **serving_mesh**: the selector's serving mesh. The select path's
  served batch, cut to 16, 13, 7, 3 and 1 matrices, featurized over a
  ``ServingMesh`` of every card the machine has and over one listing
  cuda:0 four times (one card split four ways: real splits, gathers and
  kernel launches): the features the bits of the one-device run, one
  ``entry_stats`` and one ``row_stats`` launch a shard, each shard's
  kernel outputs held against the plain versions on its own arguments,
  and the selected names equal to the one-device mesh's; then
  ``SolverEngine(EngineConfig(serving_devices=<every card>))`` behind
  ``serve(rpc=True)`` under ``SERVING``'s traffic over
  ``generate_suite(16, seed=1, size_scale=2)``, cold: every request
  answered with the one-device selection, requests/s, p99 and the
  per-shard counters printed;
* **lifecycle**: the solve tuner, ``tune(device=cuda)`` over the
  reference's default suite and grids (a line per candidate, the winner),
  with ``frontal_factor_batch``, ``extend_add_batch`` and
  ``tri_solve_batch`` held against their plain versions at every knob of
  the grids on grid3d(20,20,20)/nd under both pad policies (those launches
  not counted); an engine with ``autotune_solve=True`` that tunes and
  solves grid3d(20,20,20) and two matrices of the engine path at the
  residual gate with the policy in ``plan.meta``, and a second one that
  loads the record and launches nothing; a labeling campaign with
  ``backend="pipelined"`` on the card, cut at half its cells, resumed and
  assembled into a dataset that trains a candidate; then the engine's
  bundle behind ``serve()`` with a disk tier, 48 Zipf requests while the
  candidate shadows (no shadow error), a promotion gate the candidate fails
  and one it passes, the cache version moved and ``rollback()`` serving
  the incumbent's plan from disk with no plan built; the four solve
  kernels and the two ``csr_stats`` kernels launched;
* **families**: a ``SolverEngine(EngineConfig(model=name,
  fast_grids=True, cv=3))`` for each of ``logistic_regression``, ``svm``,
  ``mlp`` (trained by Adam on the card; a fit that ran elsewhere fails),
  ``knn`` and ``naive_bayes`` (host), trained on the same label set
  (seconds and held-out accuracy printed), then ``select_batch`` on the
  served selection batch: ``entry_stats`` and ``row_stats`` launched and
  names equal to the host path's (a mismatch passes only where the host
  route's top two class scores lie within ``SCORE_ROUNDING`` of each
  other; both routes' smallest margins printed), a ``save`` / ``load``
  round trip with an equal fingerprint, and for ``mlp`` the engine path's
  ``solve_batch`` with its gates;
* **table2**: a host labeling campaign over all nine registered orderings
  on ``generate_suite(12, seed=7, size_scale=0.25)`` (seconds and label
  distribution printed), a ``SolverEngine`` trained on it, the select
  path's checks on the served batch and ``solve_batch`` over
  ``generate_suite(16, seed=1, size_scale=2)`` (n 220–3,360) with the
  engine path's gates;
* **per_front**: ``execute_plan`` with ``backend="pallas"`` (one front at a
  time through ``chol_tile``, ``tri_inv_tile`` and ``matmul_nt``),
  ``sweep="device"``, ``solve_dtype="fp32_refine"`` on the 32³ ``nd`` plan
  of the solve path; then ``batched`` + ``level`` and ``numpy`` + ``device``
  on the 20³ ``nd`` plan; then ``SolverEngine(EngineConfig(
  backend="pallas")).solve_batch`` over ``generate_suite(4, seed=2,
  size_scale=4)``: every residual ≤ 1e-10 with refinement converged, and
  each tile kernel launched more than once;
* **lm_serve**: qwen3-1.7b at full width and depth (28 layers, d_model
  2,048, vocab 151,936; random bf16 weights from a seeded generator),
  served as ``repro_torch.launch.serve`` does: a prefill of 4 × 4,096
  tokens, whose attention takes the chunked branch and so the
  ``flash_attention`` kernel (exactly 28 launches), held at ‖Δ‖/‖ref‖ ≤
  2e-2 against the same prefill on the plain chunked twin, then 16 greedy
  decode steps (finite logits); then a prompt of 64, where the plain branch
  runs and the kernel launches 0 times;
* **lm_serve_mesh**: LM decode from a sequence-sharded KV cache:
  qwen3-1.7b at full width and depth (seeded bf16 weights) through an
  NCCL process group of one rank and a 1 × 1 (data, model) mesh whose
  context sets ``decode_seq_axes=("data",)``, laid out as
  ``repro_torch.launch.serve --devices`` lays it out (``cache_specs``):
  B 1, a prompt of 4,096 (28 ``flash_attention`` launches), a cache of
  32,768 positions (``decode_32k``'s length) and 16 decode steps through
  ``sharded_decode_attention``, against the unsharded ``prefill`` /
  ``decode_step`` fed the same tokens: in bf16 each step's logits within
  the larger of ``LM_MESH_BF16_TOL`` of the largest and
  ``LM_MESH_BF16_CONTROL`` times a control's distance (the unsharded
  decode with P kept in float32 against the plain one), and on a float32
  copy of the weights within ``LM_MESH_TOL`` (its two prefills launch the
  float32 ``flash_attention`` 56 times), the greedy picks equal (a
  difference passes only on a near tie, printed); then
  ``sharded_decode_attention`` alone against the plain decode attention
  at those operands, timed, and the kernel at the prefill's B 1 shape;
* **lm_serve_mixers**: the archs with Mamba, MoE and xLSTM layers at full
  width (``MIXER_RUNS``; random bf16 weights from a seeded generator):
  jamba-v0.1-52b cut to one Jamba period of 8 layers (7 Mamba, 1
  attention; 4 MoE of 16 experts top 2, 4 dense MLPs; ~26.6 GB), a
  prefill of 1 × 4,096 (the MoE capacity path, the chunked attention
  branch: ``flash_attention`` launched exactly once, held against the
  plain version on its inputs, and the logits within ``LM_PREFILL_RTOL``
  of the same prefill on the plain attention), 16 greedy decode steps
  (the dense experts path, the O(1) Mamba step; finite logits), prefill
  seconds, decode ms a step beside its bound (every weight read once a
  step), the cache's bytes and peak memory, a profiled prefill and decode,
  and the kernel at jamba's attention shape against its plain version and
  SDPA; moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b at 2 layers the same
  way with 4 decode steps (2 launches each); xlstm-125m whole at a prompt
  of 1,024 and 16 decode steps, a decode step from the prefill's state held
  against a prefill one token longer on a float32 copy of the weights;
* **lm_train**: llama3.2-1b at full width and depth (16 layers, d_model
  2,048, vocab 128,256; random bf16 weights from a seeded generator)
  trained through ``Trainer.step`` on train_4k's sequence of 4,096 at batch
  4: 6 AdamW steps, each launching ``flash_attention`` 32 times (forward
  and the per-layer checkpoint's recompute) and ``flash_attention_bwd`` 16
  times; loss and grad norm finite, the step-0 loss within
  ``TRAIN_LOSS_ATOL`` of the same model on the plain attention and within
  ``LOSS0_BAND`` of ln V + σ²/2, the last loss below the first; step wall
  ms, tokens/s and peak memory printed; the attention backward held at
  the operands step 0 gave it (B 4, the model's strided views, the
  forward's saved log-sum-exp and output remainder), one batch element at
  a time against the plain gradients; one step profiled
  (attention forward and backward, matrix products, optimizer, idle
  share); then the
  trainer's checkpoint/restart at full width and 2 layers (checkpoints
  every 2 steps, a failure before step 3, ``run_with_restart`` over 4
  steps) against an uninterrupted run, within one bf16 step;
* **lm_train_mesh**: the same model, batch, seed and learning rate trained
  through a mesh: an NCCL process group of one rank (a file store in a
  temporary directory, destroyed afterwards), a 1 × 1 (data, model)
  ``DeviceMesh`` and ``Trainer(mesh=..., plan=ExecutionPlan(
  fsdp_params=True))``, so every collective of the mesh path (the
  tensor-parallel all-reduces, the FSDP gathers and reduce-scatters, the
  ZeRO gathers, the data-axis reduction and the norm's sums) runs over
  NCCL: 3 steps, each loss within ``MESH_LOSS_RTOL`` of the single-device
  trainer's at that step, 32 / 16 attention launches a step; the two
  attention kernels held at the operands the mesh path gave them (the
  forward's output and the backward's gradients, per batch element) and
  on the column-slice views a model rank gets at model width 2 (slicing
  only); step ms of both paths, tokens/s, peak memory, the NCCL version,
  the collective counters of a step and the NCCL kernels' device seconds
  of one profiled step; then 3 steps with ``grad_compression``, finite and
  within ``MESH_COMPRESSED_RTOL`` of the uncompressed steps;
* **lm_train_mixers**: the archs with MoE, Mamba and xLSTM layers trained
  at full width through ``Trainer.step`` (``MIXER_TRAIN``; random bf16
  weights from a seeded generator, AdamW at ``MIXER_LR``): jamba-v0.1-52b
  cut to its layers 4 and 5 (attention with a dense MLP, then Mamba with
  the 16-expert MoE MLP; 3,678,941,184 parameters) at 1 × 4,096, 3 steps
  (``flash_attention`` 2 launches a step: the forward and the per-layer
  checkpoint's recompute; ``flash_attention_bwd`` 1) and one profiled
  (the Mamba scan's kernels, matrix products, attention, the optimizer),
  the attention backward held at the operands step 0 gave it (B 1, Hq 32,
  Hkv 8, D 128: a GQA group of 4 at D 128) against the plain gradients;
  moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b at 2 layers, 1 × 4,096, 2
  steps (4 / 2 launches a step); xlstm-125m whole at 1 × 1,024, 2 steps;
  every step on the model's batch 0. Gates: finite metrics, the last loss
  below the first, the loss equal to
  ce + 0.01·aux (aux > 0 exactly where there are experts), loss₀ within
  ``TRAIN_LOSS_ATOL`` of the same model on the plain attention; step ms,
  tokens/s, the aux and peak memory printed. Then moonshot through a 1 × 1
  NCCL mesh with ``fsdp_params`` under ``moe_impl`` ``tp_ragged`` and
  ``ep`` (the all-to-alls), 2 steps each, within ``MESH_LOSS_RTOL`` of its
  single-device losses; and the four archs' smoke configs in float32
  (``MIXER_AGREE``: both MoE branches, dropped slots, Mamba and mLSTM
  chunks at a sequence of 300), whose loss and every gradient leaf on the
  card lie within ``MIXER_AGREE_RTOL`` of the CPU's.

Then it holds each kernel against its plain PyTorch version (the solve
kernels at shapes from the 32³ schedule; ``extend_add_batch`` at the
populated fed bucket and the root, launched as the pipelined factor launches it
(one launch per destination bucket, its routing uploaded once per
factorization), with no difference allowed and the same bits on a second
run, then at seeded cases the path never gives (unaligned rows, 40
contributions to one slot, rows wider than the staging buffer, 40 source
groups: two launches), after the count of its launches in a 32³
factorization and a line of registers, shared memory and spills for each
of its kernels; ``frontal_factor_batch`` on the
populated and the largest bucket and on the most populated bucket of every
other pivot width, and on seeded stacks at (B, M, npiv, bs) = (2, 56, 40,
20), (3, 5, 3, 3) and (1, 64, 64, 32), each run twice with the same bits,
after a line of registers, shared memory and spills for each of its
kernels; ``tri_solve_batch`` on the same buckets, at one RHS and eight,
both sweeps, and at
two layouts the path never produces, P = 512 and P = 1,792, after a line of
registers, shared memory and spills for each of its kernels at these
shapes; ``bell_spmv`` on the permuted 32³ matrix's fp64 blocks at the block
size the solve path picks (``pick_spmv_bs``: 1), at 8 (the reference's
layout), 4, 2 and 3 (the generic kernel), and on the served ``circuit_9``
(a row of 414 entries), at one RHS and eight, each against the plain
version and the matrix's own product and timed beside ``torch.sparse.mm``,
then in float32, after a line of registers, shared memory and spills for
each of its kernels; the tile kernels on the first panel
of that schedule's peak (root) front and of a leaf front, with
``matmul_nt`` at every (rows, N, K) that the per-front path launches (the
launch plan of each and its count of launches printed), ``chol_tile`` at
bs 128, 100 and 33 and on an odd row stride (each run twice with the same
bits) and ``tri_inv_tile`` at bs 128, 100 and 33, then ``matmul_nt`` at
(200, 136, 72) and on odd row strides and ``tri_inv_tile`` on an odd row
stride, after a line of registers, shared memory and spills for each
tile-kernel instantiation; the ``csr_stats`` kernels
on the served batch, ``row_stats`` also on seeded batches (B = 1, N = 2^17
+ 3, N = 5, a matrix with no valid row) and in three profiled windows of
20 calls (one kernel a call on the card; each window opens on ~5 ms of
sleep kernels, since the profiler loses a window's start), ``flash_attention`` at qwen3-1.7b's and llama3.2-1b's
attention shapes, at ragged lengths, with Hq = Hkv, at D = 32 and in
float32; first it prints the bf16 kernel's registers, shared memory and
spills), the forward's training statistics (log-sum-exp, output
remainder) against the plain forward's at llama3.2-1b's and qwen3-1.7b's
training shapes (B 4, S 4,096) and at jamba's and phi3.5-moe's (B 1, Hq 32,
Hkv 8, D 128), ``flash_attention_bwd`` against
``torch.autograd.grad`` through
the plain attention also on seeded inputs at llama3.2-1b's,
qwen3-1.7b's and jamba's/phi3.5-moe's shapes (B 1, S 4,096), a ragged S, rep 1 (the wgmma kernels
of ``csrc/flash_attention_bwd_sm90.cu``), D 32 and 16 and
float32 (the first design; each twice for
the same bits; the kernels' registers, shared memory and spills first)
and times kernel,
plain version and, where one exists, the PyTorch library call computing
the same function; it profiles the pipelined solve (with the summed device
time of the tri-solve, the ``bell_spmv``, the extend-add and the factor
kernels, and the count and seconds of its host-to-device copies) and the
per-front
solve (with the summed device time of each tile kernel), one
selection, and one prefill and 16 decode steps of the served model. It
prints the stage times, a ``kernels`` JSON line, the card's name and power
limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a CUDA
device. Imports nothing of JAX and nothing of the JAX package ``repro``.

``python3 chip_smoke.py --attention`` runs only the lm_serve path and the
flash_attention checks (a few minutes less), ``python3 chip_smoke.py
--mixers`` only the lm_serve_mixers path, ``python3 chip_smoke.py
--train`` only the lm_train and lm_train_mesh paths and the
flash_attention_bwd checks, ``python3 chip_smoke.py --serve-mesh`` only
the serving_mesh path (after training the select path's engine) and the
lm_serve_mesh path, its kernels line listing ``entry_stats``,
``row_stats`` and ``flash_attention`` at the shapes those paths give
them, each with the same last line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM peaks (data sheet): fp32 on the CUDA cores, fp64 on the
#: CUDA cores, device-memory bandwidth
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12
#: dense bf16 tensor-core peak (data sheet)
PEAK_BF16 = 989e12

#: relative tolerances of kernel vs plain version (max abs error over the
#: largest magnitude of the plain result). f32: the two sum in different
#: orders; the factor's error grows with the front (M up to 1,280 here, and
#: each Schur entry is a sum of up to P = 256 products), hence 1e-4. fp64
#: SpMV: both sum the same products of one block-row, in other orders.
#: extend_add_batch: none (0.0), since the kernel adds in the plain
#: version's order with no float atomics.
TOL = {"frontal_factor_batch": 1e-4, "extend_add_batch": 0.0,
       "tri_solve_batch": 1e-5, "bell_spmv": 1e-12,
       # the tile Cholesky's error grows along its 128-step chain of
       # dependent updates; the inverse and the product are short sums
       "chol_tile": 1e-4, "tri_inv_tile": 1e-5, "matmul_nt": 1e-5}
#: csr_stats: the integer statistics (bandwidth, row max/min) must be exact;
#: profile and squared deviations are float32 sums in the plain version
#: (fp64 / int64 in the kernels), held per matrix at this relative tolerance
CSR_STATS_RTOL = 1e-5
#: bell_spmv in float32 against its plain version (both sum a row's
#: products in float32, in other orders), relative to the largest output
BELL_F32_RTOL = 1e-5

#: a device feature within this relative distance of the host's float64
#: value differs from it by float32 rounding only (a few ulps of 2^-24)
F32_ROUNDING = 1e-6

#: flash_attention vs its plain version on the same inputs: elementwise
#: |Δ| ≤ rtol·|plain| + atol, and ‖Δ‖/‖plain‖ ≤ rnorm. The kernel's float32
#: result lies within ~1e-5 of the plain version's (P enters the tensor
#: cores as a bf16 high part plus its remainder, 16 significant bits), so in
#: bf16 the two round to the same value or to neighbours one bf16 step apart,
#: and a step is at most 2^-7·|x|; atol covers outputs near 0. Few elements
#: straddle a rounding boundary, so the relative norm stays far below one
#: step: rnorm is 9x the largest reading at these shapes (PERF.md). f32:
#: the reference attention test's 2e-5·(1 + |plain|), sums in other orders.
ATTN_TOL = {"bfloat16": dict(rtol=2 ** -7, atol=1e-4, rnorm=2e-3),
            "float32": dict(rtol=2e-5, atol=2e-5, rnorm=2e-5)}
#: flash_attention_bwd vs the gradients of its plain version (autograd
#: through flash_attention_plain, float32 throughout, rounded to the
#: inputs' dtype at the end): max abs error over the plain gradient's
#: largest magnitude. bf16: the kernel rounds P and dS to bf16 before their
#: products, a relative error of ~2^-9 a term, and the result to bf16
#: (2^-9); f32: the same function summed in other orders
ATTN_BWD_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}
#: the forward's training statistics vs the plain forward's (float32 scores,
#: torch.logsumexp): the log-sum-exp within 1e-4 absolute (the kernel sums
#: ex2.approx terms of the same scores in another order, ~1e-6 relative to
#: a log-sum-exp near 10), and the output plus its bf16 remainder within
#: 1e-4 of the largest float32 output (16 significant bits, 2^-17, plus
#: P's split into two bf16 parts, ~1e-5)
ATTN_STATS_TOL = {"lse": 1e-4, "out": 1e-4}
#: the served model and its traffic: 4 requests of 4,096 prompt tokens (the
#: chunked attention branch starts above 2,048), then 16 decode steps; a
#: prompt of 64 takes the plain branch
LM_ARCH, LM_BATCH, LM_PROMPT, LM_STEPS, LM_SHORT = "qwen3-1.7b", 4, 4096, 16, 64
#: prefill logits on the kernel vs the same model with every layer's
#: attention on the kernel's plain version (P in float32, the function the
#: kernel computes), relative norm. bf16 roundings through 28 random layers
#: leave a floor near this limit (the kernel reads 1.77e-2, the chunked twin
#: 1.93e-2, an attention 1 % off 3.12e-2: PERF.md), so the per-layer hold
#: of ``lm_serve_phase`` is the check that sees a kernel fault; this one
#: fails if the 1 % control passes it
LM_PREFILL_RTOL = 2e-2
#: the serving mesh: the served selection batch cut to these sizes, each
#: split over a mesh of every card and over cuda:0 listed four times (one
#: card split four ways: real splits, gathers and kernels)
MESH_SIZES = (16, 13, 7, 3, 1)
MESH_REPEAT = 4
#: the mesh engine's traffic: SERVING's over generate_suite(16, seed=1,
#: size_scale=2) (n 220–3,360), whose plans build in a fraction of the
#: serving path's time
MESH_SUITE = dict(count=16, seed=1, size_scale=2)
#: LM decode from a sequence-sharded cache: qwen3-1.7b at B 1, a prompt of
#: LM_PROMPT, a cache of decode_32k's 32,768 positions, LM_STEPS steps;
#: each step's logits within this share of the largest unsharded logit on
#: a float32 copy of the weights (sums in other orders only: 1.658e-6 on a
#: 1 x 1 mesh, 1.731e-6 and 4.828e-6 over four cards as 4 x 1 and 2 x 2;
#: PERF.md)
LM_MESH_SEQ, LM_MESH_TOL = 32768, 2e-5
#: the same in bf16: within the larger of LM_MESH_BF16_TOL and
#: LM_MESH_BF16_CONTROL times the control's distance, the control being
#: the unsharded decode with P kept in float32 against the plain one. Two
#: such correct decodes lie 2.130e-2 apart on the card, and the sharded
#: one 2.281e-2 from the plain (PERF.md): 28 random layers carry any
#: change of bf16 rounding that far
LM_MESH_BF16_TOL, LM_MESH_BF16_CONTROL = 1e-2, 1.5

#: the mixers path: (arch, layers or None for the full depth, batch,
#: prompt, decode steps). Widths are the configs' own. jamba-v0.1-52b is
#: cut to one Jamba period of 8 layers (7 Mamba, 1 attention; 4 MoE and 4
#: dense MLPs; ~26.6 GB of bf16 weights: its 32 layers, ~104 GB, do not fit
#: one 80 GB card); the two MoE transformers to 2 layers; xlstm-125m runs
#: whole, at a prompt of 1,024 since its sLSTM steps through the prompt a
#: token at a time on the host. A prompt of 4,096 takes the chunked
#: attention branch and the MoE capacity path; decode the dense experts
#: and each mixer's O(1) step
MIXER_RUNS = (("jamba-v0.1-52b", 8, 1, 4096, 16),
              ("moonshot-v1-16b-a3b", 2, 1, 4096, 4),
              ("phi3.5-moe-42b-a6.6b", 2, 1, 4096, 4),
              ("xlstm-125m", None, 1, 1024, 16))
#: xlstm-125m: the logits of a decode step from the prefill's state
#: against a prefill over the prompt and that token (the chunkwise mLSTM
#: and the sequential sLSTM against their recurrent steps), relative norm,
#: on a float32 copy of the weights: the two paths sum in other orders
#: (3e-6 through the 12 layers on the CPU). In bf16 the two round at other
#: places, a floor of ~2e-2 at these widths (2.1-2.5e-2 on the CPU), which
#: is printed, not held
MIXER_CONTINUE_RTOL = 1e-4

#: the training path: llama3.2-1b at full width and depth (16 layers,
#: d_model 2,048, 32 / 8 heads of 64, vocab 128,256; the reference
#: launcher's default arch), on train_4k's sequence of 4,096 with its
#: global batch of 256 cut to 4 (16,384 tokens a step), 6 optimizer steps
#: (warmup 1 step, so step 0 moves nothing, then AdamW at TRAIN_LR); the
#: checkpoint/restart check at full width and 2 layers
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = "llama3.2-1b", 4096, 4, 6
#: the peak learning rate of the 6 steps: AdamWConfig's default 3e-4 from
#: step 1 on overshoots at this random init (its losses read 12.20, 12.09,
#: 9.48, 14.89, 12.84, 13.72 on the card), as a run without a long warmup
#: does; at 5e-5 four updates move each weight about as far as one at 3e-4
TRAIN_LR = 5e-5
TRAIN_CKPT_LAYERS = 2
#: the step-0 loss on the kernels against the same model and batch with
#: every layer's attention on the plain version (bf16 roundings of the
#: attention through 16 layers move a mean of 16,384 cross entropies far
#: less than this)
TRAIN_LOSS_ATOL = 5e-3
#: the step-0 loss against its expectation at this init, ln V + σ²/2: the
#: tied embedding N(0, 0.02²) unembeds a unit-RMS feature into logits of
#: variance σ² = 0.02² · d_model (0.8192 here), and E[logsumexp] over V
#: such logits is ln V + σ²/2; the band covers the gold logit's
#: dependence on the input (Zipf labels repeat few tokens; a 2-layer cut
#: of this model read +0.067 on the CPU)
LOSS0_BAND = 0.25

#: the mesh path: lm_train's model, batch, seed and learning rate over a 1 x
#: 1 NCCL mesh with FSDP parameters; its losses against the single-device
#: trainer's (the same float arithmetic, the collectives over one rank
#: adding nothing: the limit covers the order of a few bf16 sums), then
#: int8-compressed gradients against the uncompressed steps: three, since
#: the one warmup step makes step 0's learning rate 0, so that step 2's
#: loss is the first that a compressed update moves
MESH_STEPS, MESH_COMPRESSED_STEPS = 3, 3
MESH_LOSS_RTOL, MESH_COMPRESSED_RTOL = 2e-3, 2e-2
#: the width of the model axis whose local heads the column-slice check
#: takes (slicing only, on the one card), and the rank it takes them for
MESH_SLICE_WIDTH, MESH_SLICE_RANK = 2, 1
#: lm_train's losses and step walls, which the mesh phase compares against
TRAIN_RUN: dict = {}

#: the mixers' training path: (arch, layers or None for the full depth,
#: the block pattern of the cut or None, batch, sequence, steps). Widths
#: are the configs' own. jamba-v0.1-52b is cut to its layers 4 and 5 (an
#: attention layer with a dense MLP, then a Mamba layer with the 16-expert
#: MoE MLP; moe_period 2 places the MoE as on layer 5): 3,678,941,184
#: parameters, 58.9 GB with their AdamW state and gradient (16 bytes a
#: parameter), where one Jamba period of 8 layers would need 212.7 GB;
#: moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b at 2 layers; xlstm-125m
#: whole, at 1,024 since its sLSTM is a host loop over the tokens. Each
#: takes its steps at MIXER_LR on its SyntheticData batch 0 (so that the
#: falling-loss gate compares losses of one batch: at B 1 one update moves
#: the loss less than two batches differ), the step index one ahead so
#: that the first step already updates
#: the mixers' peak learning rate: at d_model 4,096 the first AdamW step at
#: TRAIN_LR (5e-5) overshoots from this random init (jamba's losses read
#: 11.74, 18.54, 10.99 and phi3.5-moe's 11.16, 11.38 on an H100; moonshot's,
#: at d_model 2,048, 12.63, 9.87), as llama's did at 3e-4
MIXER_LR = 1e-5
MIXER_TRAIN = (("jamba-v0.1-52b", 2, ("a", "m"), 1, 4096, 3),
               ("moonshot-v1-16b-a3b", 2, None, 1, 4096, 2),
               ("phi3.5-moe-42b-a6.6b", 2, None, 1, 4096, 2),
               ("xlstm-125m", None, None, 1, 1024, 2))
#: the MoE trained over a 1 x 1 NCCL mesh under both of the reference's
#: mesh branches (on one rank local and global capacity agree), against
#: its single-device losses within MESH_LOSS_RTOL
MIXER_MESH_ARCH, MIXER_MESH_IMPLS = "moonshot-v1-16b-a3b", ("tp_ragged", "ep")
#: the card against the CPU at the smoke configs in float32: the loss and
#: each gradient leaf within this much of the CPU's (relative, of each
#: leaf's largest magnitude); TF32 is off, so only the order of float32
#: sums differs. (arch, B, S, jamba's two-layer cut, crowded routing: the
#: embedding rows moved by +1, so that the MoE's capacity branch drops
#: slots) as ``tests/test_torch_train_mixers.py`` runs them against the
#: reference
MIXER_AGREE_RTOL = 1e-4
MIXER_AGREE = (("jamba-v0.1-52b", 2, 16, False, False),
               ("jamba-v0.1-52b", 2, 300, True, True),
               ("phi3.5-moe-42b-a6.6b", 2, 256, False, True),
               ("moonshot-v1-16b-a3b", 2, 16, False, False),
               ("xlstm-125m", 1, 300, False, False))
#: the loss against ce + MOE_AUX_COEF · aux recomputed from the float32
#: metrics (relative)
MIXER_LOSS_SUM_RTOL = 1e-6

#: a profiled window whose kernels are counted one by one opens on
#: OPEN_SLEEPS sleep kernels of SLEEP_CYCLES cycles (~5 ms on the H100) and
#: closes on CLOSE_SLEEPS: once the process has run a training step, the
#: profiler loses the first 0.2-1.5 ms of every device-only window
#: (scripts/profiler_window.py reproduces it)
OPEN_SLEEPS, CLOSE_SLEEPS, SLEEP_CYCLES = 20, 5, 500_000

LABELS = "artifacts/labels_c36_s7_x0.35_r1.npz"

#: Table 2's orderings beyond the four labels, planned and solved in the
#: solve path: the minimum-degree variants on grid3d(16,16,16), since at
#: 20³ their Python quotient-graph loops take 11–24 s a plan on the card's
#: host and the run would grow by 130 s; cm and natural on grid3d(20,20,20)
NEW_ORDERINGS = {16: ("md", "qamd", "amf"), 20: ("cm", "natural")}
#: Fig. 4's model families beyond the two trees, each trained on the card
#: (logistic regression, SVM, MLP) or the host (KNN, naive Bayes) and served
FAMILIES = ("logistic_regression", "svm", "mlp", "knn", "naive_bayes")
#: a family's device name may differ from the host path's only where the
#: host route's top two class scores lie this close, relative to the
#: row's largest score: float32 rounding of the features (a few ulps of
#: 2^-24) carried through the scaler and the model
SCORE_ROUNDING = 1e-5

REPLACES = {
    "frontal_factor_batch": "src/repro/kernels/frontal_cholesky.py:391",
    "extend_add_batch": "src/repro/kernels/frontal_cholesky.py:280",
    "tri_solve_batch": "src/repro/kernels/frontal_cholesky.py:364",
    "bell_spmv": "src/repro/kernels/spmv_bell.py:91",
    "entry_stats": "src/repro/kernels/csr_stats.py:116",
    "row_stats": "src/repro/kernels/csr_stats.py:142",
    "chol_tile": "src/repro/kernels/frontal_cholesky.py:113",
    "tri_inv_tile": "src/repro/kernels/frontal_cholesky.py:133",
    "matmul_nt": "src/repro/kernels/frontal_cholesky.py:177",
    "flash_attention": "src/repro/kernels/flash_attention.py:91",
    # no pallas_call: the reference trains through its XLA twin, and XLA
    # differentiates it
    "flash_attention_bwd": "src/repro/models/layers.py:108",
}
SOURCE = {
    "frontal_factor_batch": "src/repro_torch/kernels/csrc/frontal_factor.cu",
    "extend_add_batch": "src/repro_torch/kernels/csrc/extend_add.cu",
    "tri_solve_batch": "src/repro_torch/kernels/csrc/tri_solve.cu",
    "bell_spmv": "src/repro_torch/kernels/csrc/spmv_bell.cu",
    "entry_stats": "src/repro_torch/kernels/csrc/csr_stats.cu",
    "row_stats": "src/repro_torch/kernels/csrc/csr_stats.cu",
    "chol_tile": "src/repro_torch/kernels/csrc/tile_kernels.cu",
    "tri_inv_tile": "src/repro_torch/kernels/csrc/tile_kernels.cu",
    "matmul_nt": "src/repro_torch/kernels/csrc/tile_kernels.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
    # bf16 at D 64 / 128, the training path; float32 and D 16 / 32 run the
    # first design, csrc/flash_attention_bwd.cu
    "flash_attention_bwd":
        "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
}
#: the kernels each path must launch
SOLVE_KERNELS = ("frontal_factor_batch", "extend_add_batch",
                 "tri_solve_batch", "bell_spmv")
SERVED_KERNELS = SOLVE_KERNELS + ("entry_stats", "row_stats")
TILE_KERNELS = ("chol_tile", "tri_inv_tile", "matmul_nt")
#: the tile kernels' names as the profiler reports them
TILE_STEMS = ("chol_tile", "tri_inv", "matmul_nt")
#: frontal_factor_batch's kernels as the profiler reports them: the
#: whole-front kernel of M <= 32 and the diagonal, panel and Schur steps
#: (the first design had a panel and a Schur kernel of the same names)
FACTOR_STEMS = ("small_kernel", "diag_kernel", "panel_kernel",
                "schur_kernel")

#: the serving path's traffic: the JAX-era BENCH_traffic.json config (150
#: requests, Zipf alpha 1.1 over 16 structures, bursts of 24 with 50 ms
#: pauses fanned over 4 RPC clients, batch 8, 5 ms wait, queue bound 256, 2
#: build workers, seed 7) with a 60 s deadline in place of 30 s, since host
#: clocks on the card's machine move up to 2.3x between runs
SERVING = dict(requests=150, zipf_alpha=1.1, burst=24, pause_ms=50.0,
               clients=4, batch=8, max_wait_ms=5.0, max_queue=256,
               build_workers=2, deadline_ms=60_000.0, seed=7)
#: wall seconds of the phases the ``total`` line breaks out
PHASE_S: dict = {}


def log(*args) -> None:
    print(*args, flush=True)


def rel_residual(a, x: np.ndarray, b: np.ndarray) -> float:
    import scipy.sparse as sp

    A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


# -- timing --------------------------------------------------------------------

def device_ms(fn, setup=None, reps: int = 10) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around each call, with
    a sleep kernel queued first so that the card is still busy while the
    host enqueues the call (the events then bracket device work only).
    ``setup`` (restoring an in-place input) runs before the sleep."""
    import torch

    for _ in range(2):
        if setup:
            setup()
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        if setup:
            setup()
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def stream_ms(fn, setup=None, reps: int = 3) -> float:
    """Mean time of ``fn`` on the stream in ms, launch gaps included (the
    plain versions are chains of many small PyTorch ops)."""
    import torch

    if setup:
        setup()
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        if setup:
            setup()
        torch.cuda.synchronize()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(name: str, got, want) -> float:
    """Max abs error of ``got`` against ``want``; raises beyond TOL. Syncs
    first, so a fault in the kernel surfaces here."""
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    if not (np.isfinite(err) and err <= TOL[name] * max(scale, 1e-30)):
        raise AssertionError(f"{name}: max abs err {err:.3e} vs scale "
                             f"{scale:.3e} exceeds rel tol {TOL[name]}")
    return err


# -- phases --------------------------------------------------------------------

def main_path(cases, dev) -> list:
    """PlanBuilder.build → execute_plan for every (matrix, ordering, k)."""
    from repro_torch.core.plan import PlanBuilder, execute_plan
    from repro_torch.kernels import launch_counts

    builder = PlanBuilder()
    rng = np.random.default_rng(0)
    plans = []
    for a, algorithms in cases:
        for alg in algorithms:
            plan = builder.build(a, alg)
            log(f"plan {a.name} n={a.n} nnz={a.nnz} {alg}: "
                f"{plan.meta['t_build']:.3f} s (reorder "
                f"{plan.meta['t_reorder']:.3f} s, symbolic "
                f"{plan.meta['t_symbolic']:.3f} s), nnz_L={plan.nnz_L}, "
                f"flops={plan.predicted_flops:.4g}")
            for k in (1, 8):
                b = rng.standard_normal(a.n if k == 1 else (a.n, k))
                before = launch_counts()
                r = execute_plan(a, plan, b, backend="pipelined",
                                 sweep="device", solve_dtype="fp32_refine",
                                 device=dev)
                res = rel_residual(a, r["x"], b)
                sp = r["spans"]
                log(f"solve {a.name} {alg} k={k}: residual {res:.3e}, "
                    f"refine iterations {r['refine_iterations']}, converged "
                    f"{r['refine_converged']}; s: permute "
                    f"{sp['permute']:.4f}, factor {r['t_factor']:.4f} "
                    f"(factor.schedule {sp['factor.schedule']:.4f}, "
                    f"factor.assemble {sp['factor.assemble']:.4f}, "
                    f"factor.device {sp['factor.device']:.4f}), solve "
                    f"{r['t_solve']:.4f} (solve.setup {sp['solve.setup']:.4f},"
                    f" solve.sweep {sp['solve.sweep']:.4f}, solve.refine "
                    f"{sp['solve.refine']:.4f}), overlap "
                    f"{r['overlap_efficiency']:.3f}; launches "
                    f"{ {n: c - before[n] for n, c in launch_counts().items()} }")
                if not (res <= 1e-10 and r["refine_converged"]):
                    raise AssertionError(f"{a.name}/{alg}/k={k}: residual "
                                         f"{res:.3e}, converged "
                                         f"{r['refine_converged']}")
            plans.append((a, plan))
    return plans


def profile_call(label: str, fn) -> list:
    """Device busy share of one warm call of ``fn``: the union of the CUDA
    kernel and copy intervals that ``torch.profiler`` records (device
    activity only), over the host wall time of the profiled call, which
    includes the profiler's own overhead. Returns the (start, end, name)
    intervals in µs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end, by_name = 0.0, float("-inf"), {}
    for s0, s1, name in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
        # summed by the name's first 60 characters, as printed
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (s1 - s0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile {label}: wall {wall:.4f} s, device "
        f"busy {busy / 1e6:.4f} s ({busy / 1e6 / wall:.4f} of wall), "
        f"{len(spans)} device events; top (s): "
        + json.dumps({n: round(t / 1e6, 6) for n, t in top}))
    return spans


def kernel_device_s(spans, stem: str) -> dict:
    """Summed device seconds of the kernels whose name starts with ``stem``
    among profiler intervals, by kernel (template arguments kept), and
    their total."""
    import re

    by: dict = {}
    for s0, s1, name in spans:
        m = re.search(stem + r"\w*(<[^>]*>)?", name)
        if m:
            by[m.group(0)] = by.get(m.group(0), 0.0) + (s1 - s0) / 1e6
    return dict(sorted(by.items()), total=sum(by.values()))


def record(out: dict, name, shape, err, ms, plain_ms, lib_ms, flops, nbytes,
           peak, headline) -> None:
    """Log one kernel measurement and keep it in ``out[name]`` (the max
    error over all of the kernel's checks; the times of the ``headline``
    shape for the ``kernels`` line)."""
    bms, by = bound(flops, nbytes, peak)
    log(f"kernel {name} {shape}: max_abs_err {err:.3e}, ms {ms:.5f}, "
        f"plain_ms {plain_ms:.5f}, bound_ms {bms:.5f} ({by}), "
        f"library_ms {lib_ms if lib_ms is None else f'{lib_ms:.5f}'}")
    rec = out.setdefault(name, dict(max_abs_err=0.0))
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    if headline:
        rec.update(name=name, route="cuda", source=SOURCE[name],
                   replaces=REPLACES[name], ms=ms, plain_ms=plain_ms,
                   bound_ms=bms, bound_by=by, library_ms=lib_ms)


def pick_buckets(schedule, routes) -> dict:
    """(level, bucket) keys: the most populated and the largest bucket, and
    the same among buckets that receive extend-add contributions."""
    keys = [(li, bj) for li in range(schedule.nlevels)
            for bj in range(len(schedule.buckets[li]))]
    size = lambda k: len(schedule.buckets[k[0]][k[1]].members)  # noqa: E731
    width = lambda k: schedule.buckets[k[0]][k[1]].M  # noqa: E731
    fed = [k for k in keys if k in routes]
    return {"populated": max(keys, key=size), "largest": max(keys, key=width),
            "populated_fed": max(fed, key=size),
            "largest_fed": max(fed, key=width)}


def bucket_inputs(pa, f, routes, key, dev) -> tuple:
    """Bucket ``key``'s assembled workspaces on ``dev``, and its extend-add
    groups (source stack, offset, src, dst, rows) from the factored stacks
    of the pipelined factorization ``f`` of ``pa``."""
    from repro_torch.device import to_device
    from repro_torch.sparse.multifrontal import _assemble_bucket

    sched = f.schedule
    bk = sched.buckets[key[0]][key[1]]
    w0 = to_device(_assemble_bucket(pa, sched, bk), dev)
    return bk, w0, bucket_inputs_groups(f, routes, key)


def extend_add_as_path(f, routes, key, dev):
    """A function that runs bucket ``key``'s extend-add into a copy of its
    workspaces as this tree's ``_factor_pipelined`` runs it: one launch
    per destination bucket from the routing of the whole factorization,
    uploaded beforehand (``_device_routing``), or, on a tree without one, a
    launch and a routing upload per source group."""
    from repro_torch.kernels import ops
    from repro_torch.sparse import multifrontal as mf

    sched = f.schedule
    if hasattr(mf, "_device_routing"):
        routing, fed = mf._device_routing(sched)
        routing = routing.to(dev)
        d, skeys = fed[key]
        us = [f.device_stacks[k] for k in skeys]
        offs = [sched.buckets[k[0]][k[1]].P for k in skeys]
        return lambda w: ops.extend_add_routed(w, us, offs, routing, d)
    groups = bucket_inputs_groups(f, routes, key)

    def run(w):
        for u, off, src, dst, rows in groups:
            ops.extend_add_batch(w, u, dst, rows, src=src, off=off)
    return run


def bucket_inputs_groups(f, routes, key) -> list:
    """Bucket ``key``'s extend-add groups (source stack, offset, src, dst,
    rows), in the order the per-group launches ran them."""
    sched = f.schedule
    groups = []
    for skey, contribs in sorted(routes.get(key, {}).items()):
        contribs.sort(key=lambda c: c[1])
        groups.append((f.device_stacks[skey],
                       sched.buckets[skey[0]][skey[1]].P,
                       np.array([c[0] for c in contribs], np.int32),
                       np.array([c[1] for c in contribs], np.int32),
                       np.stack([c[2] for c in contribs])))
    return groups


def copy_events(spans, kind: str = "HtoD") -> dict:
    """Count and summed seconds of the profiler's copy events of ``kind``
    (``HtoD``, ``DtoH``, ``DtoD``)."""
    ts = [(s1 - s0) / 1e6 for s0, s1, name in spans
          if name.startswith("Memcpy") and kind in name]
    return dict(count=len(ts), s=sum(ts))


def tile_fronts(pa, f, routes, dev) -> dict:
    """{tag: (bucket, workspace, front)} of the fronts the tile checks run
    on: the peak front (the root's, m = 1,208 on 32³/nd) and the first of
    the most populated bucket (a leaf), each assembled as the factor
    assembles it (A's entries and the children's Schur blocks)."""
    from repro_torch.kernels import frontal_cholesky as fc

    sched = f.schedule
    picks = pick_buckets(sched, routes)
    peak = max(sched.fronts, key=lambda fp: fp.m).k
    slot = {"populated": (picks["populated"], 0)}
    for li in range(sched.nlevels):
        for bj, bk in enumerate(sched.buckets[li]):
            if peak in bk.members:
                slot["peak"] = ((li, bj), bk.members.index(peak))
    fronts = {}
    for tag in ("peak", "populated"):
        key, bi = slot[tag]
        bk, w0, groups = bucket_inputs(pa, f, routes, key, dev)
        for u, off, src, dst, rows in groups:
            fc.extend_add_batch(w0, u, dst, rows, src=src, off=off)
        fronts[tag] = (bk, w0[bi], bk.members[bi])
    return fronts


def per_front_products(sched, bs: int = 128) -> dict:
    """{(rows, N, K): launches} of matmul_nt on the per-front path:
    ``ops.frontal_factor`` pads each front to P + R in multiples of bs and,
    per panel but the last of a front with no update rows, launches the
    panel product (M - hi, bs, bs) and the trailing one (M - hi, M - hi,
    bs)."""
    shapes: dict = {}
    for fp in sched.fronts:
        P = -(-fp.npiv // bs) * bs
        M = P + -(-fp.nrest // bs) * bs
        for hi in range(bs, P + 1, bs):
            if hi < M:
                for key in ((M - hi, bs, bs), (M - hi, M - hi, bs)):
                    shapes[key] = shapes.get(key, 0) + 1
    return dict(sorted(shapes.items()))


def spd_stack(B: int, M: int, dev, seed: int = 0):
    """The lower triangles of B seeded SPD (M, M) float32 fronts on dev."""
    import torch

    g = torch.randn((B, M, M), generator=torch.Generator(device=dev)
                    .manual_seed(seed), device=dev, dtype=torch.float64)
    eye = torch.eye(M, device=dev, dtype=torch.float64)
    return torch.tril(g @ g.transpose(1, 2) / M + 2 * eye).float()


def same_bits(name: str, shape: str, x, y) -> None:
    """Raise unless x and y hold the same bits (two runs of a kernel)."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(x.contiguous().view(torch.int32),
                       y.contiguous().view(torch.int32)):
        raise AssertionError(f"{name} {shape}: two runs differ")


def frontal_check(out: dict, shape: str, w0, P: int, bs: int,
                  headline: bool) -> dict:
    """frontal_factor_batch on a copy of the (B, M, M) stack w0 against its
    plain version (lower triangles), run twice with the same bits both
    times, timed beside the plain version; returns the times."""
    import torch

    from repro_torch.kernels import frontal_cholesky as fc

    B, M, _ = w0.shape
    wk, wp, again = w0.clone(), w0.clone(), w0.clone()
    fc.frontal_factor_batch(wk, P, bs=bs)
    fc.frontal_factor_batch_plain(wp, P, bs)
    err = compare("frontal_factor_batch", torch.tril(wk), torch.tril(wp))
    fc.frontal_factor_batch(again, P, bs=bs)
    same_bits("frontal_factor_batch", shape, again, wk)
    ms = device_ms(lambda: fc.frontal_factor_batch(wk, P, bs=bs),
                   setup=lambda: wk.copy_(w0))
    pms = stream_ms(lambda: fc.frontal_factor_batch_plain(wp, P, bs),
                    setup=lambda: wp.copy_(w0))
    R = M - P
    record(out, "frontal_factor_batch", f"{shape} B={B} P={P} M={M} bs={bs}",
           err, ms, pms, None, B * (P ** 3 / 3 + P * P * R + P * R * R),
           2 * w0.numel() * 4, PEAK_FP32, headline)
    return dict(ms=ms, plain_ms=pms, max_abs_err=err)


def width_cases(sched, picks) -> list:
    """(tag, key) of the populated and the largest bucket, then the most
    populated bucket of every other pivot width; logs the widths."""
    keys = [(li, bj) for li in range(sched.nlevels)
            for bj in range(len(sched.buckets[li]))]
    size = lambda k: len(sched.buckets[k[0]][k[1]].members)  # noqa: E731
    widths: dict = {}
    for key in keys:
        widths.setdefault(sched.buckets[key[0]][key[1]].P, []).append(key)
    log("buckets by pivot width (buckets, fronts): "
        + json.dumps({p: [len(ks), sum(map(size, ks))]
                      for p, ks in sorted(widths.items())})
        + f"; {sum(size(k) == 1 for k in keys)} of {len(keys)} buckets hold "
        f"one front")
    cases = [("populated", picks["populated"]), ("largest", picks["largest"])]
    for p, ks in sorted(widths.items()):
        key = max(ks, key=size)
        if key not in dict(cases).values():
            cases.append(("by width", key))
    return cases


def kernel_checks(a, plan, dev) -> dict:
    """Each kernel against its plain version at the 32³ schedule's shapes,
    on the inputs the main path gives it, with times and bounds. Returns
    {kernel: record}; the record kept for the ``kernels`` line is the one of
    the largest bucket (one RHS, lower sweep)."""
    import torch

    from repro_torch.device import to_device
    from repro_torch.kernels import frontal_cholesky as fc
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import load_kernels
    from repro_torch.sparse.csr import permute_symmetric
    from repro_torch.sparse.multifrontal import (_route_contributions,
                                                 multifrontal_cholesky)

    pa = permute_symmetric(a, plan.perm)
    before = fc.extend_add_batch.launches
    f = multifrontal_cholesky(pa, sym=plan.sym, device=dev)
    n_ea = fc.extend_add_batch.launches - before
    sched = f.schedule
    routes = _route_contributions(sched)
    picks = pick_buckets(sched, routes)
    # one extend-add launch per fed bucket, and one more per further
    # EA_MAX_GROUPS source groups
    most = sum(-(-len(g) // fc.EA_MAX_GROUPS) for g in routes.values())
    log(f"extend_add launches in a pipelined factorization of {a.name}: "
        f"{n_ea} ({len(routes)} fed buckets, "
        f"{sum(len(g) for g in routes.values())} source groups)")
    if n_ea > most:
        raise AssertionError(f"extend_add launched {n_ea} times for "
                             f"{len(routes)} fed buckets (at most {most})")
    log("schedule " + json.dumps({k: f.stats[k] for k in (
        "nsup", "nlevels", "nbatches", "peak_front", "front_flops",
        "occupancy")}) + " buckets " + json.dumps(
        {t: [len(sched.buckets[li][bj].members), sched.buckets[li][bj].P,
             sched.buckets[li][bj].R] for t, (li, bj) in picks.items()}))
    rng = np.random.default_rng(1)
    out: dict = {}

    # extend_add_batch: a bucket's real contributions, read from the
    # factored stacks of the factorization above, launched as the path
    # launches them (one launch, the routing uploaded beforehand); the same
    # bits as the plain version applied group by group, twice
    for tag in ("populated_fed", "largest_fed"):
        bk, w0, groups = bucket_inputs(pa, f, routes, picks[tag], dev)
        wk, wp, wl = w0.clone(), w0.clone(), w0.clone()
        run_path = extend_add_as_path(f, routes, picks[tag], dev)

        def run_kernel():
            run_path(wk)

        def run_plain():
            for u, off, src, dst, rows in groups:
                fc.extend_add_batch_plain(wp, u, dst, rows, src, off)

        before = fc.extend_add_batch.launches
        run_kernel()
        n_launch = fc.extend_add_batch.launches - before
        run_plain()
        err = compare("extend_add_batch", wk, wp)
        again = w0.clone()
        run_path(again)
        same_bits("extend_add_batch", tag, again, wk)
        # the library call: one index_put_(accumulate=True) of every entry
        di, ri, ci, vals = [], [], [], []
        for u, off, src, dst, rows in groups:
            for c in range(rows.shape[0]):
                act = np.flatnonzero(rows[c] >= 0)
                r = rows[c][act]
                di.append(np.full(act.size ** 2, dst[c]))
                ri.append(np.repeat(r, act.size))
                ci.append(np.tile(r, act.size))
                vals.append(u[int(src[c]), off + act[:, None],
                              off + act[None, :]].reshape(-1))
        pos = np.stack([np.concatenate(v) for v in (di, ri, ci)])
        idx = tuple(to_device(p.astype(np.int64), dev) for p in pos)
        vals_t = torch.cat(vals)
        n_u, touched = pos.shape[1], np.unique(pos, axis=1).shape[1]
        ms = device_ms(run_kernel, setup=lambda: wk.copy_(w0))
        pms = stream_ms(run_plain, setup=lambda: wp.copy_(w0))
        lms = device_ms(lambda: wl.index_put_(idx, vals_t, accumulate=True),
                        setup=lambda: wl.copy_(w0))
        # each active U entry read once, each touched W entry read and
        # written once, the row maps and slot indices read once
        nbytes = n_u * 4 + touched * 8 + sum(g[4].size * 4 + 8 * g[2].size
                                             for g in groups)
        record(out, "extend_add_batch",
               f"{tag} B={len(bk.members)} M={bk.M} groups={len(groups)} "
               f"C={sum(g[2].size for g in groups)} entries={n_u} "
               f"launches={n_launch} (same bits twice)",
               err, ms, pms, lms, n_u, nbytes, PEAK_FP32,
               tag == "largest_fed")

    extend_add_seeded(dev)

    # frontal_factor_batch on the workspaces the main path factors (A's
    # entries plus the children's Schur blocks) at the populated and the
    # largest bucket and the most populated bucket of every other pivot
    # width; then seeded stacks at bs = 20 (mult8), bs = 3 (npiv < 8) and
    # P = M (no trailing block)
    cases = width_cases(sched, picks)
    for tag, key in cases:
        bk, w0, groups = bucket_inputs(pa, f, routes, key, dev)
        for u, off, src, dst, rows in groups:
            fc.extend_add_batch(w0, u, dst, rows, src=src, off=off)
        frontal_check(out, tag, w0, bk.P, ops.pick_block_size(bk.P),
                      tag == "largest")
    for B, M, P, bs in ((2, 56, 40, 20), (3, 5, 3, 3), (1, 64, 64, 32)):
        frontal_check(out, "seeded", spd_stack(B, M, dev, seed=M), P, bs,
                      False)

    # tri_solve_batch on the factored L11 of the same buckets, lower and
    # upper, at one RHS and at eight
    for tag, (li, bj) in cases:
        bk = sched.buckets[li][bj]
        B, P = len(bk.members), bk.P
        L = f.device_stacks[(li, bj)][:, :P, :P]
        bs = ops.pick_block_size(P)
        for k in (1, 8):
            x0 = torch.as_tensor(rng.standard_normal((B, P, k)),
                                 dtype=torch.float32, device=dev)
            for lower in (True, False):
                tri_solve_check(out, f"{tag} B={B} P={P} M={bk.M}", L, x0,
                                bs, k, lower,
                                tag == "largest" and k == 1 and lower)
    # two layouts the solve path never produces: P = 512 with a ragged
    # second RHS tile and an odd row stride (4-byte copies), and P = 1,792,
    # whose slab and inverses outgrow shared memory
    for P, M, K in ((512, 515, 40), (1792, 1792, 32)):
        g = torch.randn((P, P), generator=torch.Generator(device=dev)
                        .manual_seed(P), device=dev, dtype=torch.float64)
        W = torch.zeros((1, M, M), device=dev)
        W[0, :P, :P] = torch.linalg.cholesky(g @ g.T / P + 2 * torch.eye(
            P, device=dev, dtype=torch.float64)).float()
        x0 = torch.as_tensor(rng.standard_normal((1, P, K)),
                             dtype=torch.float32, device=dev)
        for lower in (True, False):
            tri_solve_check(out, f"layout B=1 P={P} ldl={M}", W[:, :P, :P],
                            x0, 32, 32, lower, False)

    # the tile kernels on the first panel of a front as the per-front path
    # builds it: the peak front, with matmul_nt at every (M, N, K) the
    # per-front path launches, and a leaf front
    shapes = per_front_products(sched)
    log("per_front matmul_nt shapes (rows, N, K): launches "
        + json.dumps({str(k): v for k, v in shapes.items()}))
    ops = load_kernels()
    for rows, n, _ in shapes:
        bm, bn, tiles_m, tiles_n = ops.matmul_nt_plan(rows, n)
        log(f"matmul_nt plan ({rows}, {n}): {bm} x {bn} output tiles, "
            f"{tiles_m} x {tiles_n} blocks")
        if not (bm * tiles_m >= rows > bm * (tiles_m - 1)
                and bn * tiles_n >= n > bn * (tiles_n - 1)):
            raise AssertionError(f"matmul_nt plan at ({rows}, {n}) does not "
                                 f"cover the output once")
    for tag, (bk, w, k) in tile_fronts(pa, f, routes, dev).items():
        tile_checks(tag, sched, bk, w, k, out,
                    shapes if tag == "peak" else None)
    ragged_tile_checks(dev, out)

    bell_spmv_checks(pa, dev, rng, out)
    return out


def extend_add_seeded(dev) -> None:
    """extend_add_routed on seeded cases the 32³ path never gives, each held
    to the plain version applied group by group (no difference allowed) and
    run twice for the same bits: unaligned rows (Mu, offset and M odd: the
    scalar kernel, at R = 5 and at R = 300 with four warps a row); 40
    contributions to one slot; rows wider than a warp's staging buffer
    (M = 6,200 with two contributions of R = 3,100, a warp a row; M = 8,192
    with two of R = 520 spread over the row, four warps a row); and 40
    source groups, more than one launch's table holds."""
    import torch

    from repro_torch.kernels import frontal_cholesky as fc

    rng = np.random.default_rng(5)

    def group(B, M, C, R, Bu, Mu, off, slot=None, full=False):
        u = torch.as_tensor(rng.standard_normal((Bu, Mu, Mu)),
                            dtype=torch.float32, device=dev)
        dst = (np.sort(rng.integers(0, B, C)) if slot is None
               else np.full(C, slot))
        rows = np.full((C, R), -1, np.int64)
        for c in range(C):
            k = R if full else int(rng.integers(1, R + 1))
            rows[c, :k] = np.sort(rng.choice(M, k, replace=False))
        return u, off, rng.integers(0, Bu, C), dst, rows

    cases = (("unaligned R=5 off=3 Mu=11 M=13", 3, 13,
              [group(3, 13, 9, 5, 4, 11, 3)]),
             ("unaligned wide R=300 off=3 Mu=307 M=1001", 2, 1001,
              [group(2, 1001, 3, 300, 2, 307, 3)]),
             ("40 contributions to one slot", 2, 64,
              [group(2, 64, 40, 16, 6, 24, 8, slot=1)]),
             ("rows wider than the buffer M=6200, a warp a row", 1, 6200,
              [group(1, 6200, 2, 3100, 2, 3104, 4, slot=0, full=True)]),
             ("rows wider than the buffer M=8192, four warps a row", 1, 8192,
              [group(1, 8192, 2, 520, 2, 528, 8, slot=0, full=True)]),
             ("40 source groups", 4, 48,
              [group(4, 48, 3, 8, 2, 16, 8) for _ in range(40)]))
    for tag, B, M, groups in cases:
        routing = fc.extend_add_routing(
            [(M, [(src, dst, rows) for _, _, src, dst, rows in groups])]
        ).to(dev)
        us = [g[0] for g in groups]
        offs = [g[1] for g in groups]
        w0 = torch.as_tensor(rng.standard_normal((B, M, M)),
                             dtype=torch.float32, device=dev)
        wk, wp, again = w0.clone(), w0.clone(), w0.clone()
        before = fc.extend_add_batch.launches
        fc.extend_add_routed(wk, us, offs, routing, 0)
        n_launch = fc.extend_add_batch.launches - before
        for u, off, src, dst, rows in groups:
            fc.extend_add_batch_plain(wp, u, dst, rows, src, off)
        err = compare("extend_add_batch", wk, wp)
        fc.extend_add_routed(again, us, offs, routing, 0)
        same_bits("extend_add_batch", tag, again, wk)
        ms = device_ms(lambda: fc.extend_add_routed(wk, us, offs, routing, 0),
                       setup=lambda: wk.copy_(w0))
        log(f"kernel extend_add_batch seeded {tag}: B={B} M={M} "
            f"groups={len(groups)} C={sum(g[2].size for g in groups)} "
            f"launches={n_launch}, max_abs_err {err:.3e}, same bits twice, "
            f"ms {ms:.5f}")
        want = -(-len(groups) // fc.EA_MAX_GROUPS)
        if n_launch != want:
            raise AssertionError(f"extend_add {tag}: {n_launch} launches, "
                                 f"want {want}")


def bell_spmv_checks(pa, dev, rng, out: dict) -> None:
    """bell_spmv against its plain version and ``pa.matvec`` on fp64 blocks
    (the residual's) at one RHS and eight: on the permuted 32³ matrix at the
    block size the solve path picks (the ``kernels`` line's record at one
    RHS), at bs = 8 (the reference's layout), 4, 2 and 3 (the generic
    kernel), and on the served ``circuit_9`` (a row of 414 entries) at its
    picked bs; each timed beside ``torch.sparse.mm`` on the same CSR, its
    bound from the bytes that case stores. Then float32 at the picked bs
    and at 8, held against the plain version only."""
    import warnings

    import torch

    from repro_torch.device import to_device
    from repro_torch.kernels.spmv_bell import (bell_spmv, bell_spmv_plain,
                                               csr_to_bell, pick_spmv_bs)
    from repro_torch.sparse.dataset import generate_suite

    picked = pick_spmv_bs(pa.indptr, pa.indices, pa.n)
    c9 = next(m for m in generate_suite(16, seed=1, size_scale=4)
              if m.name == "circuit_9")
    cases = [(pa, picked, "(picked)")] + [
        (pa, bs, "") for bs in (8, 4, 2, 3) if bs != picked] + [
        (c9, pick_spmv_bs(c9.indptr, c9.indices, c9.n), "(picked)")]
    for m, bs, how in cases:
        blocks, idxa, npad = csr_to_bell(m.indptr, m.indices, m.data, m.n, bs)
        blocks_d, idx_d = to_device(blocks, dev), to_device(idxa, dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "beta" CSR notice
            A_csr = torch.sparse_csr_tensor(
                torch.as_tensor(m.indptr, dtype=torch.int64),
                torch.as_tensor(m.indices, dtype=torch.int64),
                torch.as_tensor(m.data, dtype=torch.float64),
                size=m.shape, check_invariants=True).to(dev)
        for k in (1, 8):
            x = torch.zeros((npad, k), dtype=torch.float64, device=dev)
            x[:m.n] = torch.as_tensor(rng.standard_normal((m.n, k)),
                                      device=dev)
            yk = bell_spmv(blocks_d, idx_d, x)
            err = compare("bell_spmv", yk, bell_spmv_plain(blocks_d, idx_d, x))
            ref = torch.as_tensor(m.matvec(x[:m.n].cpu().numpy()), device=dev)
            err = max(err, compare("bell_spmv", yk[:m.n], ref))
            xs = x[:m.n].contiguous()
            ms = device_ms(lambda: bell_spmv(blocks_d, idx_d, x))
            pms = stream_ms(lambda: bell_spmv_plain(blocks_d, idx_d, x))
            lms = device_ms(lambda: torch.sparse.mm(A_csr, xs))
            # every stored block (ELL padding included), the indices, x and y
            nbytes = blocks.nbytes + idxa.nbytes + 2 * x.numel() * 8
            record(out, "bell_spmv",
                   f"{m.name} n={m.n} nnz={m.nnz} bs={bs} {how} "
                   f"nrb={blocks.shape[0]} max_k={blocks.shape[1]} k={k} "
                   f"stored {blocks.nbytes + idxa.nbytes} bytes",
                   err, ms, pms, lms, 2 * blocks.size * k, nbytes, PEAK_FP64,
                   m is pa and bs == picked and k == 1)
        if m is pa and bs in (picked, 8):
            for k in (1, 8):
                x = torch.as_tensor(rng.standard_normal((npad, k)),
                                    dtype=torch.float32, device=dev)
                b32 = blocks_d.float()
                got = bell_spmv(b32, idx_d, x)
                torch.cuda.synchronize()
                want = bell_spmv_plain(b32, idx_d, x)
                rel = float((got - want).abs().max() / want.abs().max())
                log(f"kernel bell_spmv float32 {m.name} bs={bs} k={k}: max "
                    f"rel err {rel:.3e} (limit {BELL_F32_RTOL})")
                if not rel <= BELL_F32_RTOL:
                    raise AssertionError(f"bell_spmv float32 bs={bs} k={k}: "
                                         f"{rel:.3e} relative")


def bell_spmv_resources(ops) -> None:
    """Registers, shared memory and spills of every bell_spmv kernel: the
    segment kernel at bs 1, 2, 4 and 8 and the generic one (bs 3), at one
    RHS and a tile of eight, fp64 and fp32 (lanes a block-row at the 32³
    matrix's max_k of that bs)."""
    for fp64 in (True, False):
        for bs, max_k in ((1, 7), (2, 13), (4, 22), (8, 31), (3, 17)):
            for k in (1, 8):
                seg, lanes, regs, smem, local = ops.bell_spmv_info(
                    bs, k, fp64, max_k)
                how = (f"segment kernel, {lanes} lanes a block-row at max_k "
                       f"{max_k}" if seg else
                       f"generic kernel, a block of {lanes} threads a "
                       f"block-row")
                log(f"bell_spmv {'fp64' if fp64 else 'fp32'} bs={bs} k={k} "
                    f"({how}): {regs} registers a thread, {smem} bytes of "
                    f"shared memory a block, {local} bytes of local memory "
                    f"(spills) a thread")


def tri_solve_check(out: dict, shape: str, L, x0, bs: int, kt: int,
                    lower: bool, headline: bool) -> dict:
    """tri_solve_batch against its plain version on (L, x0) at panel bs and
    RHS tile kt, timed beside the plain version and
    ``torch.linalg.solve_triangular`` on tril(L); returns the times."""
    import torch

    from repro_torch.kernels import frontal_cholesky as fc

    B, P, k = x0.shape
    xk, xp = x0.clone(), x0.clone()
    fc.tri_solve_batch(L, xk, bs=bs, kt=kt, lower=lower)
    fc.tri_solve_batch_plain(L, xp, bs, lower)
    err = compare("tri_solve_batch", xk, xp)
    ms = device_ms(lambda: fc.tri_solve_batch(L, xk, bs=bs, kt=kt,
                                              lower=lower),
                   setup=lambda: xk.copy_(x0))
    pms = stream_ms(lambda: fc.tri_solve_batch_plain(L, xp, bs, lower),
                    setup=lambda: xp.copy_(x0))
    Lt = torch.tril(L).contiguous()
    lms = device_ms(lambda: torch.linalg.solve_triangular(
        Lt if lower else Lt.transpose(1, 2), x0, upper=not lower))
    # the triangle of L read once, x read and written once
    nbytes = B * (P * (P + 1) // 2 * 4 + 2 * P * k * 4)
    record(out, "tri_solve_batch", f"{shape} k={k} kt={kt} bs={bs} "
           f"{'lower' if lower else 'upper'}", err, ms, pms, lms,
           B * P * P * k, nbytes, PEAK_FP32, headline)
    return dict(ms=ms, plain_ms=pms, library_ms=lms, max_abs_err=err)


def tile_resources(ops) -> None:
    """Registers, shared memory and spills of every tile-kernel
    instantiation (``tile_kernels_info``): chol_tile, tri_inv_tile at 1, 2
    and 4 diagonal blocks, matmul_nt at each output tile with 16- and
    4-byte copies."""
    i = 0
    while info := ops.tile_kernels_info(i):
        kind, p0, p1, p2, threads, regs, smem, local = info
        what = (f"chol_tile bs<={p0}" if kind == 0 else
                f"tri_inv_tile {p0} diagonal block{'s' if p0 > 1 else ''}"
                if kind == 1 else
                f"matmul_nt {p0} x {p1} output tile, "
                f"{16 if p2 else 4}-byte copies")
        log(f"tile_kernels {what}: {threads} threads, {regs} registers a "
            f"thread, {smem} bytes of shared memory a block, {local} bytes "
            f"of local memory (spills) a thread")
        i += 1


def frontal_resources(ops) -> None:
    """Registers, shared memory and spills of every frontal_factor_batch
    kernel instantiation (``frontal_factor_info``): the whole-front kernel
    of M <= 16 and M <= 32, the diagonal step at blocks 8, 16 and 32 wide,
    the panel step and the Schur step at
    each output tile, with 16- and 4-byte copies."""
    i = 0
    while info := ops.frontal_factor_info(i):
        kind, p0, p1, p2, threads, regs, smem, local = info
        what = (f"whole front of M <= {p0}, a warp a front" if kind == 3
                else f"diagonal step, {p0}-wide blocks, {p1} warp"
                f"{'s' if p1 > 1 else ''} a front" if kind == 0 else
                f"panel step, {16 if p2 else 4}-byte copies" if kind == 1
                else f"Schur step, {p0} x {p0} output tile, {p1} x {p1} a "
                     f"thread, {16 if p2 else 4}-byte copies")
        log(f"frontal_factor {what}: {threads} threads, {regs} registers a "
            f"thread, {smem} bytes of shared memory a block, {local} bytes "
            f"of local memory (spills) a thread")
        i += 1


def stream_kernel_resources(ops) -> None:
    """Registers, shared memory and spills of the extend_add and row_stats
    kernels, with scalar and with 16-byte loads."""
    for name, info in (("extend_add", ops.extend_add_info),
                       ("row_stats", ops.row_stats_info)):
        for i in (0, 1):
            vec, threads, regs, smem, local = info(i)
            log(f"{name} {16 if vec else 4}-byte loads: {threads} threads, "
                f"{regs} registers a thread, {smem} bytes of shared memory a "
                f"block, {local} bytes of local memory (spills) a thread")


def tri_solve_resources(ops) -> None:
    """The tri_solve kernel picked at each shape the checks run, with its
    registers, shared memory, spills and (block variant) layout."""
    for P, kt in ((8, 1), (16, 1), (32, 8), (64, 1), (128, 8), (256, 1),
                  (256, 8), (512, 32), (1792, 32)):
        for lower in (True, False):
            v, regs, smem, local, inv_all, nst, ch, slab = ops.tri_solve_info(
                P, kt, min(P, 32), lower)
            how = ("a segment of lanes per (front, column)" if v == 0 else
                   f"a block per (front, RHS tile); inverses "
                   f"{'all ahead of the chain' if inv_all else 'one a step'}"
                   f", ring of {nst} stages of {ch} strip "
                   f"{'rows' if lower else 'columns'}, slab in "
                   f"{'shared' if slab else 'device'} memory")
            log(f"tri_solve_batch P={P} kt={kt} {'lower' if lower else 'upper'}"
                f" ({how}): {regs} registers a thread, {smem} bytes of shared "
                f"memory a block, {local} bytes of local memory (spills) a "
                f"thread")


def tile_checks(tag: str, sched, bucket, w, k: int, out: dict,
                shapes=None) -> dict:
    """chol_tile, tri_inv_tile and matmul_nt against their plain versions
    on the first panel of ``ops.frontal_factor`` for front ``k`` of
    ``bucket``, whose assembled workspace (A's entries and the children's
    Schur blocks) is ``w`` in the bucket's padded layout, each timed beside
    its plain version and one library call. With ``shapes`` (the
    ``per_front_products`` of the path), matmul_nt also runs at every row
    count the path launches (the first rows of this panel's products) and
    tri_inv_tile at the ragged widths 100 and 33 (leading blocks of the
    factor). Returns {case: kernel ms}."""
    import torch

    from repro_torch.kernels import frontal_cholesky as fc
    from repro_torch.kernels import ops

    fp = sched.fronts[k]
    idx = torch.cat([torch.arange(fp.npiv),
                     bucket.P + torch.arange(fp.nrest)]).to(w.device)
    bs = 128
    W = ops.front_workspace(w[idx][:, idx], fp.npiv, -(-fp.npiv // bs) * bs,
                            -(-fp.nrest // bs) * bs)
    M = W.shape[0]
    shape = f"{tag} front m={fp.m} npiv={fp.npiv} M={M}"
    headline = tag == "peak"
    times = {}

    def tri_bytes(n):  # the lower triangle read, the tile written
        return (n * (n + 1) // 2 + n * n) * 4

    # the path's tile (a strided view of the workspace), then leading
    # blocks of it and the tile on an odd row stride (4-byte copies)
    a = W[:bs, :bs]
    odd = torch.zeros((bs, bs + 3), device=W.device)
    odd[:, :bs] = a
    for case, x in ((f"bs={bs}", a), ("bs=100", a[:100, :100]),
                    ("bs=33", a[:33, :33]),
                    (f"bs={bs} lda={bs + 3}", odd[:, :bs])) if shapes else (
                        (f"bs={bs}", a),):
        n = x.shape[0]
        sym = (torch.tril(x) + torch.tril(x, -1).T).contiguous()
        got = fc.chol_tile(x)
        err = compare("chol_tile", got, fc.chol_tile_plain(x))
        same_bits("chol_tile", case, got, fc.chol_tile(x))
        times[f"chol_tile {case}"] = ms = device_ms(lambda: fc.chol_tile(x))
        record(out, "chol_tile", f"{shape} {case}", err, ms,
               stream_ms(lambda: fc.chol_tile_plain(x)),
               device_ms(lambda: torch.linalg.cholesky(sym)), n ** 3 / 3,
               tri_bytes(n), PEAK_FP32, headline and case == f"bs={bs}")
    L = fc.chol_tile(a)

    # the path's tile, then leading blocks of it: strided views of L
    for n in (bs, 100, 33) if shapes else (bs,):
        Ln = L[:n, :n]
        eye, Lc = torch.eye(n, device=W.device), Ln.contiguous()
        err = compare("tri_inv_tile", fc.tri_inv_tile(Ln),
                      fc.tri_inv_tile_plain(Ln))
        times[f"tri_inv_tile bs={n}"] = ms = device_ms(
            lambda: fc.tri_inv_tile(Ln))
        record(out, "tri_inv_tile", f"{shape} bs={n}", err, ms,
               stream_ms(lambda: fc.tri_inv_tile_plain(Ln)),
               device_ms(lambda: torch.linalg.solve_triangular(
                   Lc, eye, upper=False)),
               n ** 3 / 3, tri_bytes(n), PEAK_FP32, headline and n == bs)
    inv = fc.tri_inv_tile(L)

    panel = W[bs:, :bs]
    lpanel = fc.matmul_nt(panel, inv, torch.zeros_like(panel), alpha=1.0,
                          beta=0.0)
    trail = W[bs:, bs:]
    rows_all = sorted({r for r, _, _ in shapes if r <= M - bs},
                      reverse=True) if shapes else [M - bs]
    for rows in rows_all:
        for what, (x, y, c, alpha, beta) in (
                ("panel", (panel[:rows], inv,
                           torch.zeros_like(panel[:rows]), 1.0, 0.0)),
                ("trailing", (lpanel[:rows], lpanel[:rows],
                              trail[:rows, :rows], -1.0, 1.0))):
            m_, k_, n_ = x.shape[0], x.shape[1], y.shape[0]
            got = fc.matmul_nt(x, y, c, alpha=alpha, beta=beta)
            err = compare("matmul_nt", got,
                          fc.matmul_nt_plain(x, y, c, alpha, beta))
            xc, yc, cc = x.contiguous(), y.contiguous(), c.contiguous()
            times[f"matmul_nt {what} rows={rows}"] = ms = device_ms(
                lambda: fc.matmul_nt(x, y, c, alpha=alpha, beta=beta))
            n_launch = (shapes or {}).get((m_, n_, k_))
            record(out, "matmul_nt", f"{shape} {what} ({m_} x {k_}) "
                   f"({n_} x {k_})^T"
                   + (f", {n_launch} launches of the shape a per-front "
                      f"solve" if n_launch else ""), err, ms,
                   stream_ms(lambda: fc.matmul_nt_plain(x, y, c, alpha,
                                                        beta)),
                   device_ms(lambda: torch.addmm(cc, xc, yc.T, beta=beta,
                                                 alpha=alpha)),
                   2 * m_ * n_ * k_, 4 * (m_ * k_ + n_ * k_ + 2 * m_ * n_),
                   PEAK_FP32,
                   headline and what == "trailing" and rows == M - bs)
    return times


def ragged_tile_checks(dev, out: dict) -> None:
    """The tile kernels at a shape and on layouts the per-front path never
    gives them, which run matmul_nt's ragged tiles and its 4-byte copies
    and tri_inv_tile's 4-byte staging: matmul_nt at (M, N, K) =
    (200, 136, 72), then with every operand on an odd row stride, and
    tri_inv_tile on an odd row stride; seeded, each against its plain
    version at TOL, twice with the same bits, timed beside the library."""
    import torch

    from repro_torch.kernels import frontal_cholesky as fc

    gen = torch.Generator(device=dev).manual_seed(21)

    def odd(x):  # x on a row stride of its (even) width + 3
        buf = torch.zeros((x.shape[0], x.shape[1] + 3), device=dev)
        buf[:, : x.shape[1]] = x
        return buf[:, : x.shape[1]]

    a, b, c = (torch.randn(s, generator=gen, device=dev)
               for s in ((200, 72), (136, 72), (200, 136)))
    for case, (x, y, z) in (("(200 x 72)(136 x 72)^T", (a, b, c)),
                            ("odd strides", (odd(a), odd(b), odd(c)))):
        got = fc.matmul_nt(x, y, z, alpha=-1.0, beta=1.0)
        err = compare("matmul_nt", got, fc.matmul_nt_plain(x, y, z, -1.0, 1.0))
        same_bits("matmul_nt", case, got,
                  fc.matmul_nt(x, y, z, alpha=-1.0, beta=1.0))
        record(out, "matmul_nt", f"ragged {case} lda={x.stride(0)}", err,
               device_ms(lambda: fc.matmul_nt(x, y, z, alpha=-1.0, beta=1.0)),
               stream_ms(lambda: fc.matmul_nt_plain(x, y, z, -1.0, 1.0)),
               device_ms(lambda: torch.addmm(c, a, b.T, beta=1.0, alpha=-1.0)),
               2 * 200 * 136 * 72, 4 * (200 * 72 + 136 * 72 + 2 * 200 * 136),
               PEAK_FP32, False)
    n = 128
    t = spd_stack(1, n, dev, seed=n)[0]
    L = odd(torch.linalg.cholesky(t + torch.tril(t, -1).T))
    got = fc.tri_inv_tile(L)
    err = compare("tri_inv_tile", got, fc.tri_inv_tile_plain(L))
    same_bits("tri_inv_tile", "odd stride", got, fc.tri_inv_tile(L))
    Lc, eye = L.contiguous(), torch.eye(n, device=dev)
    record(out, "tri_inv_tile", f"ragged bs={n} ldl={L.stride(0)}", err,
           device_ms(lambda: fc.tri_inv_tile(L)),
           stream_ms(lambda: fc.tri_inv_tile_plain(L)),
           device_ms(lambda: torch.linalg.solve_triangular(Lc, eye,
                                                           upper=False)),
           n ** 3 / 3, (n * (n + 1) // 2 + n * n) * 4, PEAK_FP32, False)


def launched(phase: str, counts: dict, names) -> None:
    """Raise unless every kernel in ``names`` launched in ``phase``."""
    log(f"kernels {phase} " + json.dumps({"launches": counts}))
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {phase} path: "
                             f"{missing}")


def train_phase():
    """A SolverEngine (the defaults: device selection through the
    csr_stats kernels, pipelined solve) trained on the tracked label set."""
    from repro_torch.core.labeling import LabeledDataset
    from repro_torch.engine import EngineConfig, SolverEngine

    engine = SolverEngine(EngineConfig(fast_grids=True, cv=3))
    t0 = time.perf_counter()
    rep = engine.train(LabeledDataset.load(os.path.join(ROOT, LABELS)))
    log(f"train: {time.perf_counter() - t0:.3f} s on {LABELS}, held-out "
        f"accuracy {rep['test_accuracy']:.4f} (cv {rep['cv_score']:.4f}, "
        f"{rep['best_params']}), fingerprint {engine.fingerprint}")
    return engine


def route_splits(model, x_host: np.ndarray, x_dev: np.ndarray) -> list:
    """The splits on one matrix's host route where its device feature
    (float32) falls on the other side of the threshold than its host
    feature (float64): (tree, feature, threshold, host, device)."""
    out = []
    for t, tree in enumerate(getattr(model, "trees_", [model])):
        node = tree.root_
        while node.left is not None:
            h, d = x_host[node.feature], x_dev[node.feature]
            if (h <= node.threshold) != (d <= np.float32(node.threshold)):
                out.append((t, node.feature, node.threshold, h, d))
            node = node.left if h <= node.threshold else node.right
    return out


def select_phase(engine, mats, dev, label: str = "select") -> None:
    """``engine.select_batch`` on one served batch (cold, then warm), with
    the launch counts of this path, the device features against the host
    float64 featurizer, and the names against the host path's."""
    import torch

    from repro_torch.core.features import (extract_features_batch,
                                           extract_features_batch_device,
                                           pad_csr_batch)
    from repro_torch.core.scaling import scaler_transform_device
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sparse.dataset import suite_summary

    log(f"{label} batch " + json.dumps(suite_summary(mats)))
    reset_launch_counts()
    t0 = time.perf_counter()
    names = engine.select_batch(mats)
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        again = engine.select_batch(mats)
        warm.append(time.perf_counter() - t0)
        if again != names:
            raise AssertionError(f"selection is not repeatable: {names} "
                                 f"then {again}")
    launched(label, launch_counts(), ("entry_stats", "row_stats"))
    log(f"{label}: cold {cold:.4f} s, warm batch s {min(warm):.4f} "
        f"(median {sorted(warm)[2]:.4f}); names {names}")

    # the stages of one warm batch, each ending in a sync
    sel = engine.selector
    t0 = time.perf_counter()
    batch = pad_csr_batch(mats, bucket=True)
    t_pad = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = extract_features_batch_device(batch, device=dev)
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = sel._predict_device(feats)
    t_inf = time.perf_counter() - t0
    log(f"{label} stages: pad_csr_batch {t_pad:.4f} s "
        f"(E={batch.indices.shape[1]}, N={batch.indptr.shape[1] - 1}), "
        f"upload + featurize {t_feat:.4f} s, scaler + forest + argmax + "
        f"copy back {t_inf:.4f} s")

    host = extract_features_batch(mats)
    got = feats.cpu().numpy().astype(np.float64)
    rel = np.abs(got - host) / np.maximum(np.abs(host), 1e-30)
    log(f"{label} features: max rel err vs host float64 {rel.max():.3e}")
    if not rel.max() <= 1e-4:
        raise AssertionError(f"device features differ from the host's by "
                             f"{rel.max():.3e} relative")
    host_names, _ = sel.select_batch(mats, path="host")
    if [sel.algorithms[int(i)] for i in idx] != names:
        raise AssertionError("staged selection disagrees with select_batch")
    x_host = sel.scaler.transform(host)
    x_dev = scaler_transform_device(sel.scaler, feats).cpu().numpy()
    for i, (d, h) in enumerate(zip(names, host_names)):
        if d == h:
            continue
        splits = route_splits(sel.model, x_host[i], x_dev[i])
        # the deciding raw features may differ by float32 rounding only
        f32 = all(rel[i, f] <= F32_ROUNDING for _, f, _, _, _ in splits)
        log(f"{label} {mats[i].name}: device {d}, host {h}; splits between "
            f"the float64 and float32 features: {splits}")
        if not (splits and f32):
            raise AssertionError(f"{mats[i].name}: device selects {d}, host "
                                 f"{h}, not explained by float32 rounding "
                                 f"at a split threshold")
    log(f"{label}: host path names {host_names}")


def host_scores(model, x: np.ndarray) -> np.ndarray:
    """The class scores whose argmax is the host route's selection, from
    scaled float64 features ``x``."""
    import torch

    if hasattr(model, "forward_device"):
        return model.forward_device(
            torch.from_numpy(np.asarray(x, np.float32))).numpy()
    if hasattr(model, "_joint_log_likelihood"):  # naive Bayes
        return model._joint_log_likelihood(x)
    return model.predict_proba(x)


def margins(scores: np.ndarray) -> np.ndarray:
    """Top class score minus the second, over the row's largest |score|."""
    top = np.sort(scores, axis=1)
    scale = np.maximum(np.abs(scores).max(axis=1), 1e-30)
    return (top[:, -1] - top[:, -2]) / scale


def family_select(name: str, engine, mats, host_feats, dev) -> None:
    """``select_batch`` of one family on the served batch: the csr_stats
    kernels launched, names equal to the host path's unless the host
    route's top two scores lie within float32 rounding."""
    from repro_torch.core.features import (extract_features_batch_device,
                                           pad_csr_batch)
    from repro_torch.core.scaling import scaler_transform_device
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    names = engine.select_batch(mats)
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.select_batch(mats)
        warm.append(time.perf_counter() - t0)
    launched(f"family {name} select", launch_counts(),
             ("entry_stats", "row_stats"))
    sel = engine.selector
    host_names, _ = sel.select_batch(mats, path="host")
    feats = extract_features_batch_device(pad_csr_batch(mats, bucket=True),
                                          device=dev)
    m_host = margins(host_scores(sel.model, sel.scaler.transform(host_feats)))
    if hasattr(sel.model, "forward_device"):
        z = scaler_transform_device(sel.scaler, feats)
        m_dev = margins(sel.model.forward_device(z).cpu().numpy())
    else:  # the device route classifies the device features on the host
        m_dev = margins(host_scores(sel.model, sel.scaler.transform(
            feats.cpu().numpy())))
    log(f"family {name} select: cold {cold:.4f} s, warm batch s "
        f"{min(warm):.4f} (median {sorted(warm)[2]:.4f}); names {names}")
    for i, (d, h) in enumerate(zip(names, host_names)):
        if d == h:
            continue
        log(f"family {name} select {mats[i].name}: device {d}, host {h}; "
            f"top-two margin host {m_host[i]:.3e}, device {m_dev[i]:.3e}")
        if not m_host[i] <= SCORE_ROUNDING:
            raise AssertionError(f"family {name}, {mats[i].name}: device "
                                 f"selects {d}, host {h}, with a host "
                                 f"margin of {m_host[i]:.3e}")
    log(f"family {name} select: smallest top-two margin host "
        f"{m_host.min():.3e}, device {m_dev.min():.3e}; names equal to the "
        f"host path's: {names == host_names}")


def families_phase(served, solve_mats, dev) -> None:
    """Each family of FAMILIES trained by a ``SolverEngine`` on the tracked
    label set (the gradient-trained ones on the card), served on the
    selection batch, saved and loaded with an equal fingerprint; the MLP
    engine also solves the engine path's batch."""
    import tempfile

    import torch

    from repro_torch.core.features import extract_features_batch
    from repro_torch.core.labeling import LabeledDataset
    from repro_torch.engine import EngineConfig, SolverEngine

    ds = LabeledDataset.load(os.path.join(ROOT, LABELS))
    host_feats = extract_features_batch(served)
    for name in FAMILIES:
        engine = SolverEngine(EngineConfig(model=name, fast_grids=True,
                                           cv=3))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = engine.train(ds)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        model = engine.selector.model
        where = "host"
        if getattr(model, "trains_on_device", False):
            # the fit keeps its trained tensors as their device's copy;
            # training adds only the host's (its held-out predictions)
            where = engine.config.device or "cuda"
            held = sorted({d.type for d in model._dev[1]})
            if where not in held:
                raise AssertionError(f"family {name} trained on {held}")
        log(f"family {name}: train {t_train:.3f} s ({where}) on {LABELS}, "
            f"held-out accuracy {rep['test_accuracy']:.4f} (cv "
            f"{rep['cv_score']:.4f}, {rep['best_params']}), fingerprint "
            f"{engine.fingerprint}")
        family_select(name, engine, served, host_feats, dev)
        with tempfile.TemporaryDirectory() as d:
            again = SolverEngine.load(engine.save(os.path.join(d, "b")))
        if again.fingerprint != engine.fingerprint:
            raise AssertionError(f"family {name}: bundle round trip changed "
                                 f"the fingerprint")
        log(f"family {name}: bundle round trip, fingerprint equal")
        if name == "mlp":
            engine_phase(engine, solve_mats, "family mlp engine")


def table2_phase(served, dev) -> None:
    """A host labeling campaign over all nine registered orderings, then a
    ``SolverEngine`` trained on it that selects on the card and solves."""
    from repro_torch.core.labeling import run_labeling_campaign
    from repro_torch.engine import EngineConfig, SolverEngine
    from repro_torch.sparse.dataset import generate_suite
    from repro_torch.sparse.reorder import REORDERINGS

    algs = list(REORDERINGS)
    mats = list(generate_suite(12, seed=7, size_scale=0.25))
    t0 = time.perf_counter()
    ds = run_labeling_campaign(mats, algorithms=algs)
    dist = {a: int((ds.labels == i).sum()) for i, a in enumerate(algs)}
    log(f"table2: campaign {time.perf_counter() - t0:.3f} s (host) over "
        f"{len(mats)} matrices x {len(algs)} orderings; labels {dist}")
    engine = SolverEngine(EngineConfig(algorithms=algs, fast_grids=True,
                                       cv=3))
    t0 = time.perf_counter()
    rep = engine.train(ds)
    log(f"table2: train {time.perf_counter() - t0:.3f} s, held-out accuracy "
        f"{rep['test_accuracy']:.4f}, fingerprint {engine.fingerprint}")
    select_phase(engine, served, dev, "table2 select")
    engine_phase(engine, list(generate_suite(16, seed=1, size_scale=2)),
                 "table2 engine")


def engine_phase(engine, mats, label: str = "engine") -> dict:
    """``engine.solve_batch`` over one served batch with seeded right-hand
    sides; returns the launch counts of this path."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sparse.dataset import suite_summary

    log(f"{label} batch " + json.dumps(suite_summary(mats)))
    rng = np.random.default_rng(0)
    bs = [rng.standard_normal(a.n) for a in mats]
    engine.builder.reset_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.solve_batch(mats, bs)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = engine.stats()
    plans = engine.plan_batch(mats)  # warm: every plan from the cache
    warm = engine.stats()
    t_plan = sum(p.meta["t_build"] for p in plans)
    t_exec = sum(r["time"] for r in results)
    log(f"{label}: solve_batch {wall:.3f} s = select {st['select_seconds']:.4f}"
        f" s ({st['select_calls']} device batch) + plans {t_plan:.3f} s "
        f"(reorder {sum(p.meta['t_reorder'] for p in plans):.3f}, symbolic "
        f"{sum(p.meta['t_symbolic'] for p in plans):.3f}) + execute_plan "
        f"{t_exec:.3f} s")
    for a, b, r, p in zip(mats, bs, results, plans):
        res = rel_residual(a, r["x"], b)
        sp = r["spans"]
        log(f"{label} {a.name} n={a.n} nnz={a.nnz}: {r['algorithm']}, plan "
            f"{p.meta['t_build']:.4f} s, nnz_L={p.nnz_L}; s: "
            + ", ".join(f"{k} {sp[k]:.4f}" for k in (
                "permute", "factor.schedule", "factor.assemble",
                "factor.device", "solve.setup", "solve.sweep",
                "solve.refine"))
            + f"; residual {res:.3e}, refine iterations "
            f"{r['refine_iterations']}")
        if not (res <= 1e-10 and r["refine_converged"]):
            raise AssertionError(f"{label} {a.name}: residual {res:.3e}, "
                                 f"converged {r['refine_converged']}")
    if not (warm["hits"] - st["hits"] == len(mats)
            and warm["select_calls"] == st["select_calls"]
            and warm["sym_builds"] == st["sym_builds"]):
        raise AssertionError(f"second plan_batch was not all cache hits: "
                             f"{st} then {warm}")
    log(f"{label}: second plan_batch all {len(mats)} cache hits")
    launched(label, counts, SERVED_KERNELS)
    return counts


def _pct(xs, q: float) -> float:
    return float(np.percentile(xs, q)) if len(xs) else float("nan")


def drive_traffic(clients, mats, stream, cfg_t) -> tuple:
    """``stream`` (indices into ``mats``) in bursts of ``cfg_t["burst"]``
    with ``cfg_t["pause_ms"]`` pauses, each burst fanned over ``clients``
    (one thread each); returns ([(outcome, i, plan, spans_ms, client ms)],
    wall seconds)."""
    import threading

    from repro_torch.core.reqctx import DeadlineExceeded, QueueFull
    from repro_torch.launch.rpc import RPCError

    results, res_lock = [], threading.Lock()
    work, work_lock = [], threading.Lock()

    def worker(c):
        while True:
            with work_lock:
                if not work:
                    return
                i = work.pop()
            t0 = time.perf_counter()
            try:
                r = c.plan_detailed(mats[i], deadline_ms=cfg_t["deadline_ms"])
                out = ("ok", r["plan"], r["spans_ms"])
            except DeadlineExceeded:
                out = ("shed", None, {})
            except QueueFull:
                out = ("rejected", None, {})
            except (RPCError, OSError) as exc:
                out = ("error", repr(exc), {})
            with res_lock:
                results.append((out[0], i, out[1], out[2],
                                (time.perf_counter() - t0) * 1e3))

    t_start = time.perf_counter()
    for lo in range(0, len(stream), cfg_t["burst"]):
        with work_lock:
            work.extend(int(i) for i in stream[lo : lo + cfg_t["burst"]])
        ts = [threading.Thread(target=worker, args=(c,), daemon=True)
              for c in clients]
        for th in ts:
            th.start()
        for th in ts:
            th.join(600)
            if th.is_alive():
                raise AssertionError("serving: a client thread hung")
        if lo + cfg_t["burst"] < len(stream):
            time.sleep(cfg_t["pause_ms"] / 1e3)
    return results, time.perf_counter() - t_start


def serving_phase(engine, mats, dev) -> None:
    """The serving plane on the card: ``engine``'s selector behind
    ``SolverEngine.serve(rpc=True)`` on 127.0.0.1, a fresh two-tier plan
    cache in a temporary directory, and the SERVING traffic over ``mats``
    (cold) from four client threads; every answered plan must equal
    ``engine.plan``'s (``engine`` planned ``mats`` in the engine path) and
    its algorithm ``engine.select``'s unless float32 rounding at a split
    threshold explains the difference. Then one cold request with a 1 ms
    deadline must come back as ``DeadlineExceeded``; an engine loaded from
    the saved bundle over the same disk tier must serve every structure
    from disk with no plan built and no ``entry_stats`` launch; and one
    ``solve(ctx=...)`` under a generous deadline must reach the fp64
    residual gate."""
    import tempfile

    from repro_torch.core.features import (extract_features_batch,
                                           extract_features_batch_device,
                                           pad_csr_batch)
    from repro_torch.core.reqctx import DeadlineExceeded, RequestContext
    from repro_torch.core.scaling import scaler_transform_device
    from repro_torch.engine import EngineConfig, SolverEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.rpc import PlanRPCClient
    from repro_torch.sparse.dataset import grid2d

    cfg_t = SERVING
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    # the engine path's plans (warm in its cache) and the host selection
    want = [engine.plan(a) for a in mats]
    host = [engine.select(a)[0] for a in mats]
    sel = engine.selector
    feats = extract_features_batch_device(pad_csr_batch(mats, bucket=True),
                                          device=dev)
    x_dev = scaler_transform_device(sel.scaler, feats).cpu().numpy()
    x_host = sel.scaler.transform(extract_features_batch(mats))
    rel = (np.abs(feats.cpu().numpy().astype(np.float64)
                  - extract_features_batch(mats))
           / np.maximum(np.abs(extract_features_batch(mats)), 1e-30))

    def check_plan(i, got, where):
        w = want[i]
        if got.algorithm != w.algorithm or not np.array_equal(got.perm,
                                                              w.perm):
            raise AssertionError(f"serving {where} {mats[i].name}: plan "
                                 f"{got.algorithm} differs from "
                                 f"engine.plan's {w.algorithm}")
        if got.algorithm != host[i]:
            splits = route_splits(sel.model, x_host[i], x_dev[i])
            f32 = all(rel[i, f] <= F32_ROUNDING for _, f, _, _, _ in splits)
            if not (splits and f32):
                raise AssertionError(f"serving {where} {mats[i].name}: "
                                     f"{got.algorithm} against engine."
                                     f"select's {host[i]}, not explained "
                                     f"by float32 rounding")
            return 1
        return 0

    rng = np.random.default_rng(cfg_t["seed"])
    pop = 1.0 / np.power(1.0 + np.arange(len(mats)), cfg_t["zipf_alpha"])
    stream = rng.choice(len(mats), size=cfg_t["requests"], p=pop / pop.sum())
    tmp = tempfile.TemporaryDirectory()
    cfg = EngineConfig(cache_dir=os.path.join(tmp.name, "plan_cache"),
                       batch_size=cfg_t["batch"],
                       max_wait_ms=cfg_t["max_wait_ms"],
                       max_queue=cfg_t["max_queue"],
                       build_workers=cfg_t["build_workers"])
    served = SolverEngine(cfg, selector=sel)
    bundle = served.save(os.path.join(tmp.name, "selector.bundle"))
    results = []
    srv = None
    clients = []
    try:
        reset_launch_counts()
        srv = served.serve(rpc=True, host="127.0.0.1", port=0)
        clients = [PlanRPCClient("127.0.0.1", srv.port, timeout=300)
                   for _ in range(cfg_t["clients"])]
        results, wall = drive_traffic(clients, mats, stream, cfg_t)
        traffic = launch_counts()
        stats = srv.dispatcher.stats()
        snap = served.metrics.snapshot()

        outcome = {k: sum(r[0] == k for r in results)
                   for k in ("ok", "shed", "rejected", "error")}
        if outcome["ok"] != len(stream) or len(results) != len(stream):
            bad = [r for r in results if r[0] != "ok"][:5]
            raise AssertionError(f"serving: {outcome} of {len(stream)} "
                                 f"requests; first failures {bad}")
        rounding = len({r[1] for r in results
                        if check_plan(r[1], r[2], "rpc")})
        # the structures the stream never asked for, so the disk tier holds
        # all of them, over one plan_batch call (the others warm)
        with PlanRPCClient("127.0.0.1", srv.port, timeout=300) as c:
            all_plans = c.plan_batch(mats, deadline_ms=cfg_t["deadline_ms"])
            for i, p in enumerate(all_plans):
                check_plan(i, p, "plan_batch")
            cold = grid2d(96, 96, "serving_shed_96")
            try:
                c.plan(cold, deadline_ms=1.0)
                raise AssertionError("serving: a cold request with a 1 ms "
                                     "deadline was answered")
            except DeadlineExceeded as exc:
                log(f"serving: cold request with a 1 ms deadline shed: "
                    f"{exc}")
        shed_after = srv.dispatcher.stats()["shed"]
        if shed_after != stats["shed"] + 1:
            raise AssertionError(f"serving: shed {stats['shed']} then "
                                 f"{shed_after} after the 1 ms request")
    finally:
        for c in clients:
            c.close()
        if srv is not None:
            srv.close(timeout=60)

    cl = [r[4] for r in results]
    spans = {}
    for r in results:
        for k, v in r[3].items():
            spans.setdefault(k, []).append(v)
    log(f"serving rpc: {len(stream)} requests over {len(set(stream))} "
        f"structures in {wall:.3f} s = {len(stream) / wall:.3f} requests/s; "
        f"client ms p50 {_pct(cl, 50):.3f} p99 {_pct(cl, 99):.3f}; "
        f"outcomes {outcome}; shed {stats['shed']}, rejected "
        f"{stats['rejected']}, errors {stats['errors']}; {smi}")
    log("serving rpc per-stage ms (p50, p99, requests): " + json.dumps({
        k: [round(_pct(v, 50), 4), round(_pct(v, 99), 4), len(v)]
        for k, v in sorted(spans.items())}))
    log("serving rpc dispatcher stage ms: " + json.dumps({
        k: round(stats[k], 4) for k in sorted(stats)
        if k.startswith("stage_") or k in ("p50_ms", "p99_ms")}))
    n_get = stats["hits"] + stats["misses"]
    log(f"serving rpc cache: hit rate {stats['hit_rate']:.4f} of {n_get} "
        f"lookups (memory tier {stats['memory_hits'] / n_get:.4f}, disk tier "
        f"{stats['disk_hits'] / n_get:.4f}, misses {stats['misses']}); "
        f"{stats['plans_built']} plans built, "
        f"{stats['select_calls']} device selections "
        f"({snap['infer.matrices']} matrices), disk {stats['disk_writes']} "
        f"writes / {stats['disk_entries']} entries / {stats['disk_bytes']} "
        f"bytes; entry_stats {traffic['entry_stats']} and row_stats "
        f"{traffic['row_stats']} launches; {rounding} structures where the "
        f"host selection differs by float32 rounding; {smi}")
    launched("serving", traffic, ("entry_stats", "row_stats"))
    if stats["errors"] or stats["rejected"] or stats["shed"]:
        raise AssertionError(f"serving: {stats}")

    # restart: a new engine from the saved bundle over the same disk tier
    again = SolverEngine.load(bundle, cfg)
    if again.cache_version != served.cache_version:
        raise AssertionError("serving: the reloaded engine's cache version "
                             "differs")
    srv2 = again.serve()
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        plans = srv2.handle(mats, timeout=300)
        t_disk = time.perf_counter() - t0
        disk_counts = launch_counts()
        st2 = srv2.stats()
    finally:
        srv2.close(timeout=60)
    for i, p in enumerate(plans):
        check_plan(i, p, "restart")
    log(f"serving restart: {len(mats)} structures in process in "
        f"{t_disk:.4f} s, disk tier hit rate "
        f"{st2['disk_hits'] / max(1, st2['hits'] + st2['misses']):.4f} "
        f"({st2['disk_hits']} hits), plans built "
        f"{st2['plans_built']}, device selections {st2['select_calls']}, "
        f"entry_stats {disk_counts['entry_stats']} and row_stats "
        f"{disk_counts['row_stats']} launches; {smi}")
    if not (st2["disk_hits"] == len(mats) and st2["plans_built"] == 0
            and disk_counts["entry_stats"] == 0
            and st2["warm_hits"] == len(mats)):
        raise AssertionError(f"serving restart was not served from disk: "
                             f"{st2}, launches {disk_counts}")

    a = mats[int(stream[0])]
    b = np.random.default_rng(3).standard_normal(a.n)
    ctx = RequestContext.mint(deadline_ms=cfg_t["deadline_ms"])
    r = again.solve(a, b, ctx=ctx)
    gate(f"serving solve(ctx) {a.name} {r['algorithm']}", a, r, b)
    log("serving solve(ctx) spans ms: " + json.dumps(
        {k: round(v, 4) for k, v in ctx.spans_ms().items()}))
    tmp.cleanup()


def serving_mesh_phase(engine, served, dev, out: dict,
                       headline: bool) -> dict:
    """The selector's serving mesh on the card. The served batch, cut to
    each of MESH_SIZES, featurized over a mesh of every card and over
    cuda:0 listed MESH_REPEAT times: the features the bits of the one-device
    run, one ``entry_stats`` and one ``row_stats`` launch a shard, each
    shard's kernel outputs held against the plain versions on its own
    arguments (those launches not counted), and the selected names equal
    to the one-device mesh's. Then ``SolverEngine(EngineConfig(
    serving_devices=<every card>))`` behind ``serve(rpc=True)`` under
    SERVING's traffic over MESH_SUITE (cold): every request answered, each
    plan's algorithm the one-device selection's, with requests/s, p99 and
    the per-shard counters. Returns that run's launch counts."""
    import torch

    from repro_torch.core.features import (csr_stats_shard_args,
                                           extract_features_batch_device,
                                           pad_csr_batch)
    from repro_torch.distributed import meshctx
    from repro_torch.engine import EngineConfig, SolverEngine
    from repro_torch.kernels import csr_stats as cs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.rpc import PlanRPCClient
    from repro_torch.sparse.dataset import generate_suite

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    one = meshctx.make_serving_mesh(1, dev)
    meshes = {f"{n_cards} card(s)": meshctx.make_serving_mesh(n_cards, dev),
              f"cuda:0 x{MESH_REPEAT}": meshctx.ServingMesh(
                  (torch.device("cuda", 0),) * MESH_REPEAT)}
    sel = engine.selector
    for b in MESH_SIZES:
        batch = pad_csr_batch(served[:b], bucket=True)
        want = extract_features_batch_device(batch, device=dev, mesh=one)
        with meshctx.serving_mesh(one):
            want_names, _ = sel.select_batch(served[:b], path="device",
                                             device=dev)
        for tag, sm in meshes.items():
            reset_launch_counts()
            t0 = time.perf_counter()
            got = extract_features_batch_device(batch, device=dev, mesh=sm)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = launch_counts()
            nd = sm.num_devices
            if not (counts["entry_stats"] == counts["row_stats"] == nd):
                raise AssertionError(f"serving_mesh {tag} B={b}: launches "
                                     f"{counts}, want {nd} of each")
            if not (got.device == sm.devices[0] and torch.equal(got, want)):
                raise AssertionError(f"serving_mesh {tag} B={b}: features "
                                     f"are not the one-device run's bits")
            errs = []
            for i, (ea, ra) in enumerate(csr_stats_shard_args(batch, sm)):
                for name, args, plain, exact in (
                        ("entry_stats", ea, cs.entry_stats_plain, [0]),
                        ("row_stats", ra, cs.row_stats_plain, [0, 1])):
                    errs.append(hold_stats(name, f"{tag} shard {i}",
                                           getattr(cs, name)(*args),
                                           plain(*args), exact)[0])
            with meshctx.serving_mesh(sm):
                names, t_sel = sel.select_batch(served[:b], path="device",
                                                device=dev)
            if names != want_names:
                raise AssertionError(f"serving_mesh {tag} B={b}: names "
                                     f"{names}, one device {want_names}")
            log(f"serving_mesh {tag} B={b}: {nd} shards, features equal to "
                f"one device's bits, launches {counts}, shard kernels vs "
                f"plain max abs err {max(errs):.3e}; featurize {dt:.4f} s, "
                f"select_batch {t_sel:.4f} s")
    # the shapes the shards of the full batch give the kernels, timed (the
    # headline of --serve-mesh)
    sm = meshes[f"cuda:0 x{MESH_REPEAT}"]
    ea, ra = csr_stats_shard_args(pad_csr_batch(served, bucket=True), sm)[0]
    B, E, N = ea[0].shape[0], ea[0].shape[1], ra[0].shape[1]
    for name, args, plain, exact, ops in (
            ("entry_stats", ea, cs.entry_stats_plain, [0], 4 * B * E),
            ("row_stats", ra, cs.row_stats_plain, [0, 1], 5 * B * N)):
        kern = getattr(cs, name)
        err, rel = hold_stats(name, "mesh shard", kern(*args), plain(*args),
                              exact)
        nbytes = sum(a.numel() * a.element_size() for a in args) \
            + B * (2 if name == "entry_stats" else 3) * 4
        record(out, name, f"a shard of {MESH_REPEAT}, B={B} E={E} N={N} "
               f"(max rel err float stats {rel:.3e})", err,
               device_ms(lambda: kern(*args)),
               stream_ms(lambda: plain(*args)), None, ops, nbytes,
               PEAK_FP32, headline)

    # the engine over a mesh of every card, behind RPC, cold
    cfg_t = SERVING
    mats = list(generate_suite(**MESH_SUITE))
    with meshctx.serving_mesh(one):
        want_names, _ = sel.select_batch(mats, path="device", device=dev)
    rng = np.random.default_rng(cfg_t["seed"])
    pop = 1.0 / np.power(1.0 + np.arange(len(mats)), cfg_t["zipf_alpha"])
    stream = rng.choice(len(mats), size=cfg_t["requests"], p=pop / pop.sum())
    eng = SolverEngine(EngineConfig(
        serving_devices=n_cards, batch_size=cfg_t["batch"],
        max_wait_ms=cfg_t["max_wait_ms"], max_queue=cfg_t["max_queue"],
        build_workers=cfg_t["build_workers"]), selector=sel)
    srv, clients = None, []
    try:
        srv = eng.serve(rpc=True, host="127.0.0.1", port=0)
        clients = [PlanRPCClient("127.0.0.1", srv.port, timeout=300)
                   for _ in range(cfg_t["clients"])]
        reset_launch_counts()
        results, wall = drive_traffic(clients, mats, stream, cfg_t)
        counts = launch_counts()
        stats = srv.dispatcher.stats()
        snap = eng.metrics.snapshot()
    finally:
        for c in clients:
            c.close()
        if srv is not None:
            srv.close(timeout=60)
        meshctx.set_serving_mesh(None)
    bad = [r for r in results if r[0] != "ok"]
    if bad or len(results) != len(stream):
        raise AssertionError(f"serving_mesh rpc: {len(bad)} of {len(stream)} "
                             f"requests failed, first {bad[:3]}")
    wrong = [mats[r[1]].name for r in results
             if r[2].algorithm != want_names[r[1]]]
    if wrong:
        raise AssertionError(f"serving_mesh rpc: plans for {sorted(set(wrong))}"
                             f" differ from the one-device selection")
    launched("serving_mesh rpc", counts, ("entry_stats", "row_stats"))
    cl = [r[4] for r in results]
    shards = {f"shard{i}": [snap.get(f"mesh.shard{i}.requests", 0),
                            snap.get(f"mesh.shard{i}.pad_rows", 0)]
              for i in range(int(snap.get("mesh.shards", 0)))}
    log(f"serving_mesh rpc over {n_cards} card(s): {len(stream)} requests "
        f"over {len(set(stream))} structures in {wall:.3f} s = "
        f"{len(stream) / wall:.3f} requests/s; client ms p50 "
        f"{_pct(cl, 50):.3f} p99 {_pct(cl, 99):.3f}; {stats['select_calls']}"
        f" device selections, {stats['plans_built']} plans built; "
        f"per-shard [requests, pad rows] {json.dumps(shards)}; launches "
        f"{counts}")
    if int(snap.get("mesh.shards", 0)) != n_cards:
        raise AssertionError(f"serving_mesh rpc: mesh.shards "
                             f"{snap.get('mesh.shards')}, want {n_cards}")
    PHASE_S["serving_mesh"] = time.perf_counter() - t_phase
    return counts


def lifecycle_holds(dev) -> dict:
    """The solve kernels at the tuner's knobs, each against its plain
    version (tolerances of ``TOL``), on grid3d(20,20,20)/nd factored by the
    pipelined path under both pad policies: ``frontal_factor_batch`` at one
    bucket of every pivot width of the ``pow2`` schedule and of every width
    the ``mult8`` schedule adds (``width_cases``), at the panel
    ``pick_block_size`` gives for every ``bs`` of the grid (64 → 32);
    ``extend_add_batch`` at those buckets that are fed, launched as the
    path launches it; ``tri_solve_batch``, both sweeps, at k = 4 at every
    (``sweep_bs``, ``rt``) of the sweep grid. Returns each kernel's largest
    error. These launches are not counted for the path."""
    import torch

    from repro_torch.autotune import solve_tuner as st
    from repro_torch.core.plan import PlanBuilder
    from repro_torch.kernels import frontal_cholesky as fc
    from repro_torch.kernels import ops
    from repro_torch.sparse.csr import permute_symmetric
    from repro_torch.sparse.dataset import grid3d
    from repro_torch.sparse.multifrontal import (_route_contributions,
                                                 multifrontal_cholesky)

    a = grid3d(20, 20, 20, "grid3d_20")
    plan = PlanBuilder().build(a, "nd")
    pa = permute_symmetric(a, plan.perm)
    rng = np.random.default_rng(5)
    errs = dict(frontal_factor_batch=0.0, extend_add_batch=0.0,
                tri_solve_batch=0.0)
    seen_widths: set = set()
    for pad in ("pow2", "mult8"):
        f = multifrontal_cholesky(pa, sym=plan.sym, pad=pad, device=dev)
        sched = f.schedule
        routes = _route_contributions(sched)
        for _, key in width_cases(sched, pick_buckets(sched, routes)):
            P = sched.buckets[key[0]][key[1]].P
            if P in seen_widths:
                continue
            seen_widths.add(P)
            bk, w0, groups = bucket_inputs(pa, f, routes, key, dev)
            ea = "-"
            if key in routes:
                wk, wp = w0.clone(), w0.clone()
                extend_add_as_path(f, routes, key, dev)(wk)
                for u, off, src, dst, rows in groups:
                    fc.extend_add_batch_plain(wp, u, dst, rows, src, off)
                err = compare("extend_add_batch", wk, wp)
                errs["extend_add_batch"] = max(errs["extend_add_batch"], err)
                ea = f"{err:.3e}"
                w0 = wk
            ff = []
            for bs in st.DEFAULT_BS_GRID:
                panel = ops.pick_block_size(P, bs)
                wk, wp = w0.clone(), w0.clone()
                fc.frontal_factor_batch(wk, P, bs=panel)
                fc.frontal_factor_batch_plain(wp, P, panel)
                err = compare("frontal_factor_batch", torch.tril(wk),
                              torch.tril(wp))
                errs["frontal_factor_batch"] = max(
                    errs["frontal_factor_batch"], err)
                ff.append(f"bs {bs}→{panel} {err:.3e}")
            L = f.device_stacks[key][:, :P, :P]
            x0 = torch.as_tensor(rng.standard_normal((len(bk.members), P, 4)),
                                 dtype=torch.float32, device=dev)
            ts = []
            for sbs in st.DEFAULT_SWEEP_BS_GRID:
                for rt in st.DEFAULT_RT_GRID:
                    panel = ops.pick_block_size(P, sbs)
                    kt = ops._kernel_tile(4, rt)
                    for lower in (True, False):
                        xk, xp = x0.clone(), x0.clone()
                        fc.tri_solve_batch(L, xk, bs=panel, kt=kt,
                                           lower=lower)
                        fc.tri_solve_batch_plain(L, xp, panel, lower)
                        err = compare("tri_solve_batch", xk, xp)
                        errs["tri_solve_batch"] = max(
                            errs["tri_solve_batch"], err)
                        ts.append(err)
            log(f"lifecycle hold {pad} B={len(bk.members)} P={P} M={bk.M}: "
                f"extend_add {ea}; frontal_factor_batch "
                + ", ".join(ff) + f"; tri_solve_batch k=4 at "
                f"{len(ts)} (sweep_bs, rt, sweep) max_abs_err {max(ts):.3e}")
    return errs


def lifecycle_phase(engine, mats, dev) -> dict:
    """The solve tuner and the bundle lifecycle on the card.

    * **tuner**: ``tune(device=cuda)`` over the reference's default suite
      and grids into a temporary directory, a line per candidate; then the
      kernels at every knob of the grids (``lifecycle_holds``, not counted).
    * **tuned engine**: ``EngineConfig(autotune_solve=True)`` on a fresh
      directory tunes once and solves grid3d(20,20,20)/nd and two matrices
      of ``mats`` at the residual gate, with ``plan.meta`` carrying the
      policy; a second engine on the directory loads it (``cached``) and
      launches nothing.
    * **campaign**: ``run_campaign`` of ``generate_suite(6, seed=7,
      size_scale=0.25)`` × the four labels with ``backend="pipelined"`` on
      the card, cut at half its cells, resumed (the other half labeled,
      the first skipped), assembled into a dataset that trains a candidate.
    * **shadow → promote → rollback**: ``engine``'s bundle served behind
      ``serve()`` with a disk tier, 48 Zipf requests over ``mats`` while
      the candidate shadows; a gate the candidate fails (``GateRejected``,
      nothing changed), then the configured one it passes; the cache
      version moves, a plan under the candidate is built anew, and after
      ``rollback()`` the incumbent's plan comes back from disk with no
      plan built. The shadow's ``errors`` must be 0.

    Returns the holds' largest error of each kernel."""
    import tempfile

    import torch

    from repro_torch.autotune import solve_tuner as st
    from repro_torch.engine import EngineConfig, SolverEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.lifecycle import (CampaignConfig, GateRejected,
                                       PromotionGate, assemble_dataset,
                                       run_campaign)
    from repro_torch.sparse.dataset import generate_suite, grid3d

    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    errs = lifecycle_holds(dev)
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    reset_launch_counts()

    # -- the tuner ------------------------------------------------------------
    def on_candidate(stage, key, seconds):
        what = ("pad {}, bs {}" if stage == "factor"
                else "sweep_bs {}, rt {}").format(*key)
        log(f"lifecycle tune {stage} candidate ({what}): summed best warm "
            f"{seconds:.5f} s")

    t0 = time.perf_counter()
    pol = st.tune(device=dev, out_dir=os.path.join(root, "tune"),
                  on_candidate=on_candidate)
    log(f"lifecycle tune: {time.perf_counter() - t0:.3f} s, winner "
        + json.dumps(pol.to_json()) + f"; {smi}")

    # -- an engine that tunes, then one that loads ------------------------------
    cfg = EngineConfig(fast_grids=True, cv=3, autotune_solve=True,
                       autotune_dir=os.path.join(root, "autotune"))
    tuned = SolverEngine(cfg, selector=engine.selector)
    t0 = time.perf_counter()
    tp = tuned.solve_policy
    log(f"lifecycle tuned engine: policy {tp.source} in "
        f"{time.perf_counter() - t0:.3f} s: " + json.dumps(tp.to_json()))
    if tp.source != "tuned" or tp.device_kind != torch.cuda.get_device_name(
            0):
        raise AssertionError(f"lifecycle: the engine's policy {tp}")
    rng = np.random.default_rng(4)
    for a in [grid3d(20, 20, 20, "grid3d_20")] + list(mats[:2]):
        b = rng.standard_normal(a.n)
        r = tuned.solve(a, b)
        meta = tuned.plan(a).meta
        gate(f"lifecycle tuned solve {a.name} {r['algorithm']} (pad "
             f"{meta['solve_pad']}, bs {meta['solve_bs']})", a, r, b)
        if (meta["solve_bs"], meta["solve_pad"], r["rt"]) != (
                tp.bs, tp.pad, tp.rt):
            raise AssertionError(f"lifecycle: plan.meta {meta} does not "
                                 f"carry the policy {tp}")
    before = launch_counts()
    t0 = time.perf_counter()
    again = SolverEngine(cfg, selector=engine.selector).solve_policy
    t_load = time.perf_counter() - t0
    if again.source != "cached" or launch_counts() != before or \
            (again.bs, again.pad, again.sweep_bs, again.rt) != (
                tp.bs, tp.pad, tp.sweep_bs, tp.rt):
        raise AssertionError(f"lifecycle: a second engine measured or "
                             f"missed: {again}")
    log(f"lifecycle second engine: policy {again.source} in {t_load:.5f} "
        f"s, no launch")

    # -- a labeling campaign on the card ---------------------------------------
    suite = list(generate_suite(6, seed=7, size_scale=0.25))
    ccfg = dict(campaign_id="card", labels_dir=os.path.join(root, "labels"),
                backend="pipelined", device="cuda")
    total = len(suite) * 4
    r1 = run_campaign(suite, CampaignConfig(max_cells=total // 2,
                                            **ccfg)).report
    r2 = run_campaign(suite, CampaignConfig(**ccfg)).report
    for tag, r in (("cut", r1), ("resumed", r2)):
        log(f"lifecycle campaign {tag}: " + json.dumps({k: r[k] for k in (
            "workers", "backend", "cells_total", "cells_labeled",
            "cells_skipped", "cells_incomplete", "wall_s", "cells_per_s",
            "per_algorithm_wins", "label_time_breakdown", "complete")}))
    if not (r1["cells_labeled"] == total // 2 and not r1["complete"]
            and r2["cells_skipped"] == total // 2
            and r2["cells_labeled"] == total - total // 2
            and r2["complete"]):
        raise AssertionError(f"lifecycle campaign: cut {r1}, resumed {r2}")
    ds = assemble_dataset(suite, CampaignConfig(**ccfg))
    cand = SolverEngine(EngineConfig(model="decision_tree", fast_grids=True,
                                     cv=2, test_size=0.5))
    rep = cand.train(ds)
    cand_path = cand.save(os.path.join(root, "candidate.bundle"))
    log(f"lifecycle candidate: decision_tree on {len(ds.names)} matrices, "
        f"labels {np.bincount(ds.labels, minlength=4).tolist()}, held-out "
        f"accuracy {rep['test_accuracy']:.4f}, fingerprint "
        f"{cand.fingerprint}")

    # -- shadow → promote → rollback behind serve() ----------------------------
    inc_path = engine.save(os.path.join(root, "incumbent.bundle"))
    icfg = EngineConfig(cache_dir=os.path.join(root, "plan_cache"),
                        bundle_dir=os.path.join(root, "bundles"),
                        promote_min_accuracy=0.0,
                        promote_min_shadow_requests=1,
                        promote_min_win_rate=0.0,
                        batch_size=SERVING["batch"],
                        max_wait_ms=SERVING["max_wait_ms"],
                        build_workers=SERVING["build_workers"])
    inc = SolverEngine.load(inc_path, icfg)
    fp0, cv0 = inc.fingerprint, inc.cache_version
    shadow = inc.start_shadow(cand_path)
    pop = 1.0 / np.power(1.0 + np.arange(len(mats)), SERVING["zipf_alpha"])
    stream = np.random.default_rng(SERVING["seed"]).choice(
        len(mats), size=48, p=pop / pop.sum())
    srv = inc.serve()
    try:
        t0 = time.perf_counter()
        futs = [srv.submit(mats[int(i)]) for i in stream]
        plans = [f.result(300) for f in futs]
        t_serve = time.perf_counter() - t0
    finally:
        srv.close(timeout=120)
    t0 = time.perf_counter()
    if not shadow.drain(300):
        raise AssertionError("lifecycle: the shadow did not drain")
    t_drain = time.perf_counter() - t0
    stats = shadow.stats()
    snap = inc.metrics.snapshot()
    log(f"lifecycle shadow: 48 requests ({len(set(stream.tolist()))} "
        f"structures) served in {t_serve:.3f} s, then drained in "
        f"{t_drain:.3f} s; " + json.dumps(stats) + "; per evaluation s: "
        + json.dumps({k: snap[f"shadow.eval_s.{k}"]
                      for k in ("count", "p50", "p99", "mean")}))
    # the dispatcher mirrors every warm hit and each cold selection once
    # (a request that joins a build in flight is not mirrored again)
    if not (len(set(stream.tolist())) <= stats["requests"] <= len(stream)
            and stats["evaluated"] == stats["requests"]
            and stats["dropped"] == 0 and stats["errors"] == 0):
        raise AssertionError(f"lifecycle shadow: {stats}")

    try:
        inc.promote(gate=PromotionGate(0.0, 1, 1.01))
        raise AssertionError("lifecycle: a win rate of 1.01 passed the gate")
    except GateRejected as e:
        failed = [c["check"] for c in e.decision["checks"]
                  if not c["passed"]]
        log(f"lifecycle promote, failing gate: GateRejected on {failed}")
    if inc.fingerprint != fp0 or len(inc.registry) != 0:
        raise AssertionError("lifecycle: a rejected promote changed state")
    t0 = time.perf_counter()
    decision = inc.promote()
    t_promote = time.perf_counter() - t0
    cv1 = inc.cache_version
    log(f"lifecycle promote: {t_promote:.4f} s, decision "
        + json.dumps(decision, default=str))
    a = mats[int(stream[0])]
    inc.plan(a)
    built = inc.builder.plans_built
    t0 = time.perf_counter()
    entry = inc.rollback()
    t_rollback = time.perf_counter() - t0
    inc.plan(a)
    log(f"lifecycle rollback: {t_rollback:.4f} s to {entry['version']}; "
        f"cache version {cv0} → {cv1} → {inc.cache_version}; {a.name} "
        f"built {built} plan under the candidate, "
        f"{inc.builder.plans_built} after rollback "
        f"(disk hits {inc.builder.stats().get('disk_hits')}); {smi}")
    if not (cv1 != cv0 and cv1 == cand.cache_version and built == 1
            and inc.cache_version == cv0 and inc.fingerprint == fp0
            and inc.builder.plans_built == 0
            and inc.registry.serving_version() == entry["version"]):
        raise AssertionError("lifecycle: promote/rollback did not swap the "
                             "cache versions and plans")
    if inc.shadow is not None or shadow.stats()["errors"]:
        raise AssertionError(f"lifecycle: shadow {shadow.stats()}")
    counts = launch_counts()
    tmp.cleanup()
    PHASE_S["lifecycle"] = time.perf_counter() - t_phase
    log(f"lifecycle: {PHASE_S['lifecycle']:.1f} s")
    launched("lifecycle", counts, SERVED_KERNELS)
    return errs


def gate(label: str, a, r, b) -> None:
    """Raise unless the solve reached the fp64 residual gate (and, where it
    refined, converged)."""
    res = rel_residual(a, r["x"], b)
    sp = r["spans"]
    log(f"{label}: residual {res:.3e}, refine iterations "
        f"{r['refine_iterations']}; s: total {r['time']:.4f}, "
        + ", ".join(f"{k} {v:.4f}" for k, v in sp.items()))
    if not (res <= 1e-10 and r["refine_converged"] in (True, None)):
        raise AssertionError(f"{label}: residual {res:.3e}, converged "
                             f"{r['refine_converged']}")


def per_front_phase(plans, engine, dev) -> dict:
    """The per-front ``pallas`` backend on the 32³ ``nd`` plan, the other
    backends on the 20³ ``nd`` plan, and an engine configured for
    ``pallas``; returns the launch counts of the per-front 32³ solve."""
    from repro_torch.core.plan import execute_plan
    from repro_torch.engine import EngineConfig, SolverEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sparse.dataset import generate_suite, suite_summary

    from repro_torch.sparse.csr import permute_symmetric
    from repro_torch.sparse.multifrontal import multifrontal_cholesky

    rng = np.random.default_rng(3)
    a, plan = plans[-1]
    b = rng.standard_normal(a.n)
    # where the per-front factorization's time goes: host assembly, uploads
    # and launches, and the blocking copies back of each front
    mf = multifrontal_cholesky(permute_symmetric(a, plan.perm), sym=plan.sym,
                               backend="pallas", device=dev)
    st = mf.stats
    log(f"per_front factor {a.name} {plan.algorithm}: {st['nsup']} fronts; "
        f"s: schedule {st['t_factor_schedule']:.4f}, assemble "
        f"{st['t_factor_assemble']:.4f}, dispatch {st['t_factor_dispatch']:.4f}"
        f", sync {st['t_factor_sync']:.4f}")
    reset_launch_counts()
    r = execute_plan(a, plan, b, backend="pallas", sweep="device",
                     solve_dtype="fp32_refine", device=dev)
    counts = launch_counts()
    gate(f"per_front {a.name} {plan.algorithm} pallas/device", a, r, b)
    if not r["refine_converged"]:
        raise AssertionError("per_front: refinement did not converge")
    launched("per_front", counts, TILE_KERNELS)
    shapes = per_front_products(mf.schedule)
    log(f"per_front matmul_nt: {sum(shapes.values())} launches over "
        f"{len(shapes)} distinct (rows, N, K) by the schedule, "
        f"{counts['matmul_nt']} counted")
    if min(counts[k] for k in TILE_KERNELS) < 2:
        raise AssertionError(f"per_front: a tile kernel launched once only: "
                             f"{counts}")

    a20, p20 = next((a_, p_) for a_, p_ in plans
                    if a_.name == "grid3d_20" and p_.algorithm == "nd")
    b20 = rng.standard_normal(a20.n)
    reset_launch_counts()
    for backend, sweep in (("batched", "level"), ("numpy", "device")):
        r = execute_plan(a20, p20, b20, backend=backend, sweep=sweep,
                         solve_dtype="fp32_refine", device=dev)
        gate(f"per_front {a20.name} nd {backend}/{sweep}", a20, r, b20)
    launched("per_front other backends", launch_counts(),
             ("frontal_factor_batch", "tri_solve_batch", "bell_spmv"))

    mats = list(generate_suite(4, seed=2, size_scale=4))
    log("per_front engine batch " + json.dumps(suite_summary(mats)))
    eng = SolverEngine(EngineConfig(backend="pallas"),
                       selector=engine.selector)
    bs = [rng.standard_normal(m.n) for m in mats]
    reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.solve_batch(mats, bs)
    log(f"per_front engine: solve_batch {time.perf_counter() - t0:.3f} s")
    for m, b_, r in zip(mats, bs, results):
        gate(f"per_front engine {m.name} {r['algorithm']} pallas", m, r, b_)
    launched("per_front engine", launch_counts(),
             TILE_KERNELS + ("entry_stats", "row_stats"))
    return counts


def hold_stats(name: str, shape: str, got, want, exact) -> tuple:
    """Raise unless the integer columns ``exact`` of a csr_stats result are
    equal to the plain version's and the others within CSR_STATS_RTOL of
    them per matrix; returns (max abs error, max relative error)."""
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    fl = [c for c in range(got.shape[1]) if c not in exact]
    rel = ((got[:, fl] - want[:, fl]).abs()
           / want[:, fl].abs().clamp(min=1e-30)).max().item()
    if not (torch.equal(got[:, exact], want[:, exact])
            and rel <= CSR_STATS_RTOL):
        raise AssertionError(f"{name} {shape}: integer stats differ or float "
                             f"stats off by {rel:.3e} relative")
    return err, rel


def csr_stats_checks(mats, dev, out: dict) -> None:
    """entry_stats / row_stats against their plain versions on the served
    batch's arguments, as the featurizer builds them, with times and
    bounds; then row_stats on seeded batches and in profiled windows of 20
    calls. Neither has a single PyTorch call computing the same function:
    each statistic is a masked reduction, and no library call masks."""
    from repro_torch.core.features import csr_stats_args, pad_csr_batch
    from repro_torch.kernels import csr_stats as cs

    ea, ra = csr_stats_args(pad_csr_batch(mats, bucket=True), dev)
    B, E = ea[0].shape
    N = ra[0].shape[1]
    for name, args, plain, exact, ops in (
            ("entry_stats", ea, cs.entry_stats_plain, [0], 4 * B * E),
            ("row_stats", ra, cs.row_stats_plain, [0, 1], 5 * B * N)):
        kern = getattr(cs, name)
        err, rel = hold_stats(name, "served", kern(*args), plain(*args),
                              exact)
        ms = device_ms(lambda: kern(*args))
        pms = stream_ms(lambda: plain(*args))
        # each input read once, the (B, 2) or (B, 3) result written once
        nbytes = sum(a.numel() * a.element_size() for a in args) \
            + B * (2 if name == "entry_stats" else 3) * 4
        record(out, name, f"B={B} E={E} N={N} (max rel err float stats "
               f"{rel:.3e})", err, ms, pms, None, ops, nbytes, PEAK_FP32,
               True)
    row_stats_seeded(dev)
    row_stats_profiled(ra)


def row_stats_seeded(dev) -> None:
    """row_stats against its plain version on seeded batches the served one
    never gives: B = 1; N = 2^17 + 3 (every matrix but the first starts off
    a 16-byte boundary); N = 5; a matrix with no valid row."""
    import torch

    from repro_torch.kernels import csr_stats as cs

    rng = np.random.default_rng(9)
    for tag, B, N, empty in (("B=1", 1, 12_288, None),
                             ("N=2^17+3", 4, 2 ** 17 + 3, None),
                             ("N=5", 6, 5, None),
                             ("no valid row", 3, 1027, 1)):
        n = rng.integers(1, N + 1, B)
        if empty is not None:
            n[empty] = 0
        args = [torch.as_tensor(x, device=dev) for x in (
            rng.integers(0, 40, (B, N)).astype(np.int32),
            (np.arange(N)[None, :] < n[:, None]).astype(np.int32),
            (rng.random(B) * 20).astype(np.float32))]
        err, rel = hold_stats("row_stats", tag, cs.row_stats(*args),
                              cs.row_stats_plain(*args), [0, 1])
        ms = device_ms(lambda: cs.row_stats(*args))
        log(f"kernel row_stats seeded {tag} B={B} N={N}: max_abs_err "
            f"{err:.3e}, max rel err float stats {rel:.3e}, ms {ms:.5f}")


def row_stats_profiled(args, calls: int = 20, windows: int = 3) -> None:
    """``calls`` warm row_stats calls in each of ``windows`` profiled
    windows: raise unless the card ran exactly one row_stats kernel for
    each and nothing else. The profiler loses the start of a window (see
    OPEN_SLEEPS), so each window opens on sleep kernels and a sync, closes
    on more, and counts only if the profiler recorded an opening one; the
    line says how many of each side it recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import csr_stats as cs

    def sleeps(n):
        for _ in range(n):
            torch.cuda._sleep(SLEEP_CYCLES)
        torch.cuda.synchronize()

    cs.row_stats(*args)
    torch.cuda.synchronize()
    for w in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sleeps(OPEN_SLEEPS)
            for _ in range(calls):
                cs.row_stats(*args)
            torch.cuda.synchronize()
            sleeps(CLOSE_SLEEPS)
        evs = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
        rows = [x for x in evs if "spin_kernel" not in x[2]]
        first = rows[0][0] if rows else float("inf")
        lead = sum(1 for x in evs if "spin_kernel" in x[2] and x[0] < first)
        trail = len(evs) - len(rows) - lead
        names = [x[2] for x in rows]
        kernels = sorted({n[:80] for n in names})
        us = sum(x[1] - x[0] for x in rows) / max(len(rows), 1)
        log(f"profile row_stats (served batch), window {w}, {calls} calls: "
            f"{len(names)} device events besides the sleep kernels, names "
            f"{kernels}, {us / 1e3:.5f} ms a kernel on the device; the "
            f"profiler recorded {lead} of the {OPEN_SLEEPS} opening and "
            f"{trail} of the {CLOSE_SLEEPS} closing sleep kernels")
        if lead == 0:
            raise AssertionError(f"the profiler lost all {OPEN_SLEEPS} "
                                 f"opening sleep kernels of window {w}, so "
                                 f"its row_stats kernels cannot be counted")
        if len(names) != calls or any("row_stats" not in n for n in names):
            raise AssertionError(f"{calls} row_stats calls ran {len(names)} "
                                 f"device events ({kernels}) in window {w}, "
                                 f"want one row_stats kernel a call")
    log(f"profile row_stats: an empty kernel timed as the kernel lines time "
        f"theirs: {device_ms(lambda: torch.cuda._sleep(0)):.5f} ms")


def hold_attention(tag: str, got, want) -> tuple:
    """Holds a flash_attention output against its plain version's within
    ATTN_TOL; returns (max abs err, ‖Δ‖/‖plain‖, the largest share of its
    elementwise limit that an element uses). Syncs first."""
    import torch

    torch.cuda.synchronize()
    tol = ATTN_TOL[str(want.dtype).split(".")[1]]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err, rnorm = float(diff.max()), float((g - w).norm() / w.norm())
    share = float((diff / (tol["rtol"] * w.abs() + tol["atol"])).max())
    if not (bool(torch.isfinite(got).all()) and share <= 1.0
            and rnorm <= tol["rnorm"]):
        raise AssertionError(
            f"flash_attention {tag}: max abs err {err:.3e}, ‖Δ‖/‖plain‖ "
            f"{rnorm:.3e}, {share:.3f} of the elementwise limit (limits "
            f"{tol})")
    return err, rnorm, share


def attention_checks(dev, out: dict) -> None:
    """flash_attention against its plain version at the served models'
    attention shapes (qwen3-1.7b: B 4, Hq 16, Hkv 8, S 4,096, D 128, bf16,
    causal — the headline; llama3.2-1b: Hq 32, D 64), at a ragged S = 4,097
    without the causal mask, at S = 65 without it (63 of the last key
    tile's 128 slots past the keys) and with a kv_len of 70 of 256 keys,
    where a key mask that failed would move every output, with Hq = Hkv
    (rep 1, the edge of the head mapping), at D = 32 (the mma.sync kernel)
    and in float32, on seeded random inputs, with times; SDPA (on k/v
    repeated to the query heads beforehand) is the library yardstick."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (("qwen3-1.7b", 16, 8, 128, 4096, True, None, bf16),
             ("llama3.2-1b", 32, 8, 64, 4096, True, None, bf16),
             ("qwen3-1.7b ragged", 16, 8, 128, 4097, False, None, bf16),
             ("qwen3-1.7b ragged short", 16, 8, 128, 65, False, None, bf16),
             ("qwen3-1.7b kv_len", 16, 8, 128, 256, False, 70, bf16),
             ("rep 1", 16, 16, 128, 4096, True, None, bf16),
             ("D 32", 16, 8, 32, 4096, True, None, bf16),
             ("qwen3-1.7b f32", 16, 8, 128, 4096, True, None, f32))
    for case in cases:
        attention_case(gen, dev, out, LM_BATCH, *case,
                       headline=case[0] == "qwen3-1.7b")


def attention_case(gen, dev, out: dict, b: int, tag: str, hq: int, hkv: int,
                   d: int, s: int, causal: bool, kv_len, dtype,
                   headline: bool) -> None:
    """flash_attention against its plain version on inputs drawn from
    ``gen`` at one shape, timed beside the plain version and SDPA (on k/v
    repeated to the query heads beforehand); recorded in ``out``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev
                           ).to(dtype) for h in (hq, hkv, hkv))
    kw = dict(causal=causal, kv_len=kv_len)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    err, rnorm, share = hold_attention(tag, got, want)
    kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
    mask = None if kv_len is None else \
        (torch.arange(s, device=dev) < kv_len)[None, None, None, :]
    ms = device_ms(lambda: flash_attention(q, k, v, **kw))
    pms = stream_ms(lambda: flash_attention_plain(q, k, v, **kw))
    lms = device_ms(lambda: F.scaled_dot_product_attention(
        q, kr, vr, attn_mask=mask, is_causal=causal))
    pairs = s * (s + 1) // 2 if causal else s * min(s, kv_len or s)
    flops = 4 * b * hq * d * pairs
    nbytes = q.element_size() * d * b * 2 * (hq * s
                                             + hkv * min(s, kv_len or s))
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    log(f"flash_attention {tag}: ‖Δ‖/‖plain‖ {rnorm:.3e}, "
        f"{share:.3f} of the elementwise limit; bound at the fp32 "
        f"CUDA-core peak {flops / PEAK_FP32 * 1e3:.4f} ms")
    record(out, "flash_attention", f"{tag} B={b} Hq={hq} Hkv={hkv} S={s}"
           f" D={d} {str(dtype).split('.')[1]} causal={causal} kv_len="
           f"{kv_len}", err, ms, pms, lms, flops, nbytes, peak, headline)
    del q, k, v, kr, vr, got, want
    torch.cuda.empty_cache()


def attention_stats_checks(dev) -> None:
    """The forward's training statistics (``flash_attention(...,
    stats=True)``: the rows' log-sum-exp and the output's bf16 remainder)
    against the plain forward's, at the training shapes of llama3.2-1b (B 4,
    Hq 32, Hkv 8, S 4,096, D 64), qwen3-1.7b (Hq 16, D 128) and the
    attention layers of jamba-v0.1-52b and phi3.5-moe (B 1, Hq 32, Hkv 8,
    D 128: a GQA group of 4 at D 128) on seeded inputs, one batch element of the plain version at a time, within
    ATTN_STATS_TOL; the output is the one the call without statistics
    gives, bit for bit, and every stored row is finite."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    gen = torch.Generator(device=dev).manual_seed(6)
    for tag, b, hq, hkv, d in (("llama3.2-1b", TRAIN_BATCH, 32, 8, 64),
                               ("qwen3-1.7b", TRAIN_BATCH, 16, 8, 128),
                               ("jamba/phi3.5-moe", 1, 32, 8, 128)):
        s = TRAIN_SEQ
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev
                               ).bfloat16() for h in (hq, hkv, hkv))
        o, lse, o_lo = flash_attention(q, k, v, causal=True, stats=True)
        same = torch.equal(o, flash_attention(q, k, v, causal=True))
        rows = lse.as_strided((b, hq, lse.stride(1)), lse.stride())
        lse_err = out_err = out_scale = 0.0
        for i in range(b):
            po, plse, plo = flash_attention_plain(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True, stats=True)
            lse_err = max(lse_err, float((lse[i:i + 1] - plse).abs().max()))
            want = po.float() + plo.float()
            out_err = max(out_err, float(
                (o[i:i + 1].float() + o_lo[i:i + 1].float() - want)
                .abs().max()))
            out_scale = max(out_scale, float(want.abs().max()))
            del po, plse, plo, want
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(rows).all())
        log(f"flash_attention stats {tag} B={b} Hq={hq} Hkv={hkv} S={s} "
            f"D={d}: lse max abs err {lse_err:.3e} (limit "
            f"{ATTN_STATS_TOL['lse']}); out + out_lo max abs err "
            f"{out_err:.3e} of the largest {out_scale:.3e} (limit "
            f"{ATTN_STATS_TOL['out']} of it); the output without statistics "
            f"{'the same bits' if same else 'DIFFERS'}; the {rows.shape[2]} "
            f"stored rows a head {'finite' if finite else 'NOT finite'}")
        if not (same and finite and lse_err <= ATTN_STATS_TOL["lse"]
                and out_err <= ATTN_STATS_TOL["out"] * out_scale):
            raise AssertionError(f"flash_attention stats {tag}: failed the "
                                 f"hold above")
        del q, k, v, o, lse, o_lo, rows
        torch.cuda.empty_cache()


def attention_bwd_checks(dev, out: dict) -> None:
    """flash_attention_bwd against the gradients of its plain version
    (``torch.autograd.grad`` through ``flash_attention_plain``) on the same
    seeded inputs, each gradient within ATTN_BWD_RTOL of the plain
    gradient's largest magnitude and the same bits on a second run, at the
    training shapes at B 1: llama3.2-1b (Hq 32, Hkv 8, S 4,096, D 64, bf16,
    causal), qwen3-1.7b (Hq 16, Hkv 8, D 128), jamba-v0.1-52b's and
    phi3.5-moe's attention layers (Hq 32, Hkv 8, D 128), a
    ragged S of 4,097, rep 1, D 32 and 16 (the small head dims of the bf16
    kernels) and float32; with times beside the backward of
    ``scaled_dot_product_attention`` on k/v repeated to the query heads
    beforehand (timed only), and the kernels' registers, shared memory and
    spills first."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels._build import load_kernels
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        uses_stats)

    ops = load_kernels()
    for d in (64, 128):
        i = ops.flash_attention_bwd_sm90_info(d)
        log(f"flash_attention_bwd bf16 wgmma D={d} (the training path's "
            f"design): dQ kernel {i[0]} registers (before setmaxnreg), "
            f"{i[1]} bytes of shared memory, {i[2]} bytes of local memory "
            f"(spills) a thread, {i[3]} ring stages; dK/dV kernel {i[4]} "
            f"registers, {i[5]} bytes of shared memory, {i[6]} bytes "
            f"spilled, {i[7]} ring stages; 384 threads each")
    for d in (16, 32):
        i = ops.flash_attention_bwd_info(d, True)
        log(f"flash_attention_bwd bf16 mma.sync D={d}: dQ kernel {i[0]} "
            f"registers, {i[1]} bytes of shared memory, {i[2]} bytes of "
            f"local memory (spills) a thread, {i[3]} threads; dK/dV kernel "
            f"{i[4]} registers, {i[5]} bytes of shared memory, {i[6]} "
            f"bytes spilled, {i[7]} threads")
    for d in (64, 128):
        i = ops.flash_attention_bwd_info(d, False)
        log(f"flash_attention_bwd f32 D={d}: dQ kernel {i[0]} registers, "
            f"{i[1]} bytes of shared memory, {i[2]} bytes spilled, {i[3]} "
            f"threads; dK/dV kernel {i[4]} registers, {i[5]} bytes of "
            f"shared memory, {i[6]} bytes spilled, {i[7]} threads")
    attention_stats_checks(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (("llama3.2-1b", 32, 8, 64, 4096, bf16),
             ("qwen3-1.7b", 16, 8, 128, 4096, bf16),
             ("jamba/phi3.5-moe", 32, 8, 128, 4096, bf16),
             ("llama3.2-1b ragged", 32, 8, 64, 4097, bf16),
             ("rep 1", 16, 16, 128, 4096, bf16),
             ("D 32", 16, 8, 32, 1000, bf16),
             ("D 16", 8, 2, 16, 333, bf16),
             ("qwen3-1.7b f32", 16, 8, 128, 4096, f32),
             ("D 64 f32 ragged", 8, 4, 64, 130, f32))
    for tag, hq, hkv, d, s, dtype in cases:
        b = 1
        q, k, v, dout = (torch.randn((b, h, s, d), generator=gen, device=dev
                                     ).to(dtype) for h in (hq, hkv, hkv, hq))
        # the forward's statistics where the backward runs from them
        stats = {}
        if uses_stats(q):
            o, stats["lse"], stats["out_lo"] = flash_attention(
                q, k, v, causal=True, stats=True)
        else:
            o = flash_attention(q, k, v, causal=True)
        got = flash_attention_bwd(q, k, v, o, dout, **stats)
        again = flash_attention_bwd(q, k, v, o, dout, **stats)
        want = flash_attention_bwd_plain(q, k, v, dout)
        torch.cuda.synchronize()
        tol = ATTN_BWD_RTOL[str(dtype).split(".")[1]]
        errs, rels = [], []
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            same_bits("flash_attention_bwd", f"{tag} {name}", g, a)
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"flash_attention_bwd {tag} {name}: "
                                     f"{g.shape} {g.dtype}, want {w.shape} "
                                     f"{w.dtype}")
            err = float((g.float() - w.float()).abs().max())
            scale = float(w.float().abs().max())
            if not (bool(torch.isfinite(g).all()) and err <= tol * scale):
                raise AssertionError(
                    f"flash_attention_bwd {tag} {name}: max abs err "
                    f"{err:.3e} vs scale {scale:.3e} exceeds rel tol {tol}")
            errs.append(err)
            rels.append(err / scale)
        del got, again, want
        torch.cuda.empty_cache()
        ms = device_ms(lambda: flash_attention_bwd(q, k, v, o, dout,
                                                   **stats))
        pms = stream_ms(lambda: flash_attention_bwd_plain(q, k, v, dout))
        qq = q.detach().requires_grad_(True)
        kr, vr = (t.repeat_interleave(hq // hkv, dim=1).requires_grad_(True)
                  for t in (k, v))
        os_ = F.scaled_dot_product_attention(qq, kr, vr, is_causal=True)
        lms = device_ms(lambda: torch.autograd.grad(
            os_, (qq, kr, vr), dout, retain_graph=True))
        del qq, kr, vr, os_
        pairs = s * (s + 1) // 2
        # the least work: s recomputed, dP, dV, dQ, dK (2 D each a pair),
        # 2.5 times the forward's 4 D
        flops = 10 * b * hq * d * pairs
        nbytes = q.element_size() * d * b * s * (4 * hq + 4 * hkv)
        peak = PEAK_BF16 if dtype == bf16 else PEAK_FP32
        log(f"flash_attention_bwd {tag}: max abs err dq/dk/dv "
            f"{errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e}, relative to "
            f"the plain gradient's largest "
            f"{rels[0]:.3e} / {rels[1]:.3e} / {rels[2]:.3e} (limit {tol}); "
            f"the same bits twice")
        record(out, "flash_attention_bwd", f"{tag} B={b} Hq={hq} Hkv={hkv} "
               f"S={s} D={d} {str(dtype).split('.')[1]} causal, "
               f"{'wgmma' if stats else 'first design'}", max(errs),
               ms, pms, lms, flops, nbytes, peak, False)
        del q, k, v, dout, o, stats
        torch.cuda.empty_cache()


def attention_as(fn):
    """A stand-in for ``ops.attention`` (same signature) that runs ``fn``."""
    def attention(q, k, v, *, causal=True):
        return fn(q, k, v, causal)
    return attention


def twin_attention(q, k, v, causal, q_chunk: int, kv_chunk: int):
    """The model's plain chunked twin (P rounded to bf16 before P·V, as the
    reference's XLA twin does), on the grouped heads as ``gqa_attention``
    lays them out on the CPU."""
    from repro_torch.models.layers import flash_attention_xla

    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = hq // hkv
    out = flash_attention_xla(
        q.reshape(b * hkv, rep, s, d),
        k.reshape(b * hkv, 1, t, d).expand(b * hkv, rep, t, d),
        v.reshape(b * hkv, 1, t, d).expand(b * hkv, rep, t, d),
        causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return out.reshape(b, hq, s, d)


def prefill_on_attention(cfg, params, batch, max_seq: int, fn):
    """The prefill's logits with ``fn(q, k, v, causal)`` standing in for
    ``ops.attention`` (synced)."""
    import torch

    from repro_torch.models import layers, prefill

    real = layers.ops.attention
    layers.ops.attention = attention_as(fn)
    try:
        out, _ = prefill(cfg, params, batch, max_seq)
    finally:
        layers.ops.attention = real
    torch.cuda.synchronize()
    return out


def held_prefill(label: str, cfg, params, batch, max_seq: int) -> list:
    """A prefill whose every attention layer runs the kernel and holds it
    against the plain version on the same inputs (these launches are not a
    counted run's); returns each layer's ``hold_attention`` reading."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    held = []

    def kernel_then_plain(q, k, v, causal):
        got = flash_attention(q, k, v, causal=causal)
        held.append(hold_attention(f"{label} layer {len(held)}", got,
                                   flash_attention_plain(q, k, v,
                                                         causal=causal)))
        return got

    prefill_on_attention(cfg, params, batch, max_seq, kernel_then_plain)
    return held


def lm_serve_phase(dev) -> dict:
    """qwen3-1.7b at full width served as ``repro_torch.launch.serve``
    serves it; returns the launch counts of the 4 × 4,096 prefill."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import make_batch, serve
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"lm_serve {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{n_params} parameters ({n_params * 2 / 1e9:.3f} GB bf16), drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = make_batch(cfg, LM_BATCH, LM_PROMPT, dev)
    max_seq = LM_PROMPT + LM_STEPS

    reset_launch_counts()
    logits, cache = prefill(cfg, params, batch, max_seq)
    torch.cuda.synchronize()
    counts = launch_counts()
    launched("lm_serve prefill", counts, ("flash_attention",))
    if counts["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"lm_serve: the prefill launched the attention "
                             f"kernel {counts['flash_attention']} times, want "
                             f"{cfg.num_layers}")
    cache_bytes = sum(t.numel() * t.element_size()
                      for lc in cache["layers"] for t in lc.values())
    del cache

    # each layer's kernel output against the plain version on the same
    # inputs, in a second prefill (these launches are not the counted run's)
    from repro_torch.kernels.flash_attention import flash_attention_plain

    def prefill_on(fn):
        return prefill_on_attention(cfg, params, batch, max_seq, fn)

    held = held_prefill("lm_serve", cfg, params, batch, max_seq)
    log(f"lm_serve prefill, each layer's attention vs the plain version on "
        f"its inputs ({len(held)} layers): max abs err "
        f"{max(h[0] for h in held):.3e}, ‖Δ‖/‖plain‖ up to "
        f"{max(h[1] for h in held):.3e}, up to "
        f"{max(h[2] for h in held):.3f} of the elementwise limit")
    if len(held) != cfg.num_layers:
        raise AssertionError(f"lm_serve: {len(held)} layers held, want "
                             f"{cfg.num_layers}")
    # the logits against the model on the plain version (what the kernel
    # computes); the chunked twin, which rounds P to bf16, shows how far a
    # perturbation of that size moves these logits (printed, not held)
    plain = prefill_on(lambda q, k, v, causal: flash_attention_plain(
        q, k, v, causal=causal))
    twin = prefill_on(lambda q, k, v, causal: twin_attention(
        q, k, v, causal, cfg.attn_q_chunk, cfg.attn_kv_chunk))
    # the control: an attention 1 % off (a kernel that let the 63 padded
    # keys of a ragged tile into the sum at S = 4,097 would be ~0.9 % off)
    off = prefill_on(lambda q, k, v, causal: (flash_attention_plain(
        q, k, v, causal=causal).float() * (1 - 1e-2)).to(q.dtype))
    rel, rel_twin, rel_off = (float((x - plain).norm() / plain.norm())
                              for x in (logits, twin, off))
    log(f"lm_serve prefill logits vs the model on the plain version: "
        f"‖Δ‖/‖ref‖ {rel:.3e} (limit {LM_PREFILL_RTOL}), max abs "
        f"{float((logits - plain).abs().max()):.3e}, argmax equal "
        f"{int((logits.argmax(-1) == plain.argmax(-1)).sum())}/{LM_BATCH}; "
        f"the chunked twin {rel_twin:.3e}; the control 1 % off "
        f"{rel_off:.3e}")
    if not (bool(torch.isfinite(logits).all()) and rel <= LM_PREFILL_RTOL):
        raise AssertionError(f"lm_serve: prefill logits off the plain "
                             f"version's by {rel:.3e} relative")
    if rel_off <= LM_PREFILL_RTOL:
        raise AssertionError(f"lm_serve: an attention 1 % off moves the "
                             f"logits by {rel_off:.3e} only, within the "
                             f"limit {LM_PREFILL_RTOL}: the check is blind")
    del plain, twin, off, logits

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = serve(cfg, params, batch, LM_STEPS)
    if not (bool(torch.isfinite(r["logits"]).all())
            and r["tokens"].shape == (LM_BATCH, LM_STEPS)
            and 0 <= r["tokens"].min() and r["tokens"].max() < cfg.vocab_size):
        raise AssertionError("lm_serve: decode gave non-finite logits or "
                             "tokens out of range")
    tp, td = r["t_prefill"], r["t_decode"]
    log(f"lm_serve serve {LM_BATCH}x{LM_PROMPT} + {LM_STEPS} steps: prefill "
        f"{tp:.4f} s ({LM_BATCH * LM_PROMPT / tp:.0f} prompt tokens/s), "
        f"decode {td:.4f} s = {td / LM_STEPS * 1e3:.3f} ms/step "
        f"({LM_BATCH * LM_STEPS / td:.1f} tokens/s over {LM_BATCH} "
        f"sequences); KV cache {cache_bytes / 1e9:.3f} GB, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; tokens (seq 0) "
        f"{r['tokens'][0].tolist()}")

    # serve()'s prefill above follows empty_cache(), so it also pays for
    # fresh device allocations; these run with the allocator's cache warm
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(cfg, params, batch, max_seq)
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        warm.append((t_host, time.perf_counter() - t0))
        del out
    log(f"lm_serve prefill {LM_BATCH}x{LM_PROMPT} with the allocator warm, "
        f"3 runs: host enqueue "
        f"{', '.join(f'{h:.4f}' for h, _ in warm)} s; synced "
        f"{', '.join(f'{t:.4f}' for _, t in warm)} s")
    profile_call(f"lm_serve prefill {LM_BATCH}x{LM_PROMPT}",
                 lambda: prefill(cfg, params, batch, max_seq))
    _, cache = prefill(cfg, params, batch, max_seq)
    tok = r["prefill_logits"].argmax(-1)[:, None]

    def decode_all():
        nonlocal cache
        t = tok
        for _ in range(LM_STEPS):
            lg, cache = decode_step(cfg, params, cache, t)
            t = lg.argmax(-1)[:, None]

    profile_call(f"lm_serve {LM_STEPS} decode steps at {LM_PROMPT}",
                 decode_all)
    del cache

    short = make_batch(cfg, LM_BATCH, LM_SHORT, dev)
    reset_launch_counts()
    r = serve(cfg, params, short, LM_STEPS)
    n = launch_counts()["flash_attention"]
    log(f"lm_serve serve {LM_BATCH}x{LM_SHORT} + {LM_STEPS} steps: prefill "
        f"{r['t_prefill']:.4f} s, decode {r['t_decode'] / LM_STEPS * 1e3:.3f}"
        f" ms/step; flash_attention launches {n}")
    if n != 0 or not bool(torch.isfinite(r["logits"]).all()):
        raise AssertionError(f"lm_serve: a {LM_SHORT}-token prompt launched "
                             f"the kernel {n} times or gave non-finite logits")
    return counts


def plain_attention_f32p(q, k, v, causal: bool, kv_valid_len=None):
    """``layers._plain_attention`` with P kept in float32 through P·V (the
    function ``sharded_decode_attention`` computes, as the reference's
    does); the output in q's dtype. The plain version rounds P to v's
    dtype first."""
    import torch

    from repro_torch.models.layers import NEG_INF

    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, hkv, rep * s, d)
    scores = torch.matmul(qg.float(), k.float().transpose(-1, -2)) \
        * (d ** -0.5)
    scores = scores.view(b, hkv, rep, s, t)
    if causal and s > 1:
        mask = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :] - (t - s))
        scores = torch.where(mask, scores, NEG_INF)
    if kv_valid_len is not None:
        valid = torch.arange(t, device=q.device) < kv_valid_len
        scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).view(b, hkv, rep * s, t)
    return torch.matmul(p, v.float()).view(b, hq, s, d).to(q.dtype)


def decode_fed(cfg, params, batch: dict, steps: int, max_seq: int,
               ctx=None, feed=None) -> dict:
    """Prefill and ``steps`` decode steps of ``cfg`` at B 1: under the mesh
    context ``ctx`` on this rank's shards of the logical ``params`` when it
    is given, else unsharded; each step fed ``feed[i]`` when given, else
    the greedy pick. Returns the prefill's launch ``counts``, ``logits``
    (the prefill's, then each step's), the argmax ``picks`` of the steps'
    inputs, ``prefill_s``, ``step_s`` (the median step), and ``cache`` and
    ``params`` as the last step left them and ran on."""
    import torch

    from repro_torch.distributed.meshctx import MeshContext, mesh_context
    from repro_torch.distributed.sharding import map_specs, to_shardings
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, prefill

    dev = next(iter(batch.values())).device
    if ctx is not None:
        params = map_specs(lambda sh, t: sh.shard(t).contiguous(),
                           to_shardings(ctx.specs, ctx), params)
    scope = ctx or MeshContext(None)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    with mesh_context(scope):
        logits, cache = prefill(cfg, params, batch, max_seq)
    sync()
    prefill_s, counts = time.perf_counter() - t0, launch_counts()
    out, picks, ts = [logits], [], []
    for i in range(steps):
        picks.append(int(logits.argmax(-1)[0]))
        tok = torch.tensor([[picks[-1] if feed is None else int(feed[i])]],
                           device=dev)
        t0 = time.perf_counter()
        with mesh_context(scope):
            logits, cache = decode_step(cfg, params, cache, tok)
        sync()
        ts.append(time.perf_counter() - t0)
        out.append(logits)
    return dict(counts=counts, logits=out, picks=np.array(picks),
                prefill_s=prefill_s, step_s=float(np.median(ts)),
                cache=cache, params=params)


def logit_shares(got, want) -> list:
    """Each step's largest logit difference as a share of ``want``'s
    largest logit."""
    return [float((g.float() - w.float()).abs().max())
            / float(w.float().abs().max()) for g, w in zip(got, want)]


def pick_differences(got, want, got_picks, want_picks) -> list:
    """Where two decodes fed the same tokens pick differently: the step,
    the picks, how far apart ``want``'s top two logits lie, how far the
    logits lie apart, and whether that explains the difference (a near tie:
    the gap at most twice the distance)."""
    import torch

    diffs = []
    for i in np.nonzero(got_picks != want_picks)[0]:
        top2 = torch.topk(want[i][0].float(), 2).values
        gap = float(top2[0] - top2[1])
        apart = float((got[i].float() - want[i].float()).abs().max())
        diffs.append(dict(step=int(i), got=int(got_picks[i]),
                          want=int(want_picks[i]), gap=gap, apart=apart,
                          near_tie=gap <= 2 * apart))
    return diffs


def lm_serve_mesh_phase(dev, out: dict, headline: bool) -> dict:
    """LM decode from a sequence-sharded cache: qwen3-1.7b at full width
    and depth (seeded weights) through an NCCL group of one rank and a
    1 x 1 (data, model) mesh whose context sets ``decode_seq_axes=
    ("data",)`` (the dry run's rule would not on one card), laid out as
    ``repro_torch.launch.serve --devices`` lays it out: B 1, a prompt of
    LM_PROMPT (28 ``flash_attention`` launches in the bf16 prefill), a
    cache of LM_MESH_SEQ positions, LM_STEPS steps through
    ``sharded_decode_attention``, against the unsharded ``prefill`` /
    ``decode_step`` in the same call, every run fed the tokens the plain
    unsharded run picks greedily.

    In bf16, the served dtype, any change of the attention's roundings
    moves 28 random layers' logits by ~2 % of the largest: the control is
    the unsharded decode with P kept in float32
    (:func:`plain_attention_f32p`, the function the sharded decode
    computes). The sharded run must lie within the larger of
    LM_MESH_BF16_TOL and LM_MESH_BF16_CONTROL times the control's distance
    from the plain unsharded decode, with equal greedy picks (a difference
    passes only on a near tie, printed). On a float32 copy of the weights,
    where no rounding to bf16 is left, the sharded run must lie within
    LM_MESH_TOL of the unsharded one with the same picks; its two prefills
    launch the float32 ``flash_attention`` a layer each, counted in the
    log. Then ``sharded_decode_attention`` alone against the plain decode
    attention at the bf16 operands, timed, and the kernel at the prefill's
    B 1 shape. Returns the bf16 prefill's launch counts."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import (collective_counts,
                                                     reset_collective_counts)
    from repro_torch.distributed.meshctx import mesh_context
    from repro_torch.distributed.sharding import map_specs, to_shardings
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.launch.serve import make_batch, mesh_layout
    from repro_torch.models import decode_step, init_params, layers
    from repro_torch.models.layers import (gqa_attention,
                                           sharded_decode_attention)

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    tmp = tempfile.mkdtemp(prefix="lm_serve_mesh_")
    init_ranks(0, 1, os.path.join(tmp, "store"), dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        ctx, _, _ = mesh_layout(cfg, mesh, 1, LM_MESH_SEQ)
        ctx.decode_seq_axes = ("data",)
        batch = make_batch(cfg, 1, LM_PROMPT, dev)
        log(f"lm_serve_mesh {cfg.name}: backend {dist.get_backend()}, "
            f"{mesh}; cache specs of layer 0 {ctx.cache_specs['layers'][0]}, "
            f"decode_seq_axes {ctx.decode_seq_axes}")

        def run(c, params, sharded: bool, feed=None):
            return decode_fed(c, params, batch, LM_STEPS, LM_MESH_SEQ,
                              ctx if sharded else None, feed)

        def held(tag, got, want, tol):
            rel = logit_shares(got["logits"], want["logits"])
            if not (all(bool(torch.isfinite(g).all()) for g in got["logits"])
                    and max(rel) <= tol):
                raise AssertionError(f"lm_serve_mesh {tag}: logits "
                                     f"{max(rel):.3e} of the largest off "
                                     f"(limit {tol:.3e})")
            for d in pick_differences(got["logits"], want["logits"],
                                      got["picks"], want["picks"]):
                log(f"lm_serve_mesh {tag} step {d['step']}: picks "
                    f"{d['got']} against {d['want']}; the unsharded top two "
                    f"{d['gap']:.3e} apart, the logits {d['apart']:.3e} "
                    f"apart")
                if not d["near_tie"]:
                    raise AssertionError(f"lm_serve_mesh {tag}: step "
                                         f"{d['step']} picks {d['got']} for "
                                         f"{d['want']}, not a near tie")
            return rel

        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        plain_run = run(cfg, params, False)
        feed = plain_run["picks"]
        real = layers._plain_attention
        layers._plain_attention = plain_attention_f32p
        try:
            twin = run(cfg, params, False, feed)
        finally:
            layers._plain_attention = real
        reset_collective_counts()
        got = run(cfg, params, True, feed)
        counts = got["counts"]
        local, tok = got["params"], got["logits"][-1].argmax(-1)[:, None]

        def more():
            cache = got["cache"]
            with mesh_context(ctx):
                for _ in range(4):
                    _, cache = decode_step(cfg, local, cache, tok)

        profile_call("lm_serve_mesh 4 sharded decode steps", more)
        coll = collective_counts()
        launched("lm_serve_mesh prefill", counts, ("flash_attention",))
        if counts["flash_attention"] != cfg.num_layers:
            raise AssertionError(f"lm_serve_mesh: the prefill launched the "
                                 f"attention kernel {counts['flash_attention']}"
                                 f" times, want {cfg.num_layers}")
        control = max(logit_shares(twin["logits"], plain_run["logits"]))
        rel = held("bf16", got, plain_run,
                   max(LM_MESH_BF16_TOL, LM_MESH_BF16_CONTROL * control))
        log(f"lm_serve_mesh bf16 logits, a step, as a share of the largest "
            f"logit: sharded vs plain unsharded "
            f"{json.dumps([f'{d:.3e}' for d in rel])}; the control (the "
            f"unsharded decode with P in float32) vs plain up to "
            f"{control:.3e}, vs sharded up to "
            f"{max(logit_shares(got['logits'], twin['logits'])):.3e}; picks "
            f"{got['picks'].tolist()} (plain {feed.tolist()}); decode "
            f"(median of {LM_STEPS}) {got['step_s'] * 1e3:.3f} ms a step "
            f"sharded, {plain_run['step_s'] * 1e3:.3f} unsharded; "
            f"collectives of the sharded run (its prefill, {LM_STEPS} timed "
            f"and 4 profiled steps) {json.dumps(coll)}")
        kv_mesh = got["cache"]["layers"][0]["k"]
        del plain_run, twin, got, local

        # float32 weights: no rounding to bf16 left between the two. Each
        # prefill of 4,096 runs the float32 attention kernel a layer
        c32 = dataclasses.replace(cfg, dtype="float32")
        p32 = map_specs(lambda _, t: t.float(), to_shardings(ctx.specs, ctx),
                        params)
        want32 = run(c32, p32, False)
        got32 = run(c32, p32, True, want32["picks"])
        rel32 = held("float32", got32, want32, LM_MESH_TOL)
        f32_launches = (want32["counts"]["flash_attention"]
                        + got32["counts"]["flash_attention"])
        log(f"lm_serve_mesh float32 weights: sharded vs unsharded logits up "
            f"to {max(rel32):.3e} of the largest (limit {LM_MESH_TOL}); "
            f"picks {got32['picks'].tolist()} (unsharded "
            f"{want32['picks'].tolist()}); decode (median) "
            f"{got32['step_s'] * 1e3:.3f} ms a step sharded, "
            f"{want32['step_s'] * 1e3:.3f} unsharded; the two float32 "
            f"prefills launched flash_attention {f32_launches} times")
        del p32, want32, got32

        # the attention alone at a layer's operands: the bf16 cache of layer
        # 0 after the steps, q and the new k/v drawn at its shape
        gen = torch.Generator(device=dev).manual_seed(6)
        hd, hq, hkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
        q = torch.randn((1, hq, 1, hd), generator=gen, device=dev
                        ).to(kv_mesh.dtype)
        kn = torch.randn((1, hkv, 1, hd), generator=gen, device=dev
                         ).to(kv_mesh.dtype)
        pos = LM_PROMPT + LM_STEPS
        ck, cv = kv_mesh.clone(), kv_mesh.clone()
        sharded = sharded_decode_attention(q, ck, cv, kn, kn, pos, ctx=ctx,
                                           seq_axes=("data",),
                                           rep=hq // hkv)[0]
        plain = gqa_attention(q, ck, cv, causal=False, kv_valid_len=pos + 1,
                              impl="plain", q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk)
        err = float((sharded.float() - plain.float()).abs().max())
        scale = float(plain.float().abs().max())
        ms = device_ms(lambda: sharded_decode_attention(
            q, ck, cv, kn, kn, pos, ctx=ctx, seq_axes=("data",),
            rep=hq // hkv))
        pms = device_ms(lambda: gqa_attention(
            q, ck, cv, causal=False, kv_valid_len=pos + 1, impl="plain",
            q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk))
        log(f"lm_serve_mesh sharded_decode_attention (B 1, Hq {hq}, Hkv "
            f"{hkv}, cache {LM_MESH_SEQ}, pos {pos}, D {hd}, bf16): max abs "
            f"err {err:.3e} vs the plain decode attention (scale "
            f"{scale:.3e}); {ms:.5f} ms, plain {pms:.5f} ms (the plain one "
            f"reads all {LM_MESH_SEQ} masked positions, the sharded one the "
            f"{pos + 1} written)")
        if not err <= 2e-2 * max(scale, 1e-30):
            raise AssertionError(f"lm_serve_mesh: sharded decode attention "
                                 f"{err:.3e} off the plain one")
        del params, kv_mesh, ck, cv
        torch.cuda.empty_cache()
        # the kernel at the mesh prefill's attention shape (B 1)
        attention_case(torch.Generator(device=dev).manual_seed(4), dev, out,
                       1, "qwen3-1.7b mesh prefill", cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim_, LM_PROMPT, True,
                       None, torch.bfloat16, headline=headline)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    PHASE_S["lm_serve_mesh"] = time.perf_counter() - t_phase
    return counts


def lm_serve_mixers_phase(dev, out: dict, headline: bool) -> dict:
    """The archs with Mamba, MoE and xLSTM layers served at full width
    (``MIXER_RUNS``); returns the summed ``flash_attention`` launches of
    the counted prefills, and records the kernel at jamba's attention
    shape in ``out`` (as the kernels line's headline when ``headline``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.launch.serve import make_batch, serve
    from repro_torch.models import decode_step, init_params, prefill

    t_phase = time.perf_counter()
    total = 0
    for arch, n_layers, b, s, steps in MIXER_RUNS:
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=n_layers)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        n_attn = len(cfg.attn_layers)
        kinds = "".join(cfg.layer_kind(i) for i in range(cfg.num_layers))
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
        log(f"lm_serve_mixers {cfg.name}: {cfg.num_layers} layers "
            f"({kinds}; {n_moe} MoE of {cfg.num_experts} experts top "
            f"{cfg.experts_per_token}), d_model {cfg.d_model}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}; {wbytes / 1e9:.3f} GB of "
            f"weights")
        batch = make_batch(cfg, b, s, dev)
        max_seq = s + steps

        reset_launch_counts()
        logits, cache = prefill(cfg, params, batch, max_seq)
        torch.cuda.synchronize()
        n = launch_counts()["flash_attention"]
        total += n
        log(f"lm_serve_mixers {cfg.name} prefill {b}x{s}: flash_attention "
            f"launches {n} ({n_attn} attention layers)")
        if n != n_attn:
            raise AssertionError(f"lm_serve_mixers {cfg.name}: the prefill "
                                 f"launched the attention kernel {n} times, "
                                 f"want {n_attn}")
        cache_bytes = sum(t.numel() * t.element_size()
                          for lc in cache["layers"] for t in lc.values())
        del cache
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"lm_serve_mixers {cfg.name}: non-finite "
                                 f"prefill logits")

        if n_attn:
            held = held_prefill(f"lm_serve_mixers {cfg.name}", cfg, params,
                                batch, max_seq)
            if len(held) != n_attn:
                raise AssertionError(f"lm_serve_mixers {cfg.name}: "
                                     f"{len(held)} layers held, want {n_attn}")
            plain = prefill_on_attention(
                cfg, params, batch, max_seq,
                lambda q, k, v, causal: flash_attention_plain(
                    q, k, v, causal=causal))
            rel = float((logits - plain).norm() / plain.norm())
            log(f"lm_serve_mixers {cfg.name} prefill: each attention layer "
                f"vs the plain version on its inputs: ‖Δ‖/‖plain‖ up to "
                f"{max(h[1] for h in held):.3e}, up to "
                f"{max(h[2] for h in held):.3f} of the elementwise limit; "
                f"logits vs the model on the plain version ‖Δ‖/‖ref‖ "
                f"{rel:.3e} (limit {LM_PREFILL_RTOL}), argmax equal "
                f"{int((logits.argmax(-1) == plain.argmax(-1)).sum())}/{b}")
            if rel > LM_PREFILL_RTOL:
                raise AssertionError(f"lm_serve_mixers {cfg.name}: prefill "
                                     f"logits off the plain version's by "
                                     f"{rel:.3e} relative")
            del plain
        else:
            # the prefill's state carried into decode: one step from it
            # against a prefill over the prompt and that token
            tok = logits.argmax(-1)[:, None]
            longer = {"tokens": torch.cat([batch["tokens"], tok], dim=1)}
            rels = {}
            for dtype in ("float32", cfg.dtype):
                c = dataclasses.replace(cfg, dtype=dtype)
                p = params if dtype == cfg.dtype else _to_float(params)
                _, cache = prefill(c, p, batch, max_seq)
                stepped, _ = decode_step(c, p, cache, tok)
                whole, _ = prefill(c, p, longer, max_seq)
                rels[dtype] = float((stepped - whole).norm() / whole.norm())
                del cache, p
            log(f"lm_serve_mixers {cfg.name}: a decode step from the "
                f"prefill's state vs a prefill of {s + 1}: ‖Δ‖/‖ref‖ "
                f"{rels['float32']:.3e} on float32 weights (limit "
                f"{MIXER_CONTINUE_RTOL}), {rels[cfg.dtype]:.3e} in "
                f"{cfg.dtype} (not held)")
            if not rels["float32"] <= MIXER_CONTINUE_RTOL:
                raise AssertionError(f"lm_serve_mixers {cfg.name}: decode "
                                     f"from the prefill's state off by "
                                     f"{rels['float32']:.3e}")
        del logits

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = serve(cfg, params, batch, steps)
        if not (bool(torch.isfinite(r["logits"]).all())
                and r["tokens"].shape == (b, steps)
                and 0 <= r["tokens"].min()
                and r["tokens"].max() < cfg.vocab_size):
            raise AssertionError(f"lm_serve_mixers {cfg.name}: decode gave "
                                 f"non-finite logits or tokens out of range")
        tp, td = r["t_prefill"], r["t_decode"]
        # each step reads every weight once (the dense experts path runs
        # every expert), and each state or k/v cache
        bound = (wbytes + cache_bytes) / PEAK_BYTES * 1e3
        log(f"lm_serve_mixers {cfg.name} serve {b}x{s} + {steps} steps: "
            f"prefill {tp:.4f} s ({b * s / tp:.0f} prompt tokens/s), decode "
            f"{td:.4f} s = {td / steps * 1e3:.3f} ms/step (bound "
            f"{bound:.3f} ms/step: {(wbytes + cache_bytes) / 1e9:.3f} GB at "
            f"{PEAK_BYTES / 1e12:.2f} TB/s); cache {cache_bytes / 1e9:.4f} "
            f"GB, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; tokens "
            f"(seq 0) {r['tokens'][0].tolist()}")
        if arch == MIXER_RUNS[0][0]:
            profile_call(f"lm_serve_mixers {cfg.name} prefill {b}x{s}",
                         lambda: prefill(cfg, params, batch, max_seq))
            _, cache = prefill(cfg, params, batch, max_seq)
            tok = r["prefill_logits"].argmax(-1)[:, None]

            def decode_all():
                nonlocal cache
                t = tok
                for _ in range(steps):
                    lg, cache = decode_step(cfg, params, cache, t)
                    t = lg.argmax(-1)[:, None]

            profile_call(f"lm_serve_mixers {cfg.name} {steps} decode steps "
                         f"at {s}", decode_all)
            del cache
            # the kernel at jamba's attention shape, on seeded inputs
            attention_case(torch.Generator(device=dev).manual_seed(5), dev,
                           out, b, cfg.name, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim_, s, True, None, torch.bfloat16,
                           headline)
        del params, r
    PHASE_S["lm_serve_mixers"] = time.perf_counter() - t_phase
    log(f"lm_serve_mixers: {PHASE_S['lm_serve_mixers']:.1f} s")
    return {"flash_attention": total}


def _to_float(tree):
    """A float32 copy of a parameter tree."""
    if isinstance(tree, dict):
        return {k: _to_float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_float(v) for v in tree]
    return tree.float()


def capture_attention_bwd():
    """Patch ``FlashAttentionFn.backward`` to keep the operands and the
    gradients of the first backward it runs (the last layer's attention,
    the first that the backward reaches) as the training step passes
    them. The patched backward does what the real one does (a checkpointed
    layer's saved tensors unpack once, so it cannot call the real one after
    reading them): one ``flash_attention_bwd`` call from the saved
    tensors (the forward's statistics among them, where the forward stored
    them), launched and counted as unpatched. Returns the dict it fills and
    a function that undoes the patch."""
    import importlib

    # the module: the package's attribute of that name is the function
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    real = fa.FlashAttentionFn.__dict__["backward"]
    cap = {}

    def backward(ctx, dout):
        q, k, v, o, *st = ctx.saved_tensors
        stats = dict(zip(("lse", "out_lo"), st))
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, dout,
                                            causal=ctx.causal, **stats)
        if not cap:
            # clone() keeps a dense tensor's strides, so the layouts stay
            cap.update(q=q, k=k, v=v, o=o, dout=dout.clone(), stats=stats,
                       grads=[g.clone() for g in (dq, dk, dv)])
        return dq, dk, dv, None, None

    fa.FlashAttentionFn.backward = staticmethod(backward)

    def undo():
        fa.FlashAttentionFn.backward = real
    return cap, undo


def attention_bwd_in_kernel_precision(q, k, v, dout):
    """The backward's formulas in plain PyTorch, rounded where the bf16
    kernel rounds: P and dS rounded to bf16 before their products, float32
    sums (D = Σ_j P_ij dP_ij among them), the gradients rounded to bf16.
    One batch element (B 1), causal, as many keys as queries. Without
    autograd: the training step's saved operands require gradients, and a
    graph built through the in-place updates below kept its (Hq, S, S)
    float32 intermediates alive after the call (about 20 GB at the step's
    shape)."""
    import torch

    with torch.no_grad():
        return _attention_bwd_in_kernel_precision(q, k, v, dout)


def _attention_bwd_in_kernel_precision(q, k, v, dout):
    import torch

    _, hq, s, d = q.shape
    rep = hq // k.shape[1]
    qf, kf, vf, df = (t[0].float() for t in (q, k, v, dout))
    kr, vr = (t.repeat_interleave(rep, dim=0) for t in (kf, vf))
    scale = d ** -0.5
    sc = torch.matmul(qf, kr.transpose(-1, -2)) * scale
    sc.masked_fill_(torch.ones(s, s, dtype=torch.bool, device=q.device
                               ).triu_(1), -1e30)
    p = torch.softmax(sc, dim=-1)
    del sc
    ds = torch.matmul(df, vr.transpose(-1, -2))
    ds.sub_((p * ds).sum(-1, keepdim=True)).mul_(p)
    ds = ds.bfloat16().float()
    p = p.bfloat16().float()
    dq = torch.matmul(ds, kr) * scale
    dk = (torch.matmul(ds.transpose(-1, -2), qf) * scale
          ).view(-1, rep, s, d).sum(1)
    dv = torch.matmul(p.transpose(-1, -2), df).view(-1, rep, s, d).sum(1)
    return tuple(t[None].to(q.dtype) for t in (dq, dk, dv))


def hold_step_attention_bwd(cap: dict, out: dict, tag: str = "training step",
                            headline: bool = True) -> None:
    """flash_attention_bwd at the training step's own shape and layouts:
    the operands that one Trainer.step passed it (``capture_attention_bwd``;
    llama3.2-1b's B 4, Hq 32, Hkv 8, S 4,096, D 64, or jamba-v0.1-52b's
    B 1, Hq 32, Hkv 8, D 128, bf16, with q, k, v, the output and dO strided
    as the model's head-transposed views make them). A rerun
    gives the step's bits, and so does the kernel on each batch element
    alone (B 1), which holds its batch index at every b. Each element's
    gradients are held against the plain gradients (the (Hq, S, S) float32
    scores of one element fit), beside the same formulas carried out in
    the kernel's precision (``attention_bwd_in_kernel_precision``). Timed
    beside the plain version over the batch elements and the backward of
    SDPA on k/v repeated to the query heads (timed only): with
    ``headline``, the kernels line's figures for flash_attention_bwd."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, operand_error)

    q, k, v, o, dout = (cap[n] for n in ("q", "k", "v", "o", "dout"))
    stats = cap["stats"]
    if not stats:
        raise AssertionError(f"flash_attention_bwd {tag}: the "
                             f"forward saved no statistics")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    names = ("dq", "dk", "dv")
    layouts = "; ".join(
        f"{n} strides {tuple(t.stride())}"
        f"{'' if t.is_contiguous() else ' (a view)'}"
        f"{'' if operand_error(t) is None else ' (copied: ' + operand_error(t) + ')'}"
        for n, t in (("q", q), ("k", k), ("v", v), ("out", o), ("dO", dout)))
    again = flash_attention_bwd(q, k, v, o, dout, **stats)
    for name, g, a in zip(names, cap["grads"], again):
        same_bits("flash_attention_bwd", f"{tag} {name}", g, a)
    del again
    tol = ATTN_BWD_RTOL[str(q.dtype).split(".")[1]]
    errs, fails, rows = [0.0] * 3, [], []
    for i in range(b):
        one = [t[i:i + 1] for t in (q, k, v, o, dout)]
        one_stats = {n: t[i:i + 1] for n, t in stats.items()}
        for name, g, a in zip(names, cap["grads"],
                              flash_attention_bwd(*one, **one_stats)):
            same_bits("flash_attention_bwd", f"{tag} b={i} alone "
                      f"{name}", g[i:i + 1], a)
        want = flash_attention_bwd_plain(*one[:3], one[4])
        emul = attention_bwd_in_kernel_precision(*one[:3], one[4])
        torch.cuda.synchronize()
        row = []
        for j, (name, g, w, e) in enumerate(zip(names, cap["grads"], want,
                                                emul)):
            g = g[i:i + 1]
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"flash_attention_bwd {tag} "
                                     f"{name}: {g.shape} {g.dtype}, want "
                                     f"{w.shape} {w.dtype}")
            wf = w.float()
            err = float((g.float() - wf).abs().max())
            err_e = float((e.float() - wf).abs().max())
            scale = float(wf.abs().max())
            errs[j] = max(errs[j], err)
            row.append(f"{name} {err / scale:.3e} (in the kernel's "
                       f"precision {err_e / scale:.3e})")
            if not (bool(torch.isfinite(g).all()) and scale > 0
                    and err <= tol * scale):
                fails.append(f"b={i} {name}: max abs err {err:.3e} vs "
                             f"scale {scale:.3e}")
        rows.append(f"b={i}: " + ", ".join(row))
        del want, emul, one
    torch.cuda.empty_cache()
    log(f"flash_attention_bwd {tag} (the last layer): {layouts}; "
        f"from the forward's saved statistics (lse "
        f"{tuple(stats['lse'].shape)}, out_lo); "
        f"the same bits on a rerun and on each batch element alone; max abs "
        f"err dq/dk/dv {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e}; "
        f"relative to each element's largest plain gradient: "
        + "; ".join(rows) + f" (limit {tol})")
    if fails:
        raise AssertionError(f"flash_attention_bwd {tag}: "
                             f"{'; '.join(fails)} exceed rel tol {tol}")
    ms = device_ms(lambda: flash_attention_bwd(q, k, v, o, dout, **stats))
    pms = stream_ms(lambda: [flash_attention_bwd_plain(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], dout[i:i + 1]) for i in range(b)])
    qq = q.detach().requires_grad_(True)
    kr, vr = (t.repeat_interleave(hq // hkv, dim=1).requires_grad_(True)
              for t in (k, v))
    os_ = F.scaled_dot_product_attention(qq, kr, vr, is_causal=True)
    lms = device_ms(lambda: torch.autograd.grad(
        os_, (qq, kr, vr), dout, retain_graph=True))
    del qq, kr, vr, os_
    pairs = s * (s + 1) // 2
    flops = 10 * b * hq * d * pairs
    nbytes = q.element_size() * d * b * s * (4 * hq + 4 * hkv)
    record(out, "flash_attention_bwd", f"{tag} B={b} Hq={hq} "
           f"Hkv={hkv} S={s} D={d} {str(q.dtype).split('.')[1]} causal, "
           f"the step's layouts", max(errs), ms, pms, lms, flops, nbytes,
           PEAK_BF16 if q.dtype == torch.bfloat16 else PEAK_FP32, headline)


def lm_train_phase(dev, out: dict) -> dict:
    """llama3.2-1b trained at full width and depth through Trainer.step on
    the card, the attention backward held at the operands step 0 passed it
    (``hold_step_attention_bwd``, into ``out``), and the trainer's
    checkpoint/restart at 2 layers; returns the launch counts of the 6
    steps."""
    import math
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import layers, loss_fn
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
    from repro_torch.train.optimizer import tree_leaves

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    tokens = TRAIN_SEQ * TRAIN_BATCH
    tmp = tempfile.mkdtemp(prefix="lm_train_")
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, shape, TrainerConfig(
            ckpt_dir=os.path.join(tmp, "full"), total_steps=100,
            warmup_steps=1, log_every=1), AdamWConfig(lr=TRAIN_LR),
            device=dev)
        params, opt = trainer.init_state()
        n_params = sum(t.numel() for t in tree_leaves(params))
        state_gb = sum(t.numel() * t.element_size()
                       for t in tree_leaves((params, opt))) / 1e9
        log(f"lm_train {cfg.name}: {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
            f"{cfg.head_dim_}, vocab {cfg.vocab_size}, {cfg.dtype}; "
            f"{n_params} parameters; parameters and optimizer state "
            f"{state_gb:.3f} GB; batch {TRAIN_BATCH} x {TRAIN_SEQ}")

        # the step-0 loss on the plain attention, the same params and batch
        batch0 = trainer.data.batch(0)
        real = layers.ops.attention
        layers.ops.attention = attention_as(
            lambda q, k, v, causal: flash_attention_plain(q, k, v,
                                                          causal=causal))
        try:
            with torch.no_grad():
                plain_loss = float(loss_fn(trainer.cfg, params, batch0)[0])
        finally:
            layers.ops.attention = real

        losses, gnorms, walls, totals = [], [], [], {}
        # the steps' own peak, for lm_train_mesh; the phase's line keeps
        # the peak since the phase began (the plain-attention loss above)
        before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            batch = batch0 if step == 0 else trainer.data.batch(step)
            torch.cuda.synchronize()
            if step == 0:
                cap, undo = capture_attention_bwd()
            reset_launch_counts()
            t0 = time.perf_counter()
            try:
                params, opt, m = trainer.step(params, opt, batch, step)
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
                torch.cuda.synchronize()
            finally:
                if step == 0:
                    undo()
            walls.append(time.perf_counter() - t0)
            counts = launch_counts()
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            losses.append(loss)
            gnorms.append(gnorm)
            log(f"lm_train step {step}: loss {loss:.6f}, grad norm "
                f"{gnorm:.6f}, wall {walls[-1] * 1e3:.1f} ms "
                f"({tokens / walls[-1]:.0f} tokens/s); flash_attention "
                f"{counts['flash_attention']}, flash_attention_bwd "
                f"{counts['flash_attention_bwd']} launches")
            want = {"flash_attention": 2 * cfg.num_layers,
                    "flash_attention_bwd": cfg.num_layers}
            got = {k: counts[k] for k in want}
            if got != want:
                raise AssertionError(f"lm_train step {step}: launches {got}, "
                                     f"want {want}")
        launched("lm_train", totals, ("flash_attention",
                                      "flash_attention_bwd"))
        ln_v = math.log(cfg.vocab_size)
        expect = ln_v + 0.02 ** 2 * cfg.d_model / 2
        warm = walls[1:]
        log(f"lm_train {TRAIN_STEPS} steps: loss0 {losses[0]:.6f} (ln V "
            f"{ln_v:.6f}, |loss0 - ln V| {abs(losses[0] - ln_v):.4f}; "
            f"expected at this init ln V + σ²/2 {expect:.6f}, band "
            f"{LOSS0_BAND}); the plain attention's loss0 {plain_loss:.6f} "
            f"(|Δ| {abs(losses[0] - plain_loss):.2e}, limit "
            f"{TRAIN_LOSS_ATOL}); last loss {losses[-1]:.6f}; step wall ms "
            f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}; steps 1-"
            f"{TRAIN_STEPS - 1} mean {sum(warm) / len(warm) * 1e3:.1f} ms, "
            f"{tokens * len(warm) / sum(warm):.0f} tokens/s; peak device "
            f"memory {max(before, torch.cuda.max_memory_allocated()) / 1e9:.3f} GB "
            f"(the {TRAIN_STEPS} steps alone "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB)")
        if not all(math.isfinite(x) for x in losses + gnorms):
            raise AssertionError(f"lm_train: losses {losses}, grad norms "
                                 f"{gnorms} not all finite")
        if abs(losses[0] - plain_loss) > TRAIN_LOSS_ATOL:
            raise AssertionError(f"lm_train: loss0 {losses[0]} on the kernels"
                                 f" vs {plain_loss} on the plain attention")
        if abs(losses[0] - expect) > LOSS0_BAND:
            raise AssertionError(f"lm_train: loss0 {losses[0]} is not within "
                                 f"{LOSS0_BAND} of {expect}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"lm_train: the loss did not fall: {losses}")
        TRAIN_RUN.update(losses=losses, walls=walls,
                         peak=torch.cuda.max_memory_allocated())
        hold_step_attention_bwd(cap, out)
        del cap
        _train_step_profile("lm_train", trainer, params, opt,
                            trainer.data.batch(TRAIN_STEPS), TRAIN_STEPS,
                            walls[-1])
        torch.cuda.synchronize()
        del params, opt, trainer, batch0, batch
        torch.cuda.empty_cache()
        lm_train_restart(dev, cfg, shape, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    PHASE_S["lm_train"] = time.perf_counter() - t_phase
    return totals


def lm_train_restart(dev, cfg, shape, tmp: str) -> None:
    """Trainer.run_with_restart at full width and TRAIN_CKPT_LAYERS layers:
    checkpoints every 2 steps, a failure injected before step 3, a restore
    and 4 steps in all, against an uninterrupted run of 4 steps."""
    import dataclasses

    import torch

    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.optimizer import tree_leaves

    cut = dataclasses.replace(cfg, num_layers=TRAIN_CKPT_LAYERS)
    runs = {}
    for tag, kw in (("uninterrupted", dict(ckpt_every=4)),
                    ("restarted", dict(ckpt_every=2, fail_at_step=3))):
        trainer = Trainer(cut, shape, TrainerConfig(
            ckpt_dir=os.path.join(tmp, tag), total_steps=100,
            warmup_steps=1, log_every=1, **kw), device=dev)
        t0 = time.perf_counter()
        runs[tag] = trainer.run_with_restart(4)
        torch.cuda.synchronize()
        d = os.path.join(tmp, tag)
        sizes = {c: sum(os.path.getsize(os.path.join(d, c, f))
                        for f in os.listdir(os.path.join(d, c)))
                 for c in sorted(os.listdir(d))}
        log(f"lm_train restart {tag} ({TRAIN_CKPT_LAYERS} layers): "
            f"{time.perf_counter() - t0:.2f} s, checkpoints kept (bytes) "
            f"{sizes}")
    a, b = (tree_leaves(runs[t]) for t in ("uninterrupted", "restarted"))
    unequal, worst = 0, 0.0
    for x, y in zip(a, b):
        if x.dtype == torch.int32:
            if not torch.equal(x, y):
                raise AssertionError("lm_train restart: the step counts "
                                     "differ")
            continue
        x, y = x.detach().float(), y.detach().float()
        diff = (x - y).abs()
        unequal += int((diff > 0).sum())
        # one bf16 step of y's magnitude at most: 2^-7 |y| bounds it
        share = float((diff / (2 ** -7 * y.abs() + 1e-30)).max())
        worst = max(worst, share)
    log(f"lm_train restart: final parameters and optimizer state against "
        f"the uninterrupted run: {unequal} unequal elements, largest "
        f"difference {worst:.3f} of one bf16 step")
    if worst > 1.0:
        raise AssertionError(f"lm_train restart: the restarted run is off the "
                             f"uninterrupted one by {worst:.3f} bf16 steps")


def hold_mesh_attention(cap: dict) -> None:
    """Both attention kernels at the operands the mesh path gave them
    (``capture_attention_bwd`` of its step 0, the last layer): the
    forward's output against ``flash_attention_plain`` and the step's own
    gradients against ``flash_attention_bwd_plain``; then on the local
    heads a rank of a model axis of MESH_SLICE_WIDTH gets (its q heads and
    the kv heads they read as views of the step's tensors: head slices of q
    and k, a column slice of v's projection), both kernels against the
    plain versions. One batch element at a time: the plain versions'
    float32 scores of all four would take ~35 GB."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain, operand_error)

    tol = ATTN_BWD_RTOL[str(cap["q"].dtype).split(".")[1]]

    def hold(tag, out, grads, q, k, v, dout):
        fwd, bwd = (0.0, 0.0, 0.0), [0.0, 0.0, 0.0]
        for i in range(q.shape[0]):
            one = [t[i:i + 1] for t in (q, k, v)]
            got = hold_attention(f"{tag} b={i}", out[i:i + 1],
                                 flash_attention_plain(*one, causal=True))
            fwd = tuple(max(a, b) for a, b in zip(fwd, got))
            plain = flash_attention_bwd_plain(*one, dout[i:i + 1])
            for j, (g, w) in enumerate(zip(grads, plain)):
                g, w = g[i:i + 1].float(), w.float()
                rel = float((g - w).abs().max() / w.abs().max())
                bwd[j] = max(bwd[j], rel)
                if not (bool(torch.isfinite(g).all()) and rel <= tol):
                    raise AssertionError(f"flash_attention_bwd {tag} b={i}: "
                                         f"{rel:.3e} of the largest plain "
                                         f"gradient > {tol}")
            del plain
        torch.cuda.empty_cache()
        log(f"lm_train_mesh {tag}: flash_attention max abs err {fwd[0]:.3e},"
            f" ‖Δ‖/‖plain‖ {fwd[1]:.3e} (largest of an element), "
            f"{fwd[2]:.3f} of the elementwise limit; flash_attention_bwd "
            f"dq/dk/dv {bwd[0]:.3e} / {bwd[1]:.3e} / {bwd[2]:.3e} of the "
            f"largest plain gradient (limit {tol})")

    q, k, v, o, dout = (cap[n] for n in ("q", "k", "v", "o", "dout"))
    hold(f"the step's operands {tuple(q.shape)}", o, cap["grads"], q, k, v,
         dout)
    n, r = MESH_SLICE_WIDTH, MESH_SLICE_RANK
    hq, hkv = q.shape[1] // n, k.shape[1] // n
    ql, kl, vl, dl = (t[:, r * h:(r + 1) * h] for t, h in (
        (q, hq), (k, hkv), (v, hkv), (dout, hq)))
    log(f"lm_train_mesh column-slice views, model width {n}, rank {r} ({hq} "
        f"q heads, {hkv} kv heads): " + "; ".join(
            f"{name} strides {tuple(t.stride())} offset {t.storage_offset()}"
            + ("" if operand_error(t) is None else " (refused)")
            for name, t in (("q", ql), ("k", kl), ("v", vl))))
    out, lse, out_lo = flash_attention(ql, kl, vl, causal=True, stats=True)
    grads = flash_attention_bwd(ql, kl, vl, out, dl, lse=lse, out_lo=out_lo)
    hold(f"model width {n} rank {r} slice", out, grads, ql, kl, vl, dl)


def _mesh_step_profile(trainer, params, opt, batch, step: int) -> None:
    """Profile one mesh Trainer.step: the device seconds and count of the
    NCCL kernels, the device busy time and the step's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.step(params, opt, batch, step)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end, nccl, by_name = 0.0, float("-inf"), [0, 0.0], {}
    for s0, s1, name in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
        if "nccl" in name.lower():
            nccl[0] += 1
            nccl[1] += (s1 - s0) / 1e6
            by_name[name[:60]] = by_name.get(name[:60], 0.0) + (s1 - s0) / 1e6
    log(f"lm_train_mesh profile of one step: wall {wall:.4f} s, device busy "
        f"{busy / 1e6:.4f} s, {len(spans)} device events; NCCL kernels "
        f"{nccl[0]}, device s {nccl[1]:.6f}: "
        + json.dumps({k: round(v, 6) for k, v in by_name.items()}))


def lm_train_mesh_phase(dev) -> dict:
    """lm_train's model, batch, seed and learning rate trained over a 1 x 1
    NCCL mesh (``Trainer(mesh=..., plan=ExecutionPlan(fsdp_params=True))``):
    MESH_STEPS steps against lm_train's losses, the attention kernels at
    the mesh path's operands and on a model rank's column-slice views, one
    profiled step, then MESH_COMPRESSED_STEPS with gradient compression.
    Returns the launch counts of the MESH_STEPS steps."""
    import gc
    import math
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import (collective_counts,
                                                     reset_collective_counts)
    from repro_torch.distributed.sharding import ExecutionPlan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    tokens = TRAIN_SEQ * TRAIN_BATCH
    single, single_walls = TRAIN_RUN["losses"], TRAIN_RUN["walls"]
    tmp = tempfile.mkdtemp(prefix="lm_train_mesh_")
    init_ranks(0, 1, os.path.join(tmp, "store"), dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        log(f"lm_train_mesh: process group backend {dist.get_backend()}, "
            f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, {mesh}")

        def trainer(**knobs):
            return Trainer(cfg, shape, TrainerConfig(
                ckpt_dir=os.path.join(tmp, "ck"), total_steps=100,
                warmup_steps=1, log_every=1), AdamWConfig(lr=TRAIN_LR),
                mesh=mesh, plan=ExecutionPlan(fsdp_params=True, **knobs),
                device=dev)

        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        log(f"lm_train_mesh: device memory allocated before the phase "
            f"{held / 1e9:.3f} GB")
        torch.cuda.reset_peak_memory_stats()
        t = trainer()
        params, opt = t.init_state()
        losses, walls, totals = [], [], {}
        want = {"flash_attention": 2 * cfg.num_layers,
                "flash_attention_bwd": cfg.num_layers}
        for step in range(MESH_STEPS):
            batch = t.batch(step)
            torch.cuda.synchronize()
            if step == 0:
                cap, undo = capture_attention_bwd()
            reset_launch_counts()
            reset_collective_counts()
            t0 = time.perf_counter()
            try:
                params, opt, m = t.step(params, opt, batch, step)
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
                torch.cuda.synchronize()
            finally:
                if step == 0:
                    undo()
            walls.append(time.perf_counter() - t0)
            counts, coll = launch_counts(), collective_counts()
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            losses.append(loss)
            rel = abs(loss - single[step]) / abs(single[step])
            log(f"lm_train_mesh step {step}: loss {loss:.6f} (single device "
                f"{single[step]:.6f}, relative {rel:.3e}, limit "
                f"{MESH_LOSS_RTOL}), grad norm {gnorm:.6f}, wall "
                f"{walls[-1] * 1e3:.1f} ms ({tokens / walls[-1]:.0f} "
                f"tokens/s); flash_attention {counts['flash_attention']}, "
                f"flash_attention_bwd {counts['flash_attention_bwd']} "
                f"launches; collectives " + json.dumps(coll))
            got = {k: counts[k] for k in want}
            if got != want:
                raise AssertionError(f"lm_train_mesh step {step}: launches "
                                     f"{got}, want {want}")
            if not (math.isfinite(loss) and math.isfinite(gnorm)
                    and rel <= MESH_LOSS_RTOL):
                raise AssertionError(f"lm_train_mesh step {step}: loss "
                                     f"{loss} vs single device "
                                     f"{single[step]}")
        launched("lm_train_mesh", totals, ("flash_attention",
                                           "flash_attention_bwd"))
        warm, swarm = walls[1:], single_walls[1:MESH_STEPS]
        log(f"lm_train_mesh {MESH_STEPS} steps: step wall ms "
            f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}; steps 1-"
            f"{MESH_STEPS - 1} mean {sum(warm) / len(warm) * 1e3:.1f} ms, "
            f"{tokens * len(warm) / sum(warm):.0f} tokens/s (single device, "
            f"the same steps: {sum(swarm) / len(swarm) * 1e3:.1f} ms, "
            f"{tokens * len(swarm) / sum(swarm):.0f} tokens/s); peak device "
            f"memory of the phase {(torch.cuda.max_memory_allocated() - held) / 1e9:.3f} GB "
            f"above the {held / 1e9:.3f} GB held before it, its state's "
            f"initialization included (single device, its steps alone: "
            f"{TRAIN_RUN['peak'] / 1e9:.3f} GB)")
        _mesh_step_profile(t, params, opt, t.batch(MESH_STEPS), MESH_STEPS)
        del params, opt, t, batch
        torch.cuda.empty_cache()
        hold_mesh_attention(cap)
        del cap
        torch.cuda.empty_cache()

        tc = trainer(grad_compression=True)
        params, opt = tc.init_state()
        closs = []
        for step in range(MESH_COMPRESSED_STEPS):
            params, opt, m = tc.step(params, opt, tc.batch(step), step)
            closs.append(float(m["loss"]))
        log(f"lm_train_mesh grad_compression {MESH_COMPRESSED_STEPS} steps: "
            f"losses {', '.join(f'{x:.6f}' for x in closs)} (uncompressed "
            f"{', '.join(f'{x:.6f}' for x in losses[:len(closs)])}, limit "
            f"{MESH_COMPRESSED_RTOL} relative)")
        for x, y in zip(closs, losses):
            if not (math.isfinite(x) and abs(x - y) <= MESH_COMPRESSED_RTOL
                    * abs(y)):
                raise AssertionError(f"lm_train_mesh grad_compression: "
                                     f"losses {closs} vs {losses}")
        del params, opt, tc
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    PHASE_S["lm_train_mesh"] = time.perf_counter() - t_phase
    return totals


def _mixer_cfg(arch: str, layers, pattern):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  block_pattern=pattern or cfg.block_pattern)
    return cfg


def _train_step_profile(tag: str, trainer, params, opt, batch, step: int,
                        wall_unprofiled: float) -> None:
    """Profile one Trainer.step: device seconds by kind, the optimizer's
    kernels (those inside ``adamw_update``) and the Mamba scan's (inside
    ``ScanChunk``'s forward and backward), each annotated for this
    profile, apart from the attention forward and backward kernels, the
    matrix products and the rest; the largest kernels by name, and the
    device's idle share of the profiled step's wall time (which the
    profiler stretches) and of an unprofiled step's (``wall_unprofiled``)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import ssm
    from repro_torch.train import trainer as trainer_mod

    real = (trainer_mod.adamw_update, ssm.ScanChunk.forward,
            ssm.ScanChunk.backward)

    def annotated(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    trainer_mod.adamw_update = annotated("optimizer", real[0])
    ssm.ScanChunk.forward = staticmethod(annotated("mamba_scan", real[1]))
    ssm.ScanChunk.backward = staticmethod(annotated("mamba_scan", real[2]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.step(params, opt, batch, step)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer_mod.adamw_update = real[0]
        ssm.ScanChunk.forward = staticmethod(real[1])
        ssm.ScanChunk.backward = staticmethod(real[2])
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    windows = {k: [(s0, s1) for s0, s1, n in spans if n == k]
               for k in ("optimizer", "mamba_scan")}
    spans = [x for x in spans if x[2] not in windows]
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    split = dict(mamba_scan=0.0, optimizer=0.0, attention_fwd=0.0,
                 attention_bwd=0.0, matmul=0.0, other=0.0)
    by_name: dict = {}
    for s0, s1, name in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (s1 - s0) / 1e6
        inside = [k for k, ws in windows.items()
                  if any(w0 <= s0 and s1 <= w1 for w0, w1 in ws)]
        if inside:
            key = inside[0]
        elif re.search(r"flash_(wgmma|mma|simt)", name):
            key = "attention_fwd"
        elif re.search(r"bwd_(dq|dkdv)_", name):
            # both designs: bwd_{dq,dkdv}_wgmma_kernel (the dQ kernel forms
            # the rows' D itself: no pre-pass, no convert pass) and the
            # first design's bwd_{dq,dkdv}_{mma,simt}_kernel
            key = "attention_bwd"
        elif re.search(r"gemm|xmma|cutlass|nvjet|wgmma|Kernel2", name):
            key = "matmul"
        else:
            key = "other"
        split[key] += (s1 - s0) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log(f"{tag} profile of one step: wall {wall:.4f} s, "
        f"device busy {busy / 1e6:.4f} s, idle share "
        f"{1 - busy / 1e6 / wall:.4f} of the profiled step, "
        f"{max(0.0, 1 - busy / 1e6 / wall_unprofiled):.4f} of an unprofiled "
        f"one ({wall_unprofiled * 1e3:.1f} ms), {len(spans)} device events; "
        f"device s by kind (the scan's and the optimizer's kernels by their "
        f"annotated windows, {len(windows['mamba_scan'])} scan windows): "
        + json.dumps({k: round(v, 6) for k, v in split.items()})
        + "; top kernels (s): "
        + json.dumps({n: round(t, 6) for n, t in top}))


def _train_mixer(dev, tmp: str, arch: str, layers, pattern, b: int, s: int,
                 steps: int, mesh=None, plan=None, profile: bool = False,
                 plain: bool = True, hold_bwd=None) -> dict:
    """``steps`` Trainer.steps of one mixer model (over ``mesh`` under
    ``plan`` when given), gated: launches a step, finite and falling losses,
    loss = ce + 0.01·aux, and (``plain``) loss₀ against the same model on
    the plain attention. With ``hold_bwd`` (a kernel records dict), the
    attention backward of step 0 is captured and held against its plain
    version once the model is freed (``hold_step_attention_bwd``). Returns
    its losses, walls and launch totals."""
    import gc
    import math

    import torch

    from repro_torch.distributed.collectives import (collective_counts,
                                                     reset_collective_counts)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import layers as model_layers
    from repro_torch.models import loss_fn
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.transformer import MOE_AUX_COEF
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
    from repro_torch.train.optimizer import tree_leaves

    cfg = _mixer_cfg(arch, layers, pattern)
    kw = {} if mesh is None else dict(mesh=mesh, plan=plan)
    tag = cfg.name + ("" if mesh is None else f" mesh {plan.moe_impl}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    trainer = Trainer(cfg, ShapeSpec("train", s, b, "train"), TrainerConfig(
        ckpt_dir=os.path.join(tmp, tag.replace(" ", "_")), total_steps=100,
        warmup_steps=1, log_every=1), AdamWConfig(lr=MIXER_LR), device=dev,
        **kw)
    params, opt = trainer.init_state()
    n_params = sum(t.numel() for t in tree_leaves(params))
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves((params, opt))) / 1e9
    n_attn = len(cfg.attn_layers)
    kinds = "".join(cfg.layer_kind(i) for i in range(cfg.num_layers))
    n_moe = sum(cfg.layer_is_moe(i % cfg.pattern_period)
                for i in range(cfg.num_layers)
                if cfg.layer_kind(i) in ("a", "m"))
    log(f"lm_train_mixers {tag}: {cfg.num_layers} layers ({kinds}; {n_moe} "
        f"MoE of {cfg.num_experts} experts top {cfg.experts_per_token}), "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; {n_params} parameters; parameters and optimizer "
        f"state {state_gb:.3f} GB (+ a bf16 gradient a parameter in the "
        f"step); batch {b} x {s}")
    plain_loss = None
    if plain and n_attn:
        real = model_layers.ops.attention
        model_layers.ops.attention = attention_as(
            lambda q, k, v, causal: flash_attention_plain(q, k, v,
                                                          causal=causal))
        try:
            with torch.no_grad():
                plain_loss = float(loss_fn(trainer.cfg, params,
                                           trainer.batch(0))[0])
        finally:
            model_layers.ops.attention = real
    want = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    losses, walls, totals = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    batch = trainer.batch(0)
    for step in range(steps):
        torch.cuda.synchronize()
        capture = hold_bwd is not None and n_attn and step == 0
        if capture:
            cap, undo = capture_attention_bwd()
        reset_launch_counts()
        reset_collective_counts()
        t0 = time.perf_counter()
        try:
            params, opt, m = trainer.step(params, opt, batch, step + 1)
            m = {k: float(v) for k, v in m.items()}
            torch.cuda.synchronize()
        finally:
            if capture:
                undo()
        walls.append(time.perf_counter() - t0)
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        losses.append(m["loss"])
        coll = "" if mesh is None else "; collectives " + json.dumps(
            collective_counts())
        log(f"lm_train_mixers {tag} step {step}: loss {m['loss']:.6f} (ce "
            f"{m['ce']:.6f}, aux {m['aux']:.6f}), grad norm "
            f"{m['grad_norm']:.6f}, wall {walls[-1] * 1e3:.1f} ms "
            f"({b * s / walls[-1]:.0f} tokens/s); flash_attention "
            f"{counts['flash_attention']}, flash_attention_bwd "
            f"{counts['flash_attention_bwd']} launches" + coll)
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"lm_train_mixers {tag} step {step}: "
                                 f"launches {got}, want {want}")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"lm_train_mixers {tag}: metrics {m}")
        total = m["ce"] + MOE_AUX_COEF * m["aux"]
        if abs(m["loss"] - total) > MIXER_LOSS_SUM_RTOL * abs(total):
            raise AssertionError(f"lm_train_mixers {tag}: loss {m['loss']} "
                                 f"is not ce + {MOE_AUX_COEF}·aux = {total}")
        if (m["aux"] > 0.0) != bool(cfg.num_experts):
            raise AssertionError(f"lm_train_mixers {tag}: aux {m['aux']} "
                                 f"with {cfg.num_experts} experts")
    peak = torch.cuda.max_memory_allocated()
    warm = walls[1:] or walls
    line = (f"lm_train_mixers {tag} {steps} steps: losses "
            f"{', '.join(f'{x:.6f}' for x in losses)}; step wall ms "
            f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}, steps 1-"
            f"{steps - 1} mean {sum(warm) / len(warm) * 1e3:.1f} ms, "
            f"{b * s * len(warm) / sum(warm):.0f} tokens/s; peak device "
            f"memory of the steps {peak / 1e9:.3f} GB ({held / 1e9:.3f} GB "
            f"held before the trainer)")
    if plain_loss is not None:
        line += (f"; loss0 on the plain attention {plain_loss:.6f} (|Δ| "
                 f"{abs(losses[0] - plain_loss):.2e}, limit "
                 f"{TRAIN_LOSS_ATOL})")
    log(line)
    if plain_loss is not None and abs(losses[0] - plain_loss) > \
            TRAIN_LOSS_ATOL:
        raise AssertionError(f"lm_train_mixers {tag}: loss0 {losses[0]} on "
                             f"the kernels vs {plain_loss} on the plain "
                             f"attention")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"lm_train_mixers {tag}: the loss did not fall: "
                             f"{losses}")
    if n_attn:
        launched(f"lm_train_mixers {tag}", totals,
                 ("flash_attention", "flash_attention_bwd"))
    if profile:
        _train_step_profile(f"lm_train_mixers {tag}", trainer, params, opt,
                            batch, steps + 1, walls[-1])
    torch.cuda.synchronize()
    del params, opt, trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    if hold_bwd is not None and n_attn:
        hold_step_attention_bwd(cap, hold_bwd, f"lm_train_mixers {tag} step",
                                headline=False)
        del cap
        torch.cuda.empty_cache()
    return dict(losses=losses, walls=walls, totals=totals, peak=peak)


def _agree_on_cpu(dev) -> None:
    """The smoke configs in float32, the loss and every gradient leaf on
    the card against the same computation on the CPU (MIXER_AGREE)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train.optimizer import tree_leaves, tree_map

    for arch, b, s, cut, crowd in MIXER_AGREE:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        if cut:
            cfg = dataclasses.replace(cfg, num_layers=2,
                                      block_pattern=("a", "m"))
        params = init_params(cfg, torch.Generator().manual_seed(0))
        if crowd:
            params["embed"] = params["embed"] + 1.0
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)
                                                  ).astype(np.int32))
                 for k in ("tokens", "labels")}
        out = {}
        for where in ("cpu", dev):
            p = tree_map(lambda t: t.detach().to(where).requires_grad_(True),
                         params)
            loss, m = loss_fn(cfg, p, {k: v.to(where)
                                       for k, v in batch.items()})
            loss.backward()
            out[str(where)] = (float(loss), float(m["aux"]),
                               [t.grad.double().cpu()
                                for t in tree_leaves(p)])
        (lc, ac, gc_), (lg, ag, gg) = out["cpu"], out[str(dev)]
        worst = max(float((g - c).abs().max())
                    / max(float(c.abs().max()), 1e-30)
                    for g, c in zip(gg, gc_))
        rel = abs(lg - lc) / abs(lc)
        log(f"lm_train_mixers agreement {cfg.name}{' cut' if cut else ''} "
            f"{b}x{s}{' crowded' if crowd else ''} (float32): loss card "
            f"{lg:.7f} vs CPU {lc:.7f} (relative {rel:.2e}), aux {ag:.7f} vs "
            f"{ac:.7f}; {len(gg)} gradient leaves, worst max|Δ| "
            f"{worst:.2e} of the leaf's largest (limit {MIXER_AGREE_RTOL})")
        if rel > MIXER_AGREE_RTOL or worst > MIXER_AGREE_RTOL:
            raise AssertionError(f"lm_train_mixers agreement {cfg.name}: "
                                 f"loss {rel:.2e}, gradients {worst:.2e}")


def lm_train_mixers_phase(dev, out: dict) -> dict:
    """The archs with MoE, Mamba and xLSTM layers trained at full width on
    the card (MIXER_TRAIN; jamba's steps profiled once, its attention
    backward held at the step's operands, into ``out``), moonshot over a
    1 x 1 NCCL mesh under tp_ragged and ep against its single-device
    losses, and the smoke configs' loss and gradients on the card against
    the CPU. Returns the launch totals of the single-device steps."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.sharding import ExecutionPlan
    from repro_torch.launch.mesh import init_ranks, make_mesh

    t_phase = time.perf_counter()
    totals, runs = {}, {}
    tmp = tempfile.mkdtemp(prefix="lm_train_mixers_")
    try:
        for arch, layers, pattern, b, s, steps in MIXER_TRAIN:
            first = arch == MIXER_TRAIN[0][0]
            runs[arch] = r = _train_mixer(
                dev, tmp, arch, layers, pattern, b, s, steps, profile=first,
                hold_bwd=out if first else None)
            for k, v in r["totals"].items():
                totals[k] = totals.get(k, 0) + v
        arch, layers, pattern, b, s, steps = next(
            x for x in MIXER_TRAIN if x[0] == MIXER_MESH_ARCH)
        single = runs[arch]["losses"]
        init_ranks(0, 1, os.path.join(tmp, "store"), dev)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), dev)
            for impl in MIXER_MESH_IMPLS:
                got = _train_mixer(
                    dev, tmp, arch, layers, pattern, b, s, steps, mesh=mesh,
                    plan=ExecutionPlan(fsdp_params=True, moe_impl=impl),
                    plain=False)["losses"]
                rels = [abs(x - y) / abs(y) for x, y in zip(got, single)]
                log(f"lm_train_mixers mesh {impl}: losses "
                    f"{', '.join(f'{x:.6f}' for x in got)} against the single "
                    f"device's {', '.join(f'{x:.6f}' for x in single)}: "
                    f"relative {', '.join(f'{x:.2e}' for x in rels)} (limit "
                    f"{MESH_LOSS_RTOL})")
                if max(rels) > MESH_LOSS_RTOL:
                    raise AssertionError(f"lm_train_mixers mesh {impl}: "
                                         f"{got} vs {single}")
        finally:
            dist.destroy_process_group()
        _agree_on_cpu(dev)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    PHASE_S["lm_train_mixers"] = time.perf_counter() - t_phase
    return totals


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--attention", action="store_true",
                    help="only the lm_serve path and the flash_attention "
                         "checks (the kernels line then lists that kernel)")
    ap.add_argument("--mixers", action="store_true",
                    help="only the lm_serve_mixers path (the kernels line "
                         "then lists flash_attention)")
    ap.add_argument("--serve-mesh", action="store_true",
                    help="only the serving_mesh and lm_serve_mesh paths "
                         "(the kernels line then lists entry_stats, "
                         "row_stats and flash_attention)")
    ap.add_argument("--train", action="store_true",
                    help="only the lm_train, lm_train_mesh and "
                         "lm_train_mixers paths and the flash_attention_bwd "
                         "checks (the kernels line then lists that kernel)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels._build import load_kernels

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ops = load_kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s ({len(REPLACES)} CUDA "
        f"kernels, sm_90a)")
    tri_solve_resources(ops)
    bell_spmv_resources(ops)
    tile_resources(ops)
    frontal_resources(ops)
    stream_kernel_resources(ops)
    for d in (128, 64):
        regs, smem, local, stages = ops.flash_attention_info(d)
        log(f"flash_attention bf16 D={d} (TMA + wgmma kernel): {regs} "
            f"registers a thread as compiled (before setmaxnreg), {smem} "
            f"bytes of shared memory a block, {local} bytes of local memory "
            f"(spills) a thread, {stages} stages")

    names = tuple(REPLACES)
    if args.attention:
        names = ("flash_attention",)
        counts = {"flash_attention":
                  lm_serve_phase(dev)["flash_attention"]}
        records = {}
        attention_checks(dev, records)
    elif args.mixers:
        names = ("flash_attention",)
        records = {}
        counts = lm_serve_mixers_phase(dev, records, headline=True)
    elif args.serve_mesh:
        from repro_torch.sparse.dataset import generate_suite

        names = ("entry_stats", "row_stats", "flash_attention")
        records = {}
        engine = train_phase()
        served = list(generate_suite(16, seed=1, size_scale=8))
        counts = serving_mesh_phase(engine, served, dev, records,
                                    headline=True)
        counts.update(flash_attention=lm_serve_mesh_phase(
            dev, records, headline=True)["flash_attention"])
    elif args.train:
        names = ("flash_attention_bwd",)
        records = {}
        counts = lm_train_phase(dev, records)
        lm_train_mesh_phase(dev)
        lm_train_mixers_phase(dev, records)
        attention_bwd_checks(dev, records)
    else:
        counts, records = all_paths(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{key: dict(records[name], launches=counts[name])[key]
                for key in keys} for name in names]
    log(f"total: {time.perf_counter() - t0:.1f} s"
        + "".join(f" ({k} {v:.1f} s)" for k, v in PHASE_S.items()))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def all_paths(dev) -> tuple:
    """Every path, each kernel's checks and the profiles; returns the
    launch counts of the paths and the kernel records."""
    from repro_torch.core.plan import execute_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sparse.dataset import generate_suite, grid3d

    g20 = grid3d(20, 20, 20, "grid3d_20")
    g32 = grid3d(32, 32, 32, "grid3d_32")
    reset_launch_counts()
    plans = main_path([(g20, ["amd", "scotch", "nd", "rcm"]), (g32, ["nd"])],
                      dev)
    launched("solve", launch_counts(), SOLVE_KERNELS)
    reset_launch_counts()
    main_path([(grid3d(n, n, n, f"grid3d_{n}"), list(algs))
               for n, algs in NEW_ORDERINGS.items()], dev)
    launched("solve table2", launch_counts(), SOLVE_KERNELS)

    engine = train_phase()
    served = list(generate_suite(16, seed=1, size_scale=8))
    select_phase(engine, served, dev)
    solve_mats = list(generate_suite(16, seed=1, size_scale=4))
    counts = engine_phase(engine, solve_mats)
    serving_phase(engine, solve_mats, dev)
    mesh_records = {}
    serving_mesh_phase(engine, served, dev, mesh_records, headline=False)
    lifecycle_errs = lifecycle_phase(engine, solve_mats, dev)
    families_phase(served, solve_mats, dev)
    table2_phase(served, dev)
    counts.update({k: v for k, v in per_front_phase(plans, engine, dev).items()
                   if k in TILE_KERNELS})
    counts["flash_attention"] = lm_serve_phase(dev)["flash_attention"]
    lm_serve_mesh_phase(dev, mesh_records, headline=False)
    mixer_records = {}
    lm_serve_mixers_phase(dev, mixer_records, headline=False)
    train_records = {}
    counts["flash_attention_bwd"] = lm_train_phase(
        dev, train_records)["flash_attention_bwd"]
    lm_train_mesh_phase(dev)
    lm_train_mixers_phase(dev, train_records)

    a, plan = plans[-1]
    records = kernel_checks(a, plan, dev)
    records.update(train_records)
    for name, err in lifecycle_errs.items():
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    csr_stats_checks(served, dev, records)
    attention_checks(dev, records)
    for extra in (mixer_records, mesh_records):
        for name, rec in extra.items():
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                               rec["max_abs_err"])
    b = np.random.default_rng(2).standard_normal(a.n)
    spans = profile_call(f"{a.name} {plan.algorithm} k=1 execute_plan",
                         lambda: execute_plan(a, plan, b, device=dev))
    for stem in ("tri_solve", "bell_", "extend_add") + FACTOR_STEMS:
        log(f"profile {a.name} {plan.algorithm} k=1 execute_plan, {stem} "
            f"kernels (s): " + json.dumps(kernel_device_s(spans, stem)))
    log(f"profile {a.name} {plan.algorithm} k=1 execute_plan, host-to-device "
        f"copies: " + json.dumps(copy_events(spans, "HtoD")))
    spans = profile_call(f"{a.name} {plan.algorithm} k=1 execute_plan pallas",
                         lambda: execute_plan(a, plan, b, backend="pallas",
                                              device=dev))
    log(f"profile {a.name} {plan.algorithm} k=1 execute_plan pallas, tile "
        f"kernels (s): " + json.dumps({stem: kernel_device_s(spans, stem)
                                       for stem in TILE_STEMS}))
    profile_call("select_batch (16 served matrices)",
                 lambda: engine.select_batch(served))
    attention_bwd_checks(dev, records)
    return counts, records


if __name__ == "__main__":
    sys.exit(main())
