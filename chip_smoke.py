#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA device and the CUDA
toolkit (``nvcc``), and exits non-zero on any failure.  Phases:

  1. set-up: the card's name and power limit; the CUDA kernels built from
     ``src/repro_torch/kernels/csrc`` into ``build/repro_torch``, with the
     ``ptxas`` lines (registers, spills) of the tensor-core kernels and the
     two scans' backwards; TF32 off for fp32 matrix products and convolutions
     (``allow_tf32`` False, float32 matmul precision "highest", asserted again
     before each plain fp32 GEMM and ``torch.bmm``), so the plain versions
     are exact and no yardstick is itself TF32.
  2. kernels: every kernel held against its plain PyTorch version on the
     card -- the registry's tiny, smoke and full tiers in fp32 (max-abs
     <= 2e-5, the reference's parity tolerance), the attention variants and
     chunk chaining of the reference tests at every head width the kernel is
     built for, the scans off their kernels' tiles (fp32 at 2e-5, bf16 x at
     relative 1e-4) and at the full tier from two threads on two streams at
     once, and the full width of a model the repo configures (relative
     max error <= 1e-4 in fp32, <= 2e-2 in bf16; the attention widths also
     in fp32).  Every bf16 output is also held element by element (see
     BF16_ELEMENT_TOL).  One line per kernel and shape: error, the kernel's
     median device time (``ms``: a spin kernel queued before the start event
     keeps the card busy while the host runs the wrapper, so the events time
     device work only; ``ms_cold``: each call behind a 512 MB write, so L2 is
     cold too), the median time of a call as a caller pays it, host work
     included (``ms_call``, what ``ms`` meant in earlier records), the plain
     version's and one library call's device time (as ``ms``), the bound,
     and the launches made.  Each call must be counted on the route its
     rule (``route``) gives: attention runs on the tensor cores at every
     width -- bf16 on ``wgmma`` (one TF32 product a product, ``tf32``, at
     head width 16), fp32 on ``tf32x3`` (three TF32 products a term, held
     at the fp32 tolerances; on two-block clusters, ``tf32x3_cluster``, at
     256); GEMMs on ``wgmma`` (bf16) and ``tf32x3`` (fp32), save those whose
     strides TMA cannot describe, on warp-level ``mma`` (the GEMM cases
     include E3 C80 D95 F49, whose strides are not even 4-byte aligned in
     bf16), each launch of the ``mma`` route on the parts its rule
     (``csrc/gmm.cuh``, ``split_of``) names.  On
     ``tf32x3`` rows the bound is the function's products at the TF32
     tensor-core peak; ``bound_3x_ms`` gives the same for the design's
     three products a term and ``simt_bound_ms`` the fp32 CUDA-core bound
     (``route_bounds``).  Both attention model widths are timed in fp32 too
     (llama3-8b's hd 128, recurrentgemma-2b's hd 256), beside fp32 SDPA; the
     reduced configs' hd 16 in bf16 (``tf32``) beside bf16 SDPA; and two
     forward cases at Lq != Lk (Lq96 Lk200 hd64 non-causal, Lq200 Lk96
     hd128 causal) in both dtypes, fp32 held at relative 1e-4.  The GEMM is
     timed at grok-1's expert shape in both dtypes, at arctic-480b's prefill
     shape (E128 C80 D7168 F4864) in both, and at grok-1's decode shape (E8
     C2) in bf16.  The selective scan's backward (``selective_scan_bwd``,
     the gradient the ssm family trains through) at falcon-mamba-7b's chunk
     (B1 chunk 256 di 8192 N16) with fp32 and with bf16 x, each output
     within 1e-4 of its plain version's largest element (bf16 dx element by
     element), timed beside the plain version and its bound, one call
     profiled (its two kernels, the walk and the sums across blocks); at
     the forward's ragged shapes and at the edges of the walk's split of a
     chunk in time over a thread-block cluster; every call counted, two
     calls bit-equal, the parts its launch took on each line, and two
     chunks chained equal to one of twice the length.  Set-up prints the
     walk's ``ptxas`` registers, spills and static shared memory and an
     ``occupancy`` line at falcon width (parts, blocks, dynamic shared
     memory, blocks and warps an SM), failing under 16 warps an SM; and
     one ``occupancy moe_gmm`` line a GEMM product that has a plan (the
     ``tf32x3`` gradients and the ``mma`` route) at the model widths, the
     reduced grok-1 step's products and the small cases: the parts of its
     split contraction, blocks, warps an SM, stages, held to the rule's
     properties (``gmm_plan``), one part at the model widths.
  3. broker: ``Hydra(device="cuda")`` with a cloud (CaaS) and an HPC (pilot)
     provider on the card runs a backlog of noop tasks, kernel tasks at the
     registry's full shapes and one 2-rep task per model width, with the
     event and ledger cross-checks on.  Every task must end DONE, the
     ``kernel.exec`` events must reconcile with the broker's counters, and
     each kernel's launch counter must rise by exactly the reps dispatched,
     each on the route ``expected_route`` gives (bf16 on ``wgmma``, fp32
     on ``tf32x3``).
  4. scenario: the reference's acceptance scenario, ``searise_at_scale``
     (1024 FACTS members, 6 training jobs, 4 serve waves of 16 tasks, 4
     providers and an elastic burst pool) with the settings of
     ``searise_kernels``: the serve lane runs the four kernels, 2 reps a
     task, pre-tuned by the model-timer autotuner, with task checkpoints
     every 2 s.  It runs on ``Hydra(device="cuda")`` with chaos and as the
     no-chaos twin, the event and ledger cross-checks on.  Both must hold
     every invariant with no task failed or unresolved, tune each kernel
     once into a pinned ``tune:<kernel>:cuda:`` dataset, and launch each
     kernel exactly as many times as its ``kernel.exec`` events say reps
     ran, every GEMM and every attention launch on ``tf32x3`` (fp32
     payloads).
  5. autotune and FACTS: a wall-timed sweep of each kernel at its full tier
     on the card, whose winner a kernel task must then resolve to under
     ``HYDRA_AUTOTUNE=1``; 64 FACTS workflows of 150000 samples through
     ``WorkflowManager`` on ``Hydra(device="cuda")``, every one done with
     finite, ordered quantiles; and for four instances ``fit`` on the card
     against the CPU (relative 1e-5) and ``project`` on the card from draws
     made on the CPU against the CPU (max-abs 1e-3 mm).
  6. model: the port's serve path (``repro_torch.models``,
     ``launch/serve.py``) on the card.  Card against CPU (one CPU thread a
     check, two checks' CPU sides at once, ``cpu_sides``) at full width in
     fp32 on the same weights (relative max error <= 1e-4 on the logits and
     every cache leaf): recurrentgemma-2b cut to one superblock at a prompt
     of 2176 (past its 2048 window, so the window and the ring buffer
     bite), falcon-mamba-7b cut to 2 layers at 512 (two chunks carry the
     state), llama3-8b cut to 2 layers at 1000 (blocks of 125), each prefill
     launching exactly its kernels (fp32 attention on ``tf32x3`` at
     llama3-8b's head width 128, on ``tf32x3_cluster`` at recurrentgemma-2b's
     256).  falcon-mamba-7b and llama3-8b at full
     width cut to 4 layers in bf16 at a prompt of 4096: finite, 64
     ``selective_scan`` and 4 ``wgmma`` attention launches, warm prefill
     time.  Then ``serve("recurrentgemma-2b",
     reduced=False, batch=4, prompt_len=4096, gen=32)`` in bf16, twice on
     one set of weights: finite logits, exactly 18 ``rglru_scan`` and 8
     ``flash_attention`` launches (all ``wgmma``) a prefill and none in
     decode.  In the first of these prefills, and in the bf16 ones at 4
     layers, every kernel launch is held against its plain version on the
     operands the path gave it (``path_kernels_checked``: relative <= 1e-4
     for fp32 outputs, <= 2e-2 and element by element for bf16).  It prints prefill seconds, decode ms a token, tokens/s, peak
     memory and the kernels' share of a prefill (from a ``torch.profiler``
     trace of one more prefill, and from the two kernels timed alone at the
     serve's shapes).  Last, three ``kind="compute", step_kind="prefill"``
     tasks, one a family, through ``Hydra(device="cuda")``: all DONE, with
     the launches of the reduced configs (head width 16 on ``tf32x3``).
     The moe family: grok-1-314b cut to one layer at a prompt of 512
     in fp32 against the CPU as above (two groups of 256 tokens, so tokens
     drop at capacity factor 1.25; exactly 1 attention and 3 GEMM launches,
     all ``tf32x3``); grok-1-314b cut to 2 layers and arctic-480b cut to 1
     in bf16 at 4096 (6 and 3 GEMMs, 2 and 1 attention, all ``wgmma``, each
     held against its plain version); ``serve("grok-1-314b", reduced=False,
     params=<2 layers>, batch=4, prompt_len=4096, gen=32)`` in bf16 twice
     (prefill 6 GEMM and 2 attention launches, decode 6 GEMMs a step, all
     ``wgmma``; prefill s, decode ms a token, peak memory, and a profiled
     prefill and decode step); and prefill tasks of both moe configs among
     the compute tasks (6 GEMMs each on ``tf32x3``).
  7. train: the port's train path (``launch/train.py`` -> ``train/step.py``
     -> ``Model.loss`` under remat -> the kernels as autograd Functions ->
     their backward kernels -> ``optim/adamw.py``) on the card.  First the
     two backward kernels against their plain versions (fp32 relative
     <= 1e-4; bf16 element by element, rtol = atol = 2e-2 with atol against
     the largest element) at llama3-8b's and recurrentgemma-2b's attention
     widths in bf16, head width 16 in fp32, an Lq != Lk non-causal case in
     fp32, recurrentgemma-2b's hd 256 in fp32 (``tf32x3_cluster``) and hd
     16 in bf16 (``tf32``), and
     the RG-LRU backward at B1 L4096 dr2560 (log_a in [-0.1, 0], so the
     carries between segments matter; one kernel a call, by the profiler),
     and the GEMM backward (dx and dw on the forward's route) at
     grok-1's and arctic-480b's expert shapes in both dtypes, timed beside
     ``torch.bmm`` for the same two products, and at GMM_CASES in both, each timed
     (warm and cold) beside its plain version, SDPA's autograd backward
     (attention; timed only) and its bound.  Each attention case must take
     the route the rule gives it.  It is timed as the
     train step calls it, with the o and LSE of the forward kernel (whose o
     must equal, bit for bit, its o without LSE, and whose LSE must be
     within 1e-5 of the plain LSE), and also without LSE; each case off
     ``wgmma`` is profiled once and must run its route's kernels and no
     other (no ``bwd_pre``, the preprocess for a caller without LSE).  Then ``train("recurrentgemma-2b",
     reduced=False, steps=3, seq_len=4096, global_batch=1)`` in bf16: every
     backward launch of its first step held against its plain version on
     its own operands (the plain attention backward computes its own LSE,
     so the forward's is checked too), and, after the run's launches are
     read, the first RG-LRU backward call's operands once more with log_a
     redrawn in [-0.1, 0] (at init log_a is -17 to -36, a_t underflows and
     the path's own calls carry nothing from step to step, so this is the
     train path's check of the carries), finite losses, per step 16 / 36
     forward launches (attention / rglru_scan, twice 8 / 18 under
     remat="dots") and 8 / 18 backward launches, every attention backward
     launch on ``wgmma``, and every parameter leaf's gradient nonzero (the
     kernels carry gradients back).  One more step under torch.profiler
     must show device time under every backward kernel's symbols.
     llama3-8b at full width cut to 2 layers trains 2 steps at B2 x 2048
     the same way, and falcon-mamba-7b at full width cut to 8 of its 64
     layers 2 steps at B1 x 4096 with AdamW (per step 256 ``selective_scan``
     and 128 ``selective_scan_bwd`` launches, the first 16 backward calls held
     against the plain version, every gradient leaf nonzero; one more step
     profiled: idle share and busy time by kernel); llama3-8b cut to 1 layer
     (B1 x 256, fp32) gives every gradient leaf on the card within 1e-4 of
     the CPU's (one thread), its forward handing its LSE to the backward; and
     ``kind="compute"`` train tasks on ``Hydra(device="cuda")``:
     3 llama3-8b, 3 recurrentgemma-2b, 3 falcon-mamba-7b and 3 grok-1-314b
     tasks DONE with finite metrics and their backward launches (every moe
     and ssm step's gradient leaves, the router's and the scan's included,
     nonzero); falcon-mamba-7b cut to one layer (B1 x 512 fp32, two chunks)
     gives every gradient leaf on the card within 1e-4 of the CPU's.  The
     moe family: grok-1-314b cut to one layer in
     fp32 gives every gradient leaf on the card within 1e-4 of the CPU's
     (B1 x 128; the host must hold the CPU side, or the line says it could
     not); and one bf16 loss and its gradients at full width, one layer,
     B1 x 4096 (no optimizer state: AdamW's would not fit one card), with
     exactly 6 GEMM and 2 attention launches (remat="dots" runs them again
     in the backward) and 3 GEMM and 1 attention backward launches, all on
     ``wgmma``, then the same pass profiled: the GEMMs' share of the busy
     time and the idle share.  The fp32 backward launches (the
     card-vs-CPU gradients and the tasks) must all take the ``tf32x3``
     route (head width 128 and the reduced 16).  ``device_profile`` counts
     the traces that lacked their expected kernel, and whether the raw
     Kineto events held it (ROADMAP.md fault 3.8).  The backward kernels'
     trace checks (the attention backward's routes off ``wgmma`` and the
     RG-LRU backward, ``backward_traces``) run in a process of their own
     (``chip_smoke.py --trace-checks``), started before the model phase,
     and feed the train phase's lines; what ``device_profile`` counted of
     them is its ``trace_checks`` line.  The encoder-decoder
     and vision families: the attention backward at CROSS_CASES' shapes
     (bf16 ``wgmma`` at both model shapes, fp32 ``tf32x3`` at Lk 8);
     seamless-m4t-medium at full size, B1 x 4096 tokens and 4096 frames,
     2 steps with AdamW (72 attention and 36 backward launches a step on
     ``wgmma``, the first step's backward launches held against the plain
     version, every gradient leaf nonzero); llama-3.2-vision-11b at full
     width cut to one superblock, B1 x 4096, 2 steps (10 and 5); ``train_grads`` of seamless-m4t-medium (one encoder
     and one decoder layer over 512 frames) and of llama-3.2-vision-11b (one
     superblock), B1 x 256 and B1 x 128, card against CPU within GRAD_TOL;
     and 3 train
     tasks of each among the compute train tasks, every step of the moe,
     audio and vlm families with every gradient leaf nonzero.
  8. sharded: the port's sharding (``parallel/sharding.py``,
     ``launch/mesh.py``, ``train/step.py``, ``optim/compression.py``) on a
     one-rank NCCL world (a FileStore rendezvous in a temporary directory,
     destroyed after; a world that NCCL cannot start fails the phase).
     llama3-8b at full width cut to 2 layers, bf16, B2 x 2048,
     remat="dots", 2 steps from one init and one batch stream under four
     setups: the plain step, the sharded step under "tp" and "fsdp_tp" on the
     (1, 1) mesh (gradients averaged by an NCCL all-reduce, AdamW on the
     ZeRO-1 slices), and the int8 compressed step (``all_to_all_single`` and
     ``all_gather`` over NCCL).  The sharded losses within 1e-3 relative of
     the plain step's (``bit_equal`` says whether they are equal), the
     compressed step's first loss equal to the plain one and its second
     within 2e-2; each line gives the step seconds, peak memory and a step's
     attention launches forward and backward by route (4 and 2, all
     ``wgmma``).  remat="collectives" at the same shape (``sharded_remat``:
     the same launches, the backward recomputing each layer's attention).
     The flash-decode decode step (llama3-8b 2 layers, B4, a cache of 4096,
     prompt 2048, bf16) under tp with ``flash_decode``: logits within 2e-2
     relative of the plain decode attention's, both steps timed.  Then the
     four examples (``repro_torch/examples``) on the card, each ending in
     ``OK``: one ``example`` line each with its launches per kernel and route
     (serve_lm's three reduced archs reach the attention and both scans;
     train_lm's fp32 100M llama, 200 steps, the attention and its backward
     on ``tf32x3``; quickstart's train task the attention).
  9. tp: tensor parallelism (``parallel/tensor.py``) on a (1, 2) mesh of two
     gloo ranks in processes of their own on the one card (NCCL refuses two
     ranks on one GPU; gloo carries the collectives through host memory, so
     the times show the path, not NVLink): first a probe of gloo's
     all_reduce, all_gather, broadcast and reduce_scatter on CUDA tensors,
     then
     llama3-8b (2 layers) trained 2 steps under "tp", "tp_sp", "fsdp_tp_sp"
     and "fsdp", and recurrentgemma-2b (8 of 26 layers), falcon-mamba-7b
     (2 layers, under
     "tp" and "tp_sp"), arctic-480b (1 layer) and llama3-8b (2 layers, B4 x
     2048, and with one KV head under ``flash_decode``) prefilled and then
     decoded 4 steps on each rank's own cache (fed one rank's greedy
     tokens), and in bf16 the compressed step on the train case, each in bf16 and
     again in fp32, held against this process's one-rank run of the same
     weights and batch (``TP_*``: in fp32 the losses, every weight leaf's
     update and the logits at tight bounds, the greedy tokens equal; in
     bf16 each leaf's update and the logits against what a one-bf16-step
     nudge of the weights moves them), each kernel's first call on each
     rank held against its plain version at the rank's local shapes, the
     kernels' launches there on their routes, a rank's seconds, peak memory
     and collective bytes by op, a rank's decode ms a token, moe_gmm's first
     decode call against its plain version at the rank's experts, and the
     least free memory of the card while the ranks ran; then four gloo
     ranks on a (2, 2) mesh under "serve_2dtp" (``SERVE2D_*``): the
     llama3-8b case prefilled and decoded, held the same way, with no
     parameter gathered.  fsdp: a layer at a time over "data" on a (2, 1)
     mesh of two gloo ranks (``FSDP_*``): llama3-8b at 8 layers, B2 x
     2048, bf16, two AdamW steps under "fsdp_tp" and "tp" (ZeRO-1), held
     against one rank as the tp phase holds its train case, each rank's
     peak memory against the port's dry run of the same step on an
     abstract (2, 1) mesh (argument plus temp bytes; the peak at most 10%
     over it), collective bytes and calls by op.  ``python3 chip_smoke.py
     --fsdp-peak SRC`` runs that world alone on the tree at SRC.  dryrun:
     ``python -m repro_torch.launch.dryrun`` on two production cells, a
     subprocess each, started before the tp phase and running beside the
     card's two phases (host work at data-sheet figures).
  10. report: the card line, one JSON line of the kernels (route, source, the
     TPU kernel each replaces, launches in phase 3 in total and by kernel
     route, in each scenario twin and in one full-size serve prefill
     (``model_launches``; the GEMM's in the grok-1 serve prefill,
     ``moe_serve_launches``), model-width error and times, cold too, beside
     the roofline bound; the four backward kernels with their launches in
     the recurrentgemma-2b train run (the GEMM backward's in grok-1's bf16
     gradient pass, the selective scan's in falcon-mamba-7b's train run),
     the attention backward's also by route; a step's launches in the
     sharded setups, each example's, and rank 0's in the tp phase,
     ``tp_launches_rank0``, of which its decode steps' ``tp_decode_launches_rank0``),
     and the device line last.

Each phase prints its wall seconds.
"""
import contextlib
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TIER_TOL = 2e-5  # max-abs, the reference's parity tolerance (tests/test_kernels_parity.py:23)
WIDTH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # relative max error at the model widths
# every bf16 output, element by element: |got - want| <= rtol * |want| + atol.
# Kernel and plain version both compute in fp32 and round once to bf16, so
# they differ by at most one rounding step (2^-7 of the value) plus fp32
# noise; a row the kernel got wrong fails here even where the outputs are
# small beside the largest one, which the max-relative check cannot see.
BF16_ELEMENT_TOL = (1e-2, 1e-3)

# (kernel, model config the width comes from, payload shape, dtype)
MODEL_WIDTHS = [
    ("flash_attention", "llama3_8b", {"B": 1, "H": 32, "KV": 8, "L": 4096, "hd": 128, "causal": True, "window": None}, "bfloat16"),
    ("flash_attention", "recurrentgemma_2b", {"B": 1, "H": 10, "KV": 1, "L": 4096, "hd": 256, "causal": True, "window": 2048}, "bfloat16"),
    ("selective_scan", "falcon_mamba_7b", {"B": 1, "chunk": 256, "di": 8192, "N": 16}, "float32"),
    ("rglru_scan", "recurrentgemma_2b", {"B": 2, "L": 4096, "dr": 2560}, "float32"),
    ("moe_gmm", "grok_1_314b", {"E": 8, "C": 1280, "D": 6144, "F": 32768}, "bfloat16"),
    # the same expert shape in fp32, on the tensor cores' tf32x3 route
    ("moe_gmm", "grok_1_314b", {"E": 8, "C": 1280, "D": 6144, "F": 32768}, "float32"),
    # arctic-480b's prefill of 4096 tokens (groups of 256: 16 x 5 rows an
    # expert, fewer than a 128-row tile), bound by its 9.2 GB of weights
    ("moe_gmm", "arctic_480b", {"E": 128, "C": 80, "D": 7168, "F": 4864}, "bfloat16"),
    ("moe_gmm", "arctic_480b", {"E": 128, "C": 80, "D": 7168, "F": 4864}, "float32"),
    # grok-1-314b's decode step at batch 4: 2 rows an expert, every expert's weights read
    ("moe_gmm", "grok_1_314b_decode", {"E": 8, "C": 2, "D": 6144, "F": 32768}, "bfloat16"),
]

KERNEL_INFO = {
    "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:119"),
    "selective_scan": ("cuda", "src/repro_torch/kernels/csrc/selective_scan.cu", "src/repro/kernels/selective_scan.py:65"),
    "rglru_scan": ("cuda", "src/repro_torch/kernels/csrc/rglru_scan.cu", "src/repro/kernels/rglru_scan.py:52"),
    "moe_gmm": ("cuda", "src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:60"),
}

# attention variants of tests/test_kernels.py:17-56 and tests/test_kernels_parity.py:65-72
ATTN_VARIANTS = [
    ({"B": 1, "H": 4, "KV": 4, "L": 128, "hd": 64, "causal": True, "window": None}, "mha"),
    ({"B": 2, "H": 8, "KV": 2, "L": 256, "hd": 64, "causal": True, "window": None}, "gqa"),
    ({"B": 1, "H": 4, "KV": 1, "L": 128, "hd": 32, "causal": True, "window": None}, "mqa"),
    ({"B": 1, "H": 2, "KV": 2, "L": 192, "hd": 64, "causal": True, "window": None}, "non_pow2"),
    ({"B": 1, "H": 2, "KV": 1, "L": 256, "hd": 64, "causal": True, "window": 32}, "window32"),
    ({"B": 1, "H": 2, "KV": 1, "L": 256, "hd": 64, "causal": True, "window": 128}, "window128"),
    ({"B": 1, "H": 2, "KV": 2, "L": 128, "hd": 64, "causal": False, "window": None}, "non_causal"),
    ({"B": 1, "H": 4, "KV": 4, "L": 128, "hd": 32, "causal": False, "window": None}, "mha_full"),
    ({"B": 1, "H": 4, "KV": 2, "L": 128, "hd": 32, "causal": True, "window": 64}, "gqa_windowed"),
    # the head widths of the model widths below (llama3-8b 128, recurrentgemma-2b 256)
    ({"B": 1, "H": 8, "KV": 2, "L": 256, "hd": 128, "causal": True, "window": None}, "gqa_hd128"),
    ({"B": 1, "H": 2, "KV": 2, "L": 192, "hd": 128, "causal": False, "window": None}, "non_causal_hd128"),
    ({"B": 1, "H": 4, "KV": 1, "L": 256, "hd": 256, "causal": True, "window": 64}, "mqa_windowed_hd256"),
    ({"B": 1, "H": 2, "KV": 2, "L": 192, "hd": 256, "causal": False, "window": None}, "non_causal_hd256"),
    # a length that is not a multiple of the 128-row q tile, windowed: TMA
    # clips the last K/V tiles at the edge of each head
    ({"B": 1, "H": 4, "KV": 2, "L": 320, "hd": 128, "causal": True, "window": 100}, "ragged_windowed_hd128"),
    ({"B": 1, "H": 4, "KV": 1, "L": 320, "hd": 256, "causal": True, "window": 100}, "ragged_windowed_hd256"),
]

# head width 16, the reduced model configs' width: fp32 on tf32x3, bf16 on
# tf32 (one TF32 product a product; the wgmma kernel starts at 32)
HD16_CASES = [
    ({"B": 2, "H": 4, "KV": 2, "L": L, "hd": 16, "causal": True, "window": w}, f"hd16_L{L}_{'window16' if w else 'causal'}")
    for L in (16, 128) for w in (None, 16)
]
# the bf16 hd 16 forward timed: the reduced configs' attention as the
# backward's case below (B2 H4 KV2 L128, window 16)
HD16_BF16_TIMED = ({"B": 2, "H": 4, "KV": 2, "L": 128, "hd": 16, "causal": True, "window": 16}, "hd16_reduced_bf16")

# GEMMs off the tile grid, in both dtypes: C, D and F ragged (TMA clips per
# expert; bf16 w read through the transpose bit, fp32 w transposed into the
# tf32x3 kernel's register fragments); F = 100, whose 200-byte bf16 row
# stride TMA cannot describe, so the rule sends bf16 to the mma kernel (its
# 400-byte fp32 rows take tf32x3); F = 50, on mma in both dtypes; and D 95
# F 49, on mma in both, whose bf16 rows are not even 4-byte aligned (the
# values staged through registers)
GMM_CASES = [
    ({"E": 4, "C": 64, "D": 128, "F": 256}, "sweep"),
    ({"E": 3, "C": 80, "D": 96, "F": 200}, "ragged"),
    ({"E": 3, "C": 80, "D": 96, "F": 100}, "ragged_f100"),
    ({"E": 3, "C": 80, "D": 96, "F": 50}, "ragged_f50"),
    ({"E": 3, "C": 80, "D": 95, "F": 49}, "odd_d95_f49"),
]

# the scans off their kernels' tiles: di 50 (no multiple of 32 channels or
# of four floats), di 45 in bf16 (rows start on odd 2-byte offsets), chunk
# 100 and L 300 (no multiple of the 64-step tiles or the 256-step
# segments), and bf16 x at the falcon-mamba chunk; fp32 at TIER_TOL, bf16 x
# at relative 1e-4 (outputs are fp32)
SCAN_CASES = [
    ("selective_scan", {"B": 2, "chunk": 100, "di": 50, "N": 4}, "float32", "ragged"),
    ("selective_scan", {"B": 2, "chunk": 100, "di": 50, "N": 4}, "bfloat16", "ragged_bf16x"),
    ("selective_scan", {"B": 1, "chunk": 40, "di": 45, "N": 8}, "bfloat16", "odd_bf16x"),
    ("selective_scan", {"B": 1, "chunk": 256, "di": 1536, "N": 16}, "bfloat16", "chunk256_bf16x"),
    ("rglru_scan", {"B": 2, "L": 300, "dr": 50}, "float32", "ragged"),
]
SCAN_BF16X_TOL = 1e-4

# the kernels with a tensor-core and a CUDA-core route
ROUTED = ("flash_attention", "moe_gmm")

FLUSH_BYTES = 512 << 20  # more than the 50 MB L2, and long enough to hide a launch
TF32_OPS_PER_S = 495e12  # the H100 SXM's dense TF32 tensor-core peak at 700 W (NVIDIA's data sheet)
X3_ROUTES = ("tf32x3", "tf32x3_cluster")  # fp32 on three TF32 products a product


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


_SPIN_CYCLES_PER_S = []  # the card's clock as torch.cuda._sleep counts it, measured once


def spin_cycles(torch, seconds: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that keep the card busy ``seconds``."""
    if not _SPIN_CYCLES_PER_S:
        n = 10_000_000
        torch.cuda._sleep(1000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(n)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_S.append(n / (start.elapsed_time(end) * 1e-3))
    return int(seconds * _SPIN_CYCLES_PER_S[0])


def _time_reps(torch, fn, budget_s: float, max_reps: int, spin: bool) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # the host's part of a call: checks, lookups, allocation, enqueue
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    reps = max(3, min(max_reps, int(budget_s / max(once, 1e-6))))
    cycles = spin_cycles(torch, 2 * host_s + 50e-6) if spin else 0
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def median_ms(torch, fn, budget_s: float = 0.5, max_reps: int = 20) -> float:
    """Median device time of one call with CUDA events, after one warm-up
    call: a spin kernel (``torch.cuda._sleep``, twice the call's host time
    and 50 us more) queued before the start event keeps the card busy while
    the host runs the call's Python and enqueues its kernels, so the events
    time the device's work only.  (A call that enqueues more kernels than
    the launch queue holds, as the plain scans' Python loops do, still
    waits on the host.)"""
    return _time_reps(torch, fn, budget_s, max_reps, spin=True)


def call_ms(torch, fn, budget_s: float = 0.5, max_reps: int = 20) -> float:
    """Median time of one call as a caller pays it, with CUDA events and the
    card idle before it: the host's work before the first launch included."""
    return _time_reps(torch, fn, budget_s, max_reps, spin=False)


def cold_ms(torch, fn, flush, reps: int = 20) -> float:
    """Median time of one call behind a write of ``flush`` (past L2) on the
    same stream: the card is busy with the write while the host enqueues the
    call, so the events time the kernel from a cold L2 and not the host."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def route_bounds(flops: float, nbytes: float, dtype: str, route) -> dict:
    """The least time of a call of ``flops`` on ``nbytes`` on the H100's
    data-sheet peaks (the port keeps them with its cost model,
    kernels/autotune.py): at the operands' type's rate, or, for fp32 on
    ``tf32x3`` and ``tf32x3_cluster``, at the tensor cores' TF32 rate, which
    no design on the tensor cores can beat.  Two more figures there, not
    the bound: ``bound_3x_ms``, the same for the three TF32 products a
    product the design does, and ``simt_bound_ms``, the fp32 CUDA cores'
    rate (a CUDA-core kernel's)."""
    from repro_torch.kernels.autotune import HBM_BYTES_PER_S, PEAK_OPS_PER_S

    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (TF32_OPS_PER_S if route in X3_ROUTES else PEAK_OPS_PER_S[dtype])
    row = {"bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if route in X3_ROUTES:
        row["bound_3x_ms"] = 1e3 * max(3 * t_ops, t_bytes)
        row["simt_bound_ms"] = 1e3 * max(flops / PEAK_OPS_PER_S["float32"], t_bytes)
    return row


def assert_fp32_exact(torch) -> None:
    """The plain fp32 GEMM and torch.bmm must run in full fp32: with TF32 on
    the yardstick would itself be a TF32 product."""
    if torch.backends.cuda.matmul.allow_tf32 is not False or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError(
            f"TF32 is on for fp32 matrix products (allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
            f"precision={torch.get_float32_matmul_precision()})"
        )


def library_call(torch, name: str, shape: dict, args: tuple):
    """One PyTorch call computing the same function (a yardstick the port
    never calls), or None where PyTorch has none."""
    import torch.nn.functional as F

    if name == "flash_attention":
        q, k, v = args
        window = shape.get("window")
        if window is None:
            return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=shape["causal"], enable_gqa=True)
        L = shape["L"]
        pos = torch.arange(L, device=q.device)
        mask = (pos[None, :] <= pos[:, None] if shape["causal"] else torch.ones(L, L, dtype=torch.bool, device=q.device))
        mask = mask & ((pos[:, None] - pos[None, :]) < window)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
    if name == "moe_gmm":
        x, w = args
        return lambda: torch.bmm(x, w)
    return None


def expected_route(name: str, shape: dict, dtype: str):
    """The route a call must take: attention bf16 on ``wgmma`` from head
    width 32 and on ``tf32`` at 16, fp32 on ``tf32x3`` up to 128 and on
    ``tf32x3_cluster`` at 256; GEMMs on the tensor cores where TMA can
    describe the strides (D and F a multiple of 16 bytes), bf16 on
    ``wgmma`` and fp32 on ``tf32x3``, else on warp-level ``mma``."""
    if name not in ROUTED:
        return None
    if name == "flash_attention":
        if dtype == "bfloat16":
            return "wgmma" if shape["hd"] >= 32 else "tf32"
        return "tf32x3" if shape["hd"] <= 128 else "tf32x3_cluster"
    item = 2 if dtype == "bfloat16" else 4
    if shape["D"] * item % 16 or shape["F"] * item % 16:
        return "mma"
    return "wgmma" if dtype == "bfloat16" else "tf32x3"


def gmm_plan(torch, product: str, shape: dict, dtype: str, dev, x=None, w=None, dy=None) -> dict | None:
    """The launch of one GEMM product (``"forward"``, ``"dx"``, ``"dw"``)
    as the card describes it (``moe_gmm.launch_config``, for the operands
    given, by the rule in ``csrc/gmm.cuh``), held to the rule's properties
    on the card's own residency table: at most 8 parts, each at least one
    stage; a split only where all its clusters are resident at once and it
    takes ``min_saved`` stages or more off a block's walk; and no larger
    split with a shorter walk that would qualify.  Raises where one fails.
    None where the route has no plan (``wgmma``, the ``tf32x3`` forward)."""
    from repro_torch.kernels import moe_gmm as gmm

    E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
    cfg = gmm.launch_config(product, E, C, D, F, getattr(torch, dtype), dev, x=x, w=w, dy=dy)
    if cfg is None:
        return None
    parts, n_k, spp, res, saved = cfg["parts"], cfg["stages"], cfg["stages_per_part"], cfg["resident"], cfg["min_saved"]
    tiles = cfg["blocks"] // parts
    qualifies = lambda p: tiles <= res[p] and n_k - -(-n_k // p) >= saved
    faults = []
    if not (1 <= parts <= gmm.MAX_PARTS and (parts - 1) * spp < n_k <= parts * spp):
        faults.append("parts do not cover the walk")
    if parts > 1 and not qualifies(parts):
        faults.append("a split that is not resident or saves too little")
    if any(qualifies(p) for p in range(parts + 1, min(n_k, gmm.MAX_PARTS) + 1) if -(-n_k // p) < spp):
        faults.append("a larger split qualifies")
    if faults:
        raise AssertionError(f"moe_gmm {product} {shape} {dtype}: the card launches {cfg}: {'; '.join(faults)}")
    return cfg


# the GEMM shapes the occupancy lines plan: the model widths (one part: the
# tiles fill the card) and the reduced grok-1 step's up and down products
GMM_PLAN_WIDTHS = [
    ({"E": 8, "C": 1280, "D": 6144, "F": 32768}, "grok_1_314b"),
    ({"E": 128, "C": 80, "D": 7168, "F": 4864}, "arctic_480b"),
    ({"E": 4, "C": 32, "D": 64, "F": 128}, "grok_1_reduced_up"),
    ({"E": 4, "C": 32, "D": 128, "F": 64}, "grok_1_reduced_down"),
]


def print_gmm_occupancy(torch, dev) -> None:
    """One ``occupancy`` line a GEMM product with a plan (the ``tf32x3``
    gradients and the ``mma`` route) at GMM_PLAN_WIDTHS, GMM_CASES and
    BWD_GMM_EDGE_CASES in both dtypes: its parts, blocks, threads, shared
    memory, blocks and warps an SM, resident clusters, stages and stages a
    part, each held to the rule (``gmm_plan``); at the model widths
    every product takes one part."""
    for shape, label in GMM_PLAN_WIDTHS + GMM_CASES + BWD_GMM_EDGE_CASES:
        for dtype in ("float32", "bfloat16"):
            for product in ("forward", "dx", "dw"):
                cfg = gmm_plan(torch, product, shape, dtype, dev)
                if cfg is None:
                    continue
                if label in ("grok_1_314b", "arctic_480b") and cfg["parts"] != 1:
                    raise AssertionError(f"moe_gmm {product} {label} {dtype}: {cfg['parts']} parts at a model width, want 1")
                print(f"occupancy moe_gmm case={label} dtype={dtype} product={product} "
                      + " ".join(f"{k}={v}" for k, v in cfg.items()), flush=True)


def all_on(route: str, n: int) -> dict:
    """The attention's launch counts by route when all ``n`` took ``route``."""
    from repro_torch.kernels import flash_attention as fa

    return {r: n if r == route else 0 for r in fa.ROUTES}


def check_bf16_elements(got, want, label):
    """Raises where a bf16 output is off its plain version by more than
    BF16_ELEMENT_TOL, element by element."""
    rtol, atol = BF16_ELEMENT_TOL
    gf, wf = got.float(), want.float()
    n_over = int(((gf - wf).abs() > rtol * wf.abs() + atol).sum())
    if n_over:
        raise AssertionError(f"{label}: {n_over} of {got.numel()} elements over rtol {rtol:g} + atol {atol:g}")


def check_kernel(torch, kreg, ops, name, shape, dtype, seed, tol, relative, label, dev, timed=True, config=None, flush=None,
                 cold_reps=20):
    """Kernel vs plain version on the card; raises past ``tol`` or if the
    call took another route than ``expected_route``."""
    kdef = kreg.get_kernel(name)
    config = config or kdef.defaults(shape)
    args = kdef.make_args(shape, dtype, seed, dev)
    before = ops.launch_counts()[name]
    routes_before = ops.route_launch_counts().get(name)
    got = as_tuple(kdef.call(shape, args, config))
    torch.cuda.synchronize()
    route = expected_route(name, shape, dtype)
    if route is not None:
        took = {r: n - routes_before[r] for r, n in ops.route_launch_counts()[name].items()}
        if took != {r: int(r == route) for r in took}:
            raise AssertionError(f"{name} {label}: launches by route {took}, want one on {route}")
    plan = None
    if name == "moe_gmm":
        assert_fp32_exact(torch)
        plan = gmm_plan(torch, "forward", shape, dtype, dev, x=args[0], w=args[1])
    want = as_tuple(kdef.ref(shape, args))
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or g.device != w.device:
            raise AssertionError(f"{name} {label}: kernel gave {g.shape} {g.dtype} on {g.device}, plain {w.shape} {w.dtype}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {label}: kernel output is not finite")
        if g.dtype == torch.bfloat16:
            check_bf16_elements(g, w, f"{name} {label}")
    err = kreg.max_abs_err(got, want)
    scale = max(float(w.float().abs().max()) for w in want) if relative else 1.0
    if not err / scale <= tol:
        raise AssertionError(f"{name} {label}: error {err / scale:.3e} over tolerance {tol:g}")
    row = {"kernel": name, "case": label, "dtype": dtype, "route": route, "max_abs_err": err, "rel_err": err / scale if relative else None}
    if plan is not None:
        row["parts"] = plan["parts"]
    if timed:
        call = lambda: kdef.call(shape, args, config)
        row["ms"] = median_ms(torch, call)
        row["ms_cold"] = cold_ms(torch, call, flush, reps=cold_reps)
        row["ms_call"] = call_ms(torch, call)
        if name == "moe_gmm":
            assert_fp32_exact(torch)
        row["plain_ms"] = median_ms(torch, lambda: kdef.ref(shape, args), max_reps=5)
        lib = library_call(torch, name, shape, args)
        row["library_ms"] = median_ms(torch, lib) if lib is not None else None
        cost = kdef.cost(shape, dtype)
        row.update(route_bounds(cost.flops, cost.hbm_bytes, dtype, route))
    row["launches"] = ops.launch_counts()[name] - before
    print("kernel " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    return row


def check_chunk_chaining(torch, ops, dev):
    """Two chunks chained through h0 equal one double-length chunk
    (tests/test_kernels.py:73), on the kernel."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, ck, di, N = 1, 16, 64, 8
    x = torch.randn(B, 2 * ck, di, generator=g, device=dev)
    dt = torch.rand(B, 2 * ck, di, generator=g, device=dev) * 0.099 + 0.001
    bm = torch.randn(B, 2 * ck, N, generator=g, device=dev)
    cm = torch.randn(B, 2 * ck, N, generator=g, device=dev)
    a = -(torch.rand(di, N, generator=g, device=dev) * 1.5 + 0.5)
    h0 = torch.zeros(B, di, N, device=dev)
    y_full, h_full = ops.selective_scan_chunk(x, dt, bm, cm, a, h0, block_d=32)

    def half(t, s):
        return t[:, s].contiguous()

    first, second = slice(0, ck), slice(ck, 2 * ck)
    _, h1 = ops.selective_scan_chunk(half(x, first), half(dt, first), half(bm, first), half(cm, first), a, h0, block_d=32)
    y2, h2 = ops.selective_scan_chunk(half(x, second), half(dt, second), half(bm, second), half(cm, second), a, h1, block_d=32)
    err = max(float((y_full[:, second] - y2).abs().max()), float((h_full - h2).abs().max()))
    if not err <= 1e-5:
        raise AssertionError(f"selective_scan chunk chaining: error {err:.3e} over 1e-5")
    print(f"kernel kernel=selective_scan case=chunk_chaining max_abs_err={err}", flush=True)


def check_concurrent(torch, kreg, ops, dev, reps: int = 8):
    """Both scans' full tier from two threads at once, each on its own
    stream, as the broker's manager threads launch: every call has its own
    scratch, so each thread gets its own answer."""
    for name in ("rglru_scan", "selective_scan"):
        kdef = kreg.get_kernel(name)
        shape = dict(kdef.full_shape)
        args = [kdef.make_args(shape, "float32", seed, dev) for seed in (21, 22)]
        streams = [torch.cuda.Stream(dev) for _ in args]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(dev))
        outs = [[] for _ in args]
        start = threading.Barrier(len(args))

        def work(i):
            with torch.cuda.stream(streams[i]):
                start.wait()
                for _ in range(reps):
                    outs[i].append(kdef.call(shape, args[i], kdef.defaults(shape)))
            streams[i].synchronize()

        before = ops.launch_counts()[name]
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(args))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"{name} two_threads: a thread did not finish in 120 s")
        torch.cuda.synchronize()
        launches = ops.launch_counts()[name] - before
        if launches != len(args) * reps or any(len(o) != reps for o in outs):
            raise AssertionError(f"{name} two_threads: {launches} launches, want {len(args) * reps}")
        err = max(kreg.max_abs_err(got, kdef.ref(shape, a)) for a, o in zip(args, outs) for got in o)
        if not err <= TIER_TOL:
            raise AssertionError(f"{name} two_threads: error {err:.3e} over tolerance {TIER_TOL:g}")
        print(f"kernel kernel={name} case=full_two_threads max_abs_err={err} launches={launches}", flush=True)


# the selective scan's backward: (label, B, chunk, di, N) at falcon-mamba-7b's
# chunk, timed with fp32 and with bf16 x; then the forward's ragged cases
# (SCAN_CASES' shapes, N 5 padded to 8, N 32 and 64 on their shorter
# segments), a chunk of one 8-step segment, and the edges of the split in
# time (csrc/selective_scan_bwd.cu: parts of whole segments, one block of a
# cluster each): 113 steps, 8 parts of two segments with the last part one
# step; 45 steps, 6 parts of one segment, the last of 5 steps; 7 steps, one
# part (P = 1 forced by the chunk); B 2 with di 72, three 32-channel
# blocks, the last ragged; in both dtypes
SS_BWD_WIDTH = ("falcon_mamba_7b", 1, 256, 8192, 16)
SS_BWD_CASES = [(2, 100, 50, 4), (1, 40, 45, 8), (1, 40, 96, 5), (1, 37, 64, 32), (2, 48, 64, 64), (2, 8, 32, 4),
                (1, 113, 64, 16), (2, 45, 96, 8), (1, 7, 64, 16), (2, 64, 72, 16)]
SS_BWD_SYMBOLS = ("selective_bwd_kernel", "selective_bwd_sum")  # csrc/selective_scan_bwd.cu: the walk, the sums


def selective_bwd_operands(torch, dev, B, ck, di, N, dtype: str, seed: int):
    """The scan's operands as the model makes them (dt in softplus's range,
    A as the reference initialises it, -1 to -N), a nonzero h0, and the
    cotangents dy and dh_last."""
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(B, ck, di, generator=g, device=dev).to(getattr(torch, dtype))
    dt = torch.rand(B, ck, di, generator=g, device=dev) * 0.099 + 0.001
    b, c = (torch.randn(B, ck, N, generator=g, device=dev) for _ in range(2))
    a = -(torch.rand(di, N, generator=g, device=dev) * (N - 1) + 1)
    h0, dh = (torch.randn(B, di, N, generator=g, device=dev) for _ in range(2))
    dy = torch.randn(B, ck, di, generator=g, device=dev)
    return x, dt, b, c, a, h0, dy, dh


def selective_bwd_bound(B, ck, di, N, x_bytes: int) -> dict:
    """The backward's bytes over the memory rate against its operations at
    the fp32 CUDA-core rate (``roofline/count.py``, ``selective_scan_bwd``:
    x, dt, dy, B, C, A, h0 and dh_last read, their gradients written; ~20
    fp32 operations a (step, channel, state)).  Beside the bound,
    ``exp_floor_ms``: its 2 B ck di N accurate expf (each way of the walk)
    at one MUFU.EX2 each, 16 a clock on each of 132 SMs at 1.98 GHz."""
    from repro_torch.kernels.autotune import HBM_BYTES_PER_S, PEAK_OPS_PER_S
    from repro_torch.roofline import count

    ops, nbytes = count.selective_scan_bwd(B, ck, di, N, x_bytes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "exp_floor_ms": 1e3 * 2 * B * ck * di * N / (132 * 16 * 1.98e9)}


SS_BWD_PARENT_WARPS = 8  # the walk before the split in time: two 4-warp blocks an SM at falcon width


def print_selective_bwd_occupancy(torch) -> None:
    """One ``occupancy`` line a dtype of x for the selective scan's backward
    at SS_BWD_WIDTH: the parts P of the split in time, blocks, threads and
    dynamic shared memory a block, and the occupancy calculator's blocks and
    warps an SM and resident clusters.  Fails under 16 warps an SM, twice
    the parent's SS_BWD_PARENT_WARPS."""
    from repro_torch.kernels import selective_scan as ss

    _, *width = SS_BWD_WIDTH
    for dtype in ("float32", "bfloat16"):
        cfg = ss.bwd_launch_config(*width, getattr(torch, dtype), torch.device("cuda", 0))
        print(f"occupancy selective_scan_bwd width={SS_BWD_WIDTH[0]} x_dtype={dtype} "
              + " ".join(f"{k}={v}" for k, v in cfg.items()) + f" parent_warps_per_sm={SS_BWD_PARENT_WARPS}", flush=True)
        if cfg["warps_per_sm"] < 2 * SS_BWD_PARENT_WARPS:
            raise AssertionError(f"selective_scan_bwd {dtype}: {cfg['warps_per_sm']} warps an SM, under 16")


def check_grads_by_dtype(torch, got, want, label: str) -> tuple:
    """``check_grads`` of each output at its own dtype's tolerance (a
    backward whose gradients differ in dtype: the selective scan's dx in x's,
    the rest fp32).  Returns the worst max-abs error and relative error."""
    errs = [check_grads(torch, [g], [w], str(g.dtype).removeprefix("torch."), label) for g, w in zip(got, want)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def check_selective_scan_bwd(torch, ops, dev, flush) -> dict:
    """The selective scan's backward kernel against its plain version
    (``check_grads_by_dtype``: fp32 within BWD_TOL of the largest element,
    bf16 dx element by element): at SS_BWD_WIDTH with fp32 and bf16 x, timed
    (warm, cold, a call with its host work) beside the plain version and the
    bound, one call profiled (its two kernels and no other); then at
    SS_BWD_CASES in both dtypes.  Every case: one backward launch a call and
    two calls bit-equal (no atomics), with the parts P its launch took.
    Last, two chunks chained through h against one chunk of twice the
    length."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ss

    label, *width = SS_BWD_WIDTH
    cases = [(label if dtype == "float32" else f"{label}_bf16x", tuple(width), dtype, True) for dtype in ("float32", "bfloat16")]
    cases += [("B{}_ck{}_di{}_N{}_".format(*shape) + dtype, shape, dtype, False)
              for shape in SS_BWD_CASES for dtype in ("float32", "bfloat16")]
    rows = {}
    for case, shape, dtype, timed in cases:
        operands = selective_bwd_operands(torch, dev, *shape, dtype, seed=15)
        run = lambda: ops.selective_scan_chunk_bwd(*operands)
        before = ops.backward_launch_counts()["selective_scan_bwd"]
        got, again = run(), run()
        torch.cuda.synchronize()
        if ops.backward_launch_counts()["selective_scan_bwd"] != before + 2:
            raise AssertionError(f"selective_scan_bwd {case}: the wrapper did not count its two calls")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"selective_scan_bwd {case}: a second call on the same operands gave other gradients")
        abs_err, err = check_grads_by_dtype(torch, got, ref.selective_scan_chunk_bwd_ref(*operands), f"selective_scan_bwd {case}")
        row = {"kernel": "selective_scan_bwd", "case": case, "dtype": dtype, "max_abs_err": abs_err, "rel_err": err,
               "bit_equal_again": True, "parts": ss.bwd_launch_config(*shape, getattr(torch, dtype), dev)["parts"]}
        if timed:
            _, _, device = device_profile(torch, run, expect=SS_BWD_SYMBOLS)
            ran = sorted(n for n in device if "selective_bwd" in n)
            if len(ran) != len(SS_BWD_SYMBOLS) or not all(any(names_kernel(n, sym) for n in ran) for sym in SS_BWD_SYMBOLS):
                raise AssertionError(f"selective_scan_bwd {case}: one call ran the kernels {ran}, want {SS_BWD_SYMBOLS}")
            row.update({
                "kernels_per_call": len(ran),
                "ms": median_ms(torch, run), "ms_cold": cold_ms(torch, run, flush), "ms_call": call_ms(torch, run),
                "plain_ms": median_ms(torch, lambda: ref.selective_scan_chunk_bwd_ref(*operands), max_reps=3), "library_ms": None,
            })
            row.update(selective_bwd_bound(*shape, 2 if dtype == "bfloat16" else 4))
        print("kernel " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        rows[case] = row
        del operands, got, again
    # two chunks chained (the second's dh0 is the first's dh_last) against one
    x, dt, b, c, a, h0, dy, dh = selective_bwd_operands(torch, dev, 2, 80, 96, 16, "float32", seed=16)
    whole = ops.selective_scan_chunk_bwd(x, dt, b, c, a, h0, dy, dh)
    half = lambda t, i: t[:, 40 * i:40 * (i + 1)].contiguous()
    _, h1 = ops.selective_scan_chunk(half(x, 0), half(dt, 0), half(b, 0), half(c, 0), a, h0)
    second = ops.selective_scan_chunk_bwd(half(x, 1), half(dt, 1), half(b, 1), half(c, 1), a, h1, half(dy, 1), dh)
    first = ops.selective_scan_chunk_bwd(half(x, 0), half(dt, 0), half(b, 0), half(c, 0), a, h0, half(dy, 0), second[5])
    chained = [torch.cat([f, s], dim=1) for f, s in zip(first[:4], second[:4])] + [first[4] + second[4], first[5]]
    _, err = check_grads(torch, chained, list(whole), "float32", "selective_scan_bwd chunk_chaining")
    print(f"kernel kernel=selective_scan_bwd case=chunk_chaining rel_err={err}", flush=True)
    torch.cuda.empty_cache()
    return rows


# forward cases at Lq != Lk, which the registry (q, k and v of one length)
# does not make: (label, B, H, KV, Lq, Lk, hd, causal, window)
LQ_LK_CASES = [
    ("lq96_lk200_non_causal", 1, 4, 2, 96, 200, 64, False, None),
    ("lq200_lk96_causal_hd128", 1, 4, 1, 200, 96, 128, True, None),
]


# the cross attentions of the encoder-decoder and vision families, forward,
# non-causal: (label, B, H, KV, Lq, Lk, hd, causal, window, dtypes).
# seamless-m4t-medium's encoder self attention and its decoder's cross
# attention share one shape at the serve's 4096 tokens and 4096 frames;
# llama-3.2-vision-11b's text (4096 rows) to its 1024 image tokens (Lq > Lk,
# no causal mask to trim the k range); the reduced vlm config's cross
# attention, 8 image tokens, shorter than one 32-row k tile of the fp32
# forward.  Timed beside non-causal SDPA without a mask.
CROSS_CASES = [
    ("seamless_m4t_medium", 1, 16, 16, 4096, 4096, 64, False, None, ("bfloat16",)),
    ("llama_3_2_vision_11b_cross", 1, 32, 8, 4096, 1024, 128, False, None, ("bfloat16",)),
    ("vlm_reduced_cross", 2, 4, 2, 16, 8, 16, False, None, ("float32",)),
]


def check_attention_lq_lk(torch, ops, dev, flush, cases=None) -> dict:
    """The attention forward at Lq != Lk (LQ_LK_CASES in both dtypes, or
    ``cases`` in theirs), through the ops wrapper (blocks as the models
    pick them, ``block_for``), against its plain version (fp32 relative
    WIDTH_TOL, bf16 also element by element) and on the route
    ``expected_route`` gives; timed beside SDPA (on an explicit mask,
    positions from 0 in q and k, for LQ_LK_CASES; with none, non-causal,
    for ``cases``) and the bound.  Returns {case: row}."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.models.attention import block_for

    rows = {}
    explicit_mask = cases is None
    cases = cases or [c + (("float32", "bfloat16"),) for c in LQ_LK_CASES]
    for label, B, H, KV, Lq, Lk, hd, causal, window, dtypes in cases:
        qp = torch.arange(Lq, device=dev)[:, None]
        kp = torch.arange(Lk, device=dev)[None, :]
        mask = (qp >= kp) if causal else torch.ones(Lq, Lk, dtype=torch.bool, device=dev)
        if not explicit_mask:
            mask = None
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            g = torch.Generator(dev).manual_seed(13)
            q = torch.randn(B, H, Lq, hd, generator=g, device=dev).to(dt)
            k, v = (torch.randn(B, KV, Lk, hd, generator=g, device=dev).to(dt) for _ in range(2))
            route = expected_route("flash_attention", {"hd": hd}, dtype)
            call = lambda: ops.flash_attention(q, k, v, causal=causal, window=window, block_q=block_for(Lq), block_k=block_for(Lk))
            before = ops.route_launch_counts()["flash_attention"]
            got = call()
            torch.cuda.synchronize()
            took = {r: n - before[r] for r, n in ops.route_launch_counts()["flash_attention"].items()}
            if took != {r: int(r == route) for r in took}:
                raise AssertionError(f"flash_attention {label}_{dtype}: launches by route {took}, want one on {route}")
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash_attention {label}_{dtype}: kernel gave {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
            if dt == torch.bfloat16:
                check_bf16_elements(got, want, f"flash_attention {label}_{dtype}")
            err = float((got.float() - want.float()).abs().max())
            rel = err / float(want.float().abs().max())
            if not rel <= WIDTH_TOL[dtype]:
                raise AssertionError(f"flash_attention {label}_{dtype}: relative error {rel:.3e} over {WIDTH_TOL[dtype]:g}")
            row = {"kernel": "flash_attention", "case": f"{label}_{dtype}", "dtype": dtype, "route": route,
                   "max_abs_err": err, "rel_err": rel,
                   "ms": median_ms(torch, call), "ms_cold": cold_ms(torch, call, flush), "ms_call": call_ms(torch, call),
                   "plain_ms": median_ms(torch, lambda: ref.attention_ref(q, k, v, causal=causal, window=window), max_reps=5),
                   "library_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                                                                                         enable_gqa=True))}
            row.update(attention_fwd_bound(B, H, KV, Lq, Lk, hd, causal, window, dtype, route))
            print("kernel " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
            rows[row["case"]] = row
    return rows


def run_broker(torch, kreg, ops, Hydra, ProviderSpec, Task, TaskState):
    """The port's main path: Hydra.dispatch -> StreamingDispatcher ->
    CaaS / pilot manager -> KernelRuntime -> the kernels, on cuda:0."""
    import concurrent.futures as cf

    os.environ["HYDRA_EVENTS_CHECK"] = "1"
    os.environ["HYDRA_LEDGER_CHECK"] = "1"
    h = Hydra(device="cuda", streaming=True, pod_store="memory")
    h.register_provider(ProviderSpec(name="cloud", platform="cloud", connector="caas"))
    h.register_provider(ProviderSpec(name="hpc", platform="hpc", connector="pilot"))
    names = sorted(kreg.KERNELS)
    kernel_tasks = []
    for i in range(64):  # the four kernels in turn, at the registry's full shapes
        n = names[i % len(names)]
        shape = dict(kreg.get_kernel(n).full_shape)
        task = Task(kind="kernel", payload={"kernel": n, "shape": dict(shape), "reps": 1, "seed": i})
        kernel_tasks.append((task, n, shape, "float32"))
    kernel_tasks += [
        (Task(kind="kernel", payload={"kernel": n, "shape": dict(shape), "dtype": dtype, "reps": 2, "seed": 100 + i}), n, shape, dtype)
        for i, (n, _, shape, dtype) in enumerate(MODEL_WIDTHS)
    ]
    noops = [Task(kind="noop") for _ in range(1024)]
    tasks = noops + [t for t, *_ in kernel_tasks]
    want_reps = {n: 0 for n in names}
    want_execs = {n: 0 for n in names}
    want_routes = {n: {r: 0 for r in ops.route_launch_counts()[n]} for n in ROUTED}
    for t, n, shape, dtype in kernel_tasks:
        want_reps[n] += t.payload["reps"]
        want_execs[n] += 1
        if n in ROUTED:
            want_routes[n][expected_route(n, shape, dtype)] += t.payload["reps"]

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    h.dispatch(tasks)
    done, pending = cf.wait(tasks, timeout=900)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = ops.route_launch_counts()
    if pending:
        raise AssertionError(f"broker: {len(pending)} tasks unfinished after 900 s")
    states = {}
    for t in tasks:
        states[t.tstate.value] = states.get(t.tstate.value, 0) + 1
        if t.tstate != TaskState.DONE or t.exception() is not None:
            raise AssertionError(f"broker: task {t.uid} ended {t.tstate.value}: {t.exception()!r}")
    for t, n, shape, dtype in kernel_tasks:
        r = t.result()
        want = {"kernel": n, "sig": kreg.shape_sig(shape, dtype), "reps": t.payload["reps"], "skipped_reps": 0,
                "config": kreg.config_sig(kreg.get_kernel(n).defaults(shape))}
        if {k: r[k] for k in want} != want:
            raise AssertionError(f"broker: task {t.uid} result {r} is not {want}")
    if h.kernel_execs_by != want_execs or h.kernel_reps != sum(want_reps.values()):
        raise AssertionError(f"broker: kernel_execs_by {h.kernel_execs_by} / reps {h.kernel_reps}, want {want_execs}")
    events = {}
    for e in h.events.events():
        if e.name == "kernel.exec":
            events[e.attrs["kernel"]] = events.get(e.attrs["kernel"], 0) + 1
    if events != want_execs:
        raise AssertionError(f"broker: kernel.exec events {events} do not reconcile with {want_execs}")
    if launches != want_reps:
        raise AssertionError(f"broker: launch counts {launches}, want the reps dispatched {want_reps}")
    if routes != want_routes:
        raise AssertionError(f"broker: launches by route {routes}, want {want_routes}")
    kernel_s = h.kernel_seconds
    h.shutdown(wait=True)  # strict: re-runs the event and ledger cross-checks
    print(
        f"broker tasks={len(tasks)} states={json.dumps(states)} wall_s={wall} tasks_per_s={len(tasks) / wall} "
        f"kernel_s={kernel_s} launches={json.dumps(launches)} routes={json.dumps(routes)}",
        flush=True,
    )
    return launches, routes


SERVE_KERNELS = ("flash_attention", "selective_scan", "rglru_scan", "moe_gmm")  # searise_kernels' order
SCENARIO_ROUTES = {"flash_attention": "tf32x3", "moe_gmm": "tf32x3"}  # the routes of its fp32 payloads
FACTS_INSTANCES = 64
FACTS_SAMPLES = 150_000  # benchmarks/exp4_facts.py:21

MODEL_TOL = 1e-4  # relative max error, card against CPU in fp32
# (arch, layers kept, prompt length, the launches its prefill must make,
# the route of its fp32 attention: tf32x3 at head width 128, tf32x3_cluster at 256)
MODEL_CHECKS = [
    ("recurrentgemma-2b", 3, 2176, {"rglru_scan": 2, "flash_attention": 1}, "tf32x3_cluster"),
    ("falcon-mamba-7b", 2, 512, {"selective_scan": 4}, None),
    ("llama3-8b", 2, 1000, {"flash_attention": 2}, "tf32x3"),
    # two groups of 256 tokens, 80 slots an expert each at cf 1.25: tokens drop
    ("grok-1-314b", 1, 512, {"flash_attention": 1, "moe_gmm": 3}, "tf32x3"),
    # 2 encoder and 2 decoder layers over 600 frames: blocks of 125 (prompt)
    # and 120 (frames), so Lq != Lk in the cross attention and neither is a
    # multiple of 64; 2 encoder, 2 decoder and 2 cross attentions
    ("seamless-m4t-medium", {"n_layers": 2, "n_enc_layers": 2, "enc_len_serve": 600}, 1000, {"flash_attention": 6}, "tf32x3"),
    # one superblock (4 self layers and the gated cross layer, gates opened)
    # over the config's 1024 image tokens
    ("llama-3.2-vision-11b", 5, 512, {"flash_attention": 5}, "tf32x3"),
]
# the vlm family's tanh gates start at zero, shutting its image path out of
# the output and its gradients to zero: every vlm run here opens them
GATES = {"gate_attn": 0.5, "gate_mlp": -0.3}
# the other families from the model path at full width, depth cut, bf16,
# batch 1: (arch, layers kept, prompt length, the launches its prefill must
# make): 16 selective_scan chunks of 256 a layer; one causal attention a
# layer; three expert GEMMs a moe layer
MODEL_WIDTH_RUNS = [
    ("falcon-mamba-7b", 4, 4096, {"selective_scan": 64}),
    ("llama3-8b", 4, 4096, {"flash_attention": 4}),
    ("grok-1-314b", 2, 4096, {"flash_attention": 2, "moe_gmm": 6}),
    ("arctic-480b", 1, 4096, {"flash_attention": 1, "moe_gmm": 3}),
]
SERVE = {"arch": "recurrentgemma-2b", "batch": 4, "prompt_len": 4096, "gen": 32}
SERVE_PREFILL_LAUNCHES = {"flash_attention": 8, "selective_scan": 0, "rglru_scan": 18, "moe_gmm": 0}
# the moe family's serve: grok-1-314b at full width cut to 2 layers (the
# weights handed to serve decide the depth), bf16; each decode step runs the
# 3 expert GEMMs of each layer at 2 rows an expert
MOE_SERVE = {"arch": "grok-1-314b", "layers": 2, "batch": 4, "prompt_len": 4096, "gen": 32}
MOE_SERVE_PREFILL_LAUNCHES = {"flash_attention": 2, "selective_scan": 0, "rglru_scan": 0, "moe_gmm": 6}
MOE_SERVE_DECODE_LAUNCHES = {"flash_attention": 0, "selective_scan": 0, "rglru_scan": 0, "moe_gmm": 6 * (MOE_SERVE["gen"] - 1)}
# the encoder-decoder and vision families' serve, full size, bf16: every
# attention of a prefill on wgmma (seamless-m4t-medium 12 encoder, 12
# decoder and 12 cross attentions; llama-3.2-vision-11b 32 self and 8 cross),
# none in decode
FAMILY_SERVES = [
    {"arch": "seamless-m4t-medium", "batch": 4, "prompt_len": 4096, "gen": 32, "prefill_attention": 36},
    {"arch": "llama-3.2-vision-11b", "batch": 4, "prompt_len": 4096, "gen": 32, "prefill_attention": 40},
]
# the reduced configs' prefill launches: 2 dense, 2 hybrid, 2 + 2 moe, 2 + 2 +
# 2 encoder-decoder (encoder, decoder, cross) and 2 + 2 vision (self, cross)
# attention layers, 4 recurrent layers, 2 ssm layers x 2 chunks of 8, 2 + 2
# moe layers x 3 expert GEMMs
COMPUTE_ARCHS = ("llama3-8b", "falcon-mamba-7b", "recurrentgemma-2b", "grok-1-314b", "arctic-480b", "seamless-m4t-medium",
                 "llama-3.2-vision-11b")
COMPUTE_LAUNCHES = {"flash_attention": 18, "selective_scan": 4, "rglru_scan": 4, "moe_gmm": 12}
# the kernels' symbols in a profiler trace (csrc/*.cu)
KERNEL_SYMBOLS = {"flash_attention": "flash_fwd", "selective_scan": "scan_kernel", "rglru_scan": "rglru_kernel", "moe_gmm": "gmm_"}


def scenario_spec():
    """searise_at_scale with the settings searise_kernels applies."""
    from repro_torch.scenarios import presets

    spec = presets.searise_at_scale(seed=0)
    spec.traffic.serve_kernels = SERVE_KERNELS
    spec.traffic.serve_kernel_reps = 2
    spec.kernel_autotune = True
    spec.checkpoint_interval_s = 2.0
    return spec


def run_scenarios(ops, device="cuda"):
    """The scenario path on the card, chaos and no-chaos twin: run_scenario
    -> build_broker -> Hydra(device="cuda") + checkpoints + autotuner +
    autoscaler -> ChaosEngine -> WorkflowManager -> StreamingDispatcher ->
    CaaS / pilot managers -> KernelRuntime -> the kernels."""
    from repro_torch.core.staging import SHARED_SITE
    from repro_torch.scenarios import check_invariants, run_scenario, runner

    os.environ["HYDRA_EVENTS_CHECK"] = "1"
    os.environ["HYDRA_LEDGER_CHECK"] = "1"
    spec = scenario_spec()
    brokers = []
    build = runner.build_broker

    def keep(spec_, device):  # the report drops the broker; keep it to read its log
        brokers.append(build(spec_, device))
        return brokers[-1]

    runner.build_broker = keep
    reports, counts, walls = {}, {}, {}
    try:
        for chaos in (True, False):
            tag = "chaos" if chaos else "baseline"
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            reports[tag] = run_scenario(spec, chaos=chaos, device=device)
            walls[tag] = time.perf_counter() - t0
            counts[tag] = (ops.launch_counts(), ops.route_launch_counts())
    finally:
        runner.build_broker = build
    violations = check_invariants(reports["chaos"], reports["baseline"], spec)
    if violations:
        raise AssertionError(f"scenario: invariants violated: {violations}")
    for (tag, rep), h in zip(reports.items(), brokers):
        launches, routes = counts[tag]
        if rep.failed_tasks or rep.unresolved_tasks:
            raise AssertionError(f"scenario {tag}: {rep.failed_tasks} failed, {rep.unresolved_tasks} unresolved tasks")
        if rep.kernel["tunes"] != len(SERVE_KERNELS):
            raise AssertionError(f"scenario {tag}: {rep.kernel['tunes']} tunes, want {len(SERVE_KERNELS)}")
        keys = sorted(h.autotuner.results())
        for name in SERVE_KERNELS:
            mine = [k for k in keys if k.startswith(f"tune:{name}:{device}:")]
            if len(mine) != 1 or not h.staging.registry.get(mine[0]).pinned or SHARED_SITE not in h.staging.registry.locate(mine[0]):
                raise AssertionError(f"scenario {tag}: {name} winner is not one pinned shared tune:{name}:{device}: dataset ({keys})")
        executed = {name: 0 for name in SERVE_KERNELS}
        for e in h.events.events():
            if e.name == "kernel.exec":
                executed[e.attrs["kernel"]] += e.attrs["reps"]
        if launches != executed or min(launches.values()) < 1:
            raise AssertionError(f"scenario {tag}: launches {launches}, kernel.exec reps {executed}")
        for name, by in routes.items():  # fp32 payloads: attention and GEMMs on tf32x3
            want = SCENARIO_ROUTES[name]
            if by != {r: launches[name] if r == want else 0 for r in by}:
                raise AssertionError(f"scenario {tag}: {name} launches by route {by}, want all {launches[name]} on {want}")
        k = rep.kernel
        print(
            f"scenario name={spec.name} twin={tag} tasks={rep.n_tasks} makespan_s={rep.makespan_s} wall_s={walls[tag]} "
            f"preempted={rep.preempted_tasks} recovered={rep.recovered_tasks} first_fault_s={rep.first_fault_s} "
            f"recovery_s={rep.recovery_s} kernel_execs={k['execs']} kernel_reps={k['reps']} kernel_s={k['seconds']} "
            f"tunes={k['tunes']} launches={json.dumps(launches)} scale={json.dumps(rep.scale.get('autoscaler', {}))}",
            flush=True,
        )
    chaos, base = reports["chaos"], reports["baseline"]
    print(
        f"scenario name={spec.name} tasks={chaos.n_tasks} makespan_chaos_s={chaos.makespan_s} makespan_base_s={base.makespan_s} "
        f"inflation={chaos.makespan_s / base.makespan_s} wall_chaos_s={walls['chaos']} wall_base_s={walls['baseline']} "
        f"preempted={chaos.preempted_tasks} recovered={chaos.recovered_tasks} "
        f"kernel_execs={chaos.kernel['execs']} kernel_reps={chaos.kernel['reps']} kernel_s={chaos.kernel['seconds']} "
        f"launches={json.dumps(counts['chaos'][0])} invariants={violations}",
        flush=True,
    )
    return {tag: counts[tag][0] for tag in counts}


def run_autotune(torch, kreg, dev):
    """A wall-timed sweep of each kernel at its full tier on the card; a
    kernel task under HYDRA_AUTOTUNE=1 must resolve to the winner."""
    from repro_torch.core.managers.compute import KERNEL_RUNTIME
    from repro_torch.core.task import Task
    from repro_torch.kernels.autotune import Autotuner, set_autotuner, unset_autotuner

    tuner = Autotuner(timer="wall", device=dev, reps=5, warmup=2)
    set_autotuner(tuner)
    os.environ["HYDRA_AUTOTUNE"] = "1"
    try:
        for name in sorted(kreg.KERNELS):
            shape = dict(kreg.get_kernel(name).full_shape)
            r = tuner.tune(name, shape, "float32")
            if not r.key.startswith(f"tune:{name}:{dev.type}:"):
                raise AssertionError(f"autotune {name}: key {r.key}")
            got = KERNEL_RUNTIME.run(Task(kind="kernel", payload={"kernel": name, "shape": shape}), dev)["config"]
            if got != kreg.config_sig(r.config):
                raise AssertionError(f"autotune {name}: a kernel task resolved {got}, the tuner chose {kreg.config_sig(r.config)}")
            print(
                f"autotune kernel={name} config={kreg.config_sig(r.config)} best_ms={r.best_s * 1e3} "
                f"swept={r.swept} exhaustive={r.exhaustive} timed={len(set(r.timings.values()))}",
                flush=True,
            )
    finally:
        os.environ.pop("HYDRA_AUTOTUNE", None)
        unset_autotuner(tuner)


def run_facts(torch, Hydra, ProviderSpec, dev):
    """64 FACTS workflows on the card through the broker, then four
    instances held against the CPU."""
    import numpy as np

    from repro_torch.core.managers.workflow import WorkflowManager
    from repro_torch.facts import model as facts
    from repro_torch.facts.workflow import make_workflow, result_of

    h = Hydra(device=dev.type, pod_store="memory", policy="load_aware")
    for name in ("jet2", "aws"):
        h.register_provider(ProviderSpec(name=name, platform="cloud", connector="caas", concurrency=8))
    h.register_provider(ProviderSpec(name="bridges2", platform="hpc", connector="pilot", concurrency=8))
    wfs = [make_workflow(h.data, i, seed=0, n_samples=FACTS_SAMPLES, device=dev) for i in range(FACTS_INSTANCES)]
    t0 = time.perf_counter()
    WorkflowManager(h).run(wfs, wait=True, timeout=600)
    wall = time.perf_counter() - t0
    bad = [wf.name for wf in wfs if not wf.done or wf.failed]
    if bad:
        raise AssertionError(f"facts: {len(bad)} workflows not done: {bad[:4]}")
    for i in range(FACTS_INSTANCES):
        q = list(result_of(h.data, i)["quantiles"].values())
        if not (np.all(np.isfinite(q)) and q == sorted(q)):
            raise AssertionError(f"facts: instance {i} quantiles {q}")
    h.shutdown(wait=True)
    fit_err, proj_err = 0.0, 0.0
    for site in (0, 7, 31, 63):
        pre = facts.preprocess(site, 0)
        on_card, on_cpu = facts.fit(pre, device=dev), facts.fit(pre, device="cpu")
        for k in ("theta", "cov", "sigma2"):
            err = float(np.max(np.abs(np.asarray(on_card[k]) - on_cpu[k]) / np.abs(on_cpu[k])))
            fit_err = max(fit_err, err)
        z = facts.draws(pre, on_cpu, n_samples=FACTS_SAMPLES, seed=0, device="cpu")
        want = facts.project_from_draws(pre, on_cpu, *z)
        got = facts.project_from_draws(pre, on_cpu, *(t.to(dev) for t in z))
        for k in ("rise_mm", "trajectories"):
            proj_err = max(proj_err, float(np.abs(got[k] - want[k]).max()))
    if not (fit_err <= 1e-5 and proj_err <= 1e-3):
        raise AssertionError(f"facts: card vs CPU fit relative error {fit_err:.3e} (<= 1e-5), project max-abs {proj_err:.3e} mm (<= 1e-3)")
    print(
        f"facts instances={FACTS_INSTANCES} n_samples={FACTS_SAMPLES} wall_s={wall} instances_per_s={FACTS_INSTANCES / wall} "
        f"fit_rel_err={fit_err} project_max_abs_mm={proj_err}",
        flush=True,
    )


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, got moved to want's device."""
    got, want = got.detach().to(want.device).float(), want.detach().float()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} against {tuple(want.shape)}")
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


# the wrappers of ``kernels/ops.py`` the model path calls, by the kernel
# each launches on the card
PATH_WRAPPERS = {
    "flash_attention": "flash_attention", "selective_scan_chunk": "selective_scan", "rglru_scan": "rglru_scan", "moe_gmm": "moe_gmm",
}


def plain_version(wrapper: str):
    """The plain version (``kernels/ref.py``) of a PATH_WRAPPERS wrapper,
    taking the wrapper's arguments (the GEMM's a slice of 8 experts at a
    time: an fp32 copy of arctic's whole weight would take 17.8 GB)."""
    import torch

    from repro_torch.kernels import ref

    return {
        "flash_attention": lambda q, k, v, causal=True, window=None, **_: ref.attention_ref(q, k, v, causal=causal, window=window),
        "selective_scan_chunk": lambda x, dt, b, c, a, h0, **_: ref.selective_scan_chunk_ref(x, dt, b, c, a, h0),
        "rglru_scan": lambda log_a, gx, h0=None, **_: ref.rglru_ref(log_a, gx, h0),
        "moe_gmm": lambda x, w, **_: torch.cat([ref.moe_gmm_ref(a, b) for a, b in zip(x.split(8), w.split(8))]),
    }[wrapper]


def check_plain(torch, got, want, where: str) -> float:
    """A kernel output against its plain version: finite, within WIDTH_TOL
    of its dtype relative to the largest element, and bf16 also element by
    element (BF16_ELEMENT_TOL).  Returns the relative error; raises over."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{where}: kernel output is not finite")
    err = rel_err(got, want)
    if not err <= WIDTH_TOL[str(got.dtype).removeprefix("torch.")]:
        raise AssertionError(f"{where}: relative error {err:.3e} against the plain version, shape {tuple(got.shape)} {got.dtype}")
    if got.dtype == torch.bfloat16:
        check_bf16_elements(got, want, where)
    return err


@contextlib.contextmanager
def path_kernels_checked(torch, ops, label):
    """Holds every kernel launch the model path makes inside the block
    against the plain version (``kernels/ref.py``) on the same operands, at
    the shapes and on the data the path gives it: each output within
    WIDTH_TOL of its dtype, relative to its largest element, and bf16
    outputs also element by element (BF16_ELEMENT_TOL).  The wrappers in
    ``ops`` are swapped for ones that call the original (the path's own
    launch, counted as ever) and then the plain version, which launches no
    kernel.  Yields {kernel: {"calls": n, "rel_err": worst}}."""
    seen = {kernel: {"calls": 0, "rel_err": 0.0} for kernel in PATH_WRAPPERS.values()}
    originals = {wrapper: getattr(ops, wrapper) for wrapper in PATH_WRAPPERS}

    def checked(wrapper):
        kernel = PATH_WRAPPERS[wrapper]

        def call(*args, **kw):
            got = originals[wrapper](*args, **kw)
            want = plain_version(wrapper)(*args, **kw)
            where = f"{label}: {kernel} call {seen[kernel]['calls']}"
            for g, w in zip(as_tuple(got), as_tuple(want)):
                seen[kernel]["rel_err"] = max(seen[kernel]["rel_err"], check_plain(torch, g, w, where))
            seen[kernel]["calls"] += 1
            return got

        return call

    for wrapper in PATH_WRAPPERS:
        setattr(ops, wrapper, checked(wrapper))
    try:
        yield seen
    finally:
        for wrapper, fn in originals.items():
            setattr(ops, wrapper, fn)


@contextlib.contextmanager
def cpu_sides(torch, workers: int = 2):
    """The CPU sides of card-against-CPU checks, ``workers`` at once beside
    the next checks' card sides: yields ``submit(fn)``; on exit waits for
    every side, re-raising the first failure.  Each side runs on one
    thread: the intra-op thread count (OpenMP's and MKL's) is a thread's
    own, and each worker sets its own to 1.  With eight, runs on some hosts
    found recurrentgemma-2b's k and v caches 1.1e-4 to 1.4e-4 off (relative
    to their largest element), all of it in one band of rows, rows 272 j to
    272 (j + 1) of 2176 for one j: the rows one of the eight CPU threads
    computes.  The other rows agreed within 1e-5, and the card gave the
    same result when run again.  One thread takes the thread split out of
    the reference."""
    import concurrent.futures as cf

    def one_thread(fn):
        torch.set_num_threads(1)
        return fn()

    futures = []
    with cf.ThreadPoolExecutor(workers) as pool:
        yield lambda fn: futures.append(pool.submit(one_thread, fn))
        for f in futures:
            f.result()


def open_gates(torch, params):
    """Opens both tanh gates of every cross layer of a vlm tree in place
    (GATES); any other family's tree is left as it is.  Returns the tree."""
    xattn = params.get("superblocks", {}).get("xattn")
    if xattn is not None:
        with torch.no_grad():
            for k, g in GATES.items():
                xattn[k].fill_(g)
    return params


def frontend_extras(torch, cfg, batch: int, dev, seed: int = 1) -> dict:
    """The frontend stubs of an audio or vlm batch, drawn with numpy in fp32
    as ``launch/serve.py`` draws them: ``enc_frames`` (B, enc_len_serve, D),
    ``img_embeds`` (B, n_img_tokens, D); none for the other families."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"enc_frames": torch.as_tensor(rng.normal(size=(batch, cfg.enc_len_serve, cfg.d_model)), dtype=torch.float32, device=dev)}
    if cfg.family == "vlm":
        return {"img_embeds": torch.as_tensor(rng.normal(size=(batch, cfg.n_img_tokens, cfg.d_model)), dtype=torch.float32, device=dev)}
    return {}


def check_model_on_card(torch, ops, name, cut, prompt, want, attn_route, dev, submit):
    """One prefill at full width in fp32 on the card and on the CPU, on the
    same weights (vlm gates opened) and inputs (with the family's frontend
    stubs): logits and every cache leaf within MODEL_TOL, and exactly
    ``want``'s launches on the card (fp32 attention on ``attn_route``).
    ``cut`` is the layers kept, or the config fields that cut it.  The host
    must hold the weights in fp32 and half as much again, or the line says
    it could not.  The CPU side and the comparison go to ``submit``
    (``cpu_sides``)."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves, tree_map

    cut = cut if isinstance(cut, dict) else {"n_layers": cut}
    cfg = get_arch(name).replace(**cut, param_dtype="float32", compute_dtype="float32")
    model = Model(cfg)
    need, have = 1.5 * 4 * model.param_count(), host_available_bytes()
    if have < need:
        print(f"model arch={name} cut={json.dumps(cut)} dtype=float32 skipped=host_memory host_available_gb={have / 1e9} "
              f"need_gb={need / 1e9}", flush=True)
        return
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, prompt)), dtype=torch.int32)
    extras = frontend_extras(torch, cfg, 1, "cpu")
    cache_len = prompt + 8
    with torch.no_grad():
        params = open_gates(torch, model.init(torch.Generator(dev).manual_seed(0), dev))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens.to(dev), **{k: v.to(dev) for k, v in extras.items()}}, cache_len=cache_len)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches, routes = ops.launch_counts(), ops.route_launch_counts()
        params = tree_map(lambda t: t.cpu(), params)
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        raise AssertionError(f"model {name}: prefill launches {launches}, want {full}")
    if routes["flash_attention"] != {r: full["flash_attention"] if r == attn_route else 0 for r in routes["flash_attention"]}:
        raise AssertionError(f"model {name}: attention launches by route {routes['flash_attention']}, want all on {attn_route}")
    if routes["moe_gmm"] != {r: full["moe_gmm"] if r == "tf32x3" else 0 for r in routes["moe_gmm"]}:
        raise AssertionError(f"model {name}: GEMM launches by route {routes['moe_gmm']}, want all on tf32x3")

    def cpu_side():
        t0 = time.perf_counter()
        with torch.no_grad():
            want_logits, want_cache = model.prefill(params, {"tokens": tokens, **extras}, cache_len=cache_len)
        cpu_s = time.perf_counter() - t0
        errs = [rel_err(logits, want_logits)]
        errs += [rel_err(g, w) for g, w in zip(tree_leaves(cache), tree_leaves(want_cache))]
        if not bool(torch.isfinite(logits).all()) or not max(errs) <= MODEL_TOL:
            raise AssertionError(f"model {name}: card against CPU relative errors {errs}, tolerance {MODEL_TOL:g}")
        print(
            f"model arch={name} layers={cfg.n_layers} cut={json.dumps(cut)} prompt={prompt} extras={json.dumps({k: list(v.shape) for k, v in extras.items()})} "
            f"dtype=float32 logits_rel_err={errs[0]} "
            f"cache_rel_err={max(errs[1:])} cache_leaves={len(errs) - 1} card_s={card_s} cpu_s={cpu_s} "
            f"launches={json.dumps(launches)} attention_routes={json.dumps(routes['flash_attention'])} "
            f"gemm_routes={json.dumps(routes['moe_gmm'])}",
            flush=True,
        )

    submit(cpu_side)


def run_full_width(torch, ops, name, n_layers, prompt, want, dev):
    """One bf16 prefill of the full-width config cut to ``n_layers``: finite
    logits and cache, exactly ``want``'s launches (attention and GEMMs on
    ``wgmma``), each held against its plain version; then the prefill's
    time, warm."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves

    model = Model(get_arch(name).replace(n_layers=n_layers))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, model.cfg.vocab_size, (1, prompt)), dtype=torch.int32, device=dev)
    with torch.no_grad():
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        ops.reset_launch_counts()
        with path_kernels_checked(torch, ops, f"model {name}") as checked:
            logits, cache = model.prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
        launches, routes = ops.launch_counts(), ops.route_launch_counts()
        full = {k: want.get(k, 0) for k in launches}
        if launches != full or any(routes[k] != {r: full[k] if r == "wgmma" else 0 for r in routes[k]} for k in ROUTED):
            raise AssertionError(f"model {name}: prefill launches {launches} by route {routes}, want {full} (attention and GEMMs on wgmma)")
        if any(checked[k]["calls"] != n for k, n in full.items() if k in checked):
            raise AssertionError(f"model {name}: calls held against the plain versions {checked}, want {full}")
        if not all(bool(torch.isfinite(t).all()) for t in [logits] + tree_leaves(cache)):
            raise AssertionError(f"model {name}: prefill output is not finite")
        prefill_ms = call_ms(torch, lambda: model.prefill(params, {"tokens": tokens}), budget_s=1.0, max_reps=5)
    print(
        f"model arch={name} layers={n_layers} prompt={prompt} dtype=bfloat16 batch=1 prefill_ms={prefill_ms} "
        f"launches={json.dumps(launches)} path_checked={json.dumps(checked)}",
        flush=True,
    )


# after heavy use of the card a trace may lose kernels that ran (ROADMAP.md
# fault 3.8; scripts/profiler_first_kernels.py): each profiled call runs
# behind WARMUP_SPINS spin kernels of WARMUP_SPIN_S each, each waited for,
# and is profiled up to PROFILE_ATTEMPTS times while its trace lacks a
# kernel a check reads
WARMUP_SPINS = 16
WARMUP_SPIN_S = 1.25e-3
PROFILE_ATTEMPTS = 3
# how often device_profile's first trace lacked the expected kernel, and
# whether the profiler's raw Kineto events held it then (ROADMAP.md fault 3.8)
PROFILE_STATS = {"calls": 0, "retried": 0, "in_kineto_only": 0, "in_neither": 0, "retry_found": 0}


def kineto_kernel_names(torch, prof) -> set | None:
    """The device kernels among the profiler's raw Kineto events, before
    they are matched to the CPU operations that launched them (None where
    this torch has no such list)."""
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        return None
    return {e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CUDA}


def device_profile(torch, fn, grad: bool = False, expect: str | tuple | None = None):
    """``fn()`` once under torch.profiler (with grad mode on only when
    ``grad``): its wall (synchronized) and the device time of every kernel
    the trace holds, by name.  ``expect``: a part of a name the call's
    trace must hold, or a tuple of parts that each must; a trace that lacks
    one, lost by the tracer or not, is taken again, up to PROFILE_ATTEMPTS
    traces (a line says so, with whether the raw Kineto events held every
    one: PROFILE_STATS counts both), and the caller's check reads the
    last."""
    from torch.profiler import ProfilerActivity, profile

    PROFILE_STATS["calls"] += 1
    cycles = spin_cycles(torch, WARMUP_SPIN_S)
    for attempt in range(PROFILE_ATTEMPTS):
        with torch.set_grad_enabled(grad), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # spins go first: the trace's first kernels may be lost
            for _ in range(WARMUP_SPINS):
                torch.cuda.synchronize()
                torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        device = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device[e.name] = device.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
        wanted = (expect,) if isinstance(expect, str) else expect or ()
        found = all(any(w in n for n in device) for w in wanted)
        if attempt:
            PROFILE_STATS["retry_found"] += int(found)
        if found or attempt == PROFILE_ATTEMPTS - 1:
            return out, wall_s, device
        raw = kineto_kernel_names(torch, prof)
        in_raw = raw is not None and all(any(w in n for n in raw) for w in wanted)
        PROFILE_STATS["retried"] += 1
        PROFILE_STATS["in_kineto_only" if in_raw else "in_neither"] += 1
        print(f"device_profile: no kernel named *{'*, *'.join(w for w in wanted if not any(w in n for n in device))}* in the trace "
              f"({sorted(device)}); in the raw Kineto events: {in_raw}; "
              f"profiling the call again", flush=True)


def top_kernels(device: dict, n: int = 5) -> list:
    return [[name[:80], t] for name, t in sorted(device.items(), key=lambda kv: -kv[1])[:n]]


def run_serve(torch, ops, dev):
    """recurrentgemma-2b at full size, bf16: two serves on one set of
    weights (the first warms the allocator and cuBLAS and holds each kernel
    launch of its prefill against the plain version; both are checked, the
    second is reported), then the kernels' share of one more prefill."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    model = Model(get_arch(SERVE["arch"]))
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    kw = {k: v for k, v in SERVE.items() if k != "arch"}
    for run in range(2):
        ops.reset_launch_counts()
        # the first serve holds each kernel launch against its plain version
        with path_kernels_checked(torch, ops, "serve") if run == 0 else contextlib.nullcontext(checked) as checked:
            out = serve(SERVE["arch"], reduced=False, device="cuda", params=params, **kw)
        routes = ops.route_launch_counts()
        if run == 0 and any(checked[k]["calls"] != n for k, n in SERVE_PREFILL_LAUNCHES.items() if k in checked):
            raise AssertionError(f"serve: calls held against the plain versions {checked}, want {SERVE_PREFILL_LAUNCHES}")
        if not out["logits_finite"]:
            raise AssertionError("serve: logits are not finite")
        if out["prefill_launches"] != SERVE_PREFILL_LAUNCHES or set(out["decode_launches"].values()) != {0}:
            raise AssertionError(f"serve: prefill launches {out['prefill_launches']} (want {SERVE_PREFILL_LAUNCHES}), decode {out['decode_launches']} (want none)")
        if routes["flash_attention"] != all_on("wgmma", 8) or set(routes["moe_gmm"].values()) != {0}:
            raise AssertionError(f"serve: launches by route {routes}, want the 8 attention launches on wgmma")
        if out["tokens"].shape != (SERVE["batch"], SERVE["gen"]):
            raise AssertionError(f"serve: tokens of shape {out['tokens'].shape}")

    # the kernels' share of a prefill: from a profiler trace, and from the
    # two kernels timed alone at the serve's shapes times their launches
    B, L = SERVE["batch"], SERVE["prompt_len"]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, model.cfg.vocab_size, (B, L)), dtype=torch.int32, device=dev)
    (_, cache), wall_s, device = device_profile(
        torch, lambda: model.prefill(params, {"tokens": tokens}, cache_len=L + SERVE["gen"])
    )
    busy_s = sum(device.values())
    pos = torch.full((B,), L, dtype=torch.int32, device=dev)
    _, step_s, step_device = device_profile(torch, lambda: model.decode_step(params, cache, tokens[:, -1:], pos))
    kernel_s = {k: sum(t for n, t in device.items() if sym in n) for k, sym in KERNEL_SYMBOLS.items()}
    cfg = model.cfg
    g = torch.Generator(dev).manual_seed(1)
    q = torch.randn(B, cfg.n_heads, L, cfg.hd, generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn(B, cfg.n_kv_heads, L, cfg.hd, generator=g, device=dev).to(torch.bfloat16)
    log_a = -torch.rand(B, L, cfg.rnn_dim, generator=g, device=dev) * 0.1
    gx = torch.randn(B, L, cfg.rnn_dim, generator=g, device=dev)
    attn_ms = median_ms(torch, lambda: ops.flash_attention(q, kv, kv, causal=True, window=cfg.local_window, block_q=128, block_k=128))
    rglru_ms = median_ms(torch, lambda: ops.rglru_scan(log_a, gx))
    alone_ms = SERVE_PREFILL_LAUNCHES["flash_attention"] * attn_ms + SERVE_PREFILL_LAUNCHES["rglru_scan"] * rglru_ms
    print(
        f"serve arch={SERVE['arch']} reduced=False dtype=bfloat16 batch={B} prompt_len={L} gen={SERVE['gen']} "
        f"prefill_s={out['prefill_s']} decode_ms_per_token={out['decode_s_per_token'] * 1e3} "
        f"tokens_per_s={out['tokens_per_s']} peak_mem_gb={out['peak_mem_bytes'] / 1e9} "
        f"prefill_launches={json.dumps(out['prefill_launches'])} routes={json.dumps(routes)} "
        f"path_checked={json.dumps(checked)}",
        flush=True,
    )
    print(
        f"serve_profile prefill_wall_s={wall_s} device_busy_s={busy_s} device_idle_share={1 - busy_s / wall_s} "
        f"kernel_s={json.dumps(kernel_s)} kernel_share={sum(kernel_s.values()) / wall_s} "
        f"attention_alone_ms={attn_ms} rglru_alone_ms={rglru_ms} kernel_share_alone={alone_ms * 1e-3 / out['prefill_s']} "
        f"trace_kernels={len(device)} top={json.dumps(top_kernels(device))}",
        flush=True,
    )
    print(
        f"serve_profile_decode step_wall_s={step_s} device_busy_s={sum(step_device.values())} "
        f"device_idle_share={1 - sum(step_device.values()) / step_s} trace_kernels={len(step_device)} "
        f"top={json.dumps(top_kernels(step_device))}",
        flush=True,
    )
    print(f"card {card_line()}", flush=True)
    return out["prefill_launches"]


def run_moe_serve(torch, ops, dev):
    """grok-1-314b at full width cut to MOE_SERVE["layers"] layers, bf16,
    through ``launch/serve.py``: the weights, made at that depth, go in as
    ``serve``'s ``params``, and every model pass walks the layers the weights
    hold, so the cut needs no argument of its own.  Two serves on one set of
    weights (the first warms the allocator; both checked, the second
    reported): finite logits, exactly the launches of MOE_SERVE_PREFILL_LAUNCHES
    in the prefill and MOE_SERVE_DECODE_LAUNCHES in decode, every GEMM and
    attention launch on ``wgmma``; then one prefill and one decode step under
    the profiler: the device's idle share and the GEMM's share."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    model = Model(get_arch(MOE_SERVE["arch"]).replace(n_layers=MOE_SERVE["layers"]))
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    B, L, gen = MOE_SERVE["batch"], MOE_SERVE["prompt_len"], MOE_SERVE["gen"]
    for run in range(2):
        ops.reset_launch_counts()
        out = serve(MOE_SERVE["arch"], reduced=False, device="cuda", params=params, batch=B, prompt_len=L, gen=gen)
        routes = ops.route_launch_counts()
        if not out["logits_finite"] or out["tokens"].shape != (B, gen):
            raise AssertionError(f"moe serve: logits finite {out['logits_finite']}, tokens of shape {out['tokens'].shape}")
        if out["prefill_launches"] != MOE_SERVE_PREFILL_LAUNCHES or out["decode_launches"] != MOE_SERVE_DECODE_LAUNCHES:
            raise AssertionError(f"moe serve: prefill launches {out['prefill_launches']} (want {MOE_SERVE_PREFILL_LAUNCHES}), "
                                 f"decode {out['decode_launches']} (want {MOE_SERVE_DECODE_LAUNCHES})")
        total = {k: MOE_SERVE_PREFILL_LAUNCHES[k] + MOE_SERVE_DECODE_LAUNCHES[k] for k in ROUTED}
        if any(routes[k] != {r: total[k] if r == "wgmma" else 0 for r in routes[k]} for k in ROUTED):
            raise AssertionError(f"moe serve: launches by route {routes}, want {total} all on wgmma")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, model.cfg.vocab_size, (B, L)), dtype=torch.int32, device=dev)
    with torch.no_grad():
        (_, cache), wall_s, device = device_profile(
            torch, lambda: model.prefill(params, {"tokens": tokens}, cache_len=L + gen), expect="gmm_")
        pos = torch.full((B,), L, dtype=torch.int32, device=dev)
        _, step_s, step_device = device_profile(torch, lambda: model.decode_step(params, cache, tokens[:, -1:], pos), expect="gmm_")
    busy_s, step_busy_s = sum(device.values()), sum(step_device.values())
    gemm_s = sum(t for n, t in device.items() if "gmm_" in n)
    step_gemm_s = sum(t for n, t in step_device.items() if "gmm_" in n)
    print(
        f"serve arch={MOE_SERVE['arch']} layers={MOE_SERVE['layers']} reduced=False dtype=bfloat16 batch={B} prompt_len={L} "
        f"gen={gen} prefill_s={out['prefill_s']} decode_ms_per_token={out['decode_s_per_token'] * 1e3} "
        f"tokens_per_s={out['tokens_per_s']} peak_mem_gb={out['peak_mem_bytes'] / 1e9} "
        f"prefill_launches={json.dumps(out['prefill_launches'])} decode_launches={json.dumps(out['decode_launches'])} "
        f"routes={json.dumps(routes)}",
        flush=True,
    )
    print(
        f"serve_profile arch={MOE_SERVE['arch']} prefill_wall_s={wall_s} device_busy_s={busy_s} device_idle_share={1 - busy_s / wall_s} "
        f"gemm_s={gemm_s} gemm_share_of_busy={gemm_s / busy_s} decode_step_wall_s={step_s} decode_device_busy_s={step_busy_s} "
        f"decode_device_idle_share={1 - step_busy_s / step_s} decode_gemm_share_of_busy={step_gemm_s / step_busy_s} "
        f"top={json.dumps(top_kernels(device))} decode_top={json.dumps(top_kernels(step_device))}",
        flush=True,
    )
    return out["prefill_launches"]


def run_family_serve(torch, ops, dev, spec):
    """An encoder-decoder or vision config at full size, bf16, through
    ``launch/serve.py`` (its frontend stubs drawn there after the prompts):
    the weights, vlm gates opened, go in as ``serve``'s ``params``.  Two
    serves on one set of weights (the first warms the allocator and holds
    each kernel launch of its prefill against its plain version; both
    checked, the second reported): finite logits, tokens of (B, gen),
    exactly ``spec["prefill_attention"]`` attention launches a prefill, all
    on ``wgmma``, and none in decode; then one prefill and one decode step
    under the profiler: the device's idle share and the attention's share
    of its busy time."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    arch, B, L, gen = spec["arch"], spec["batch"], spec["prompt_len"], spec["gen"]
    model = Model(get_arch(arch))
    params = open_gates(torch, model.init(torch.Generator(dev).manual_seed(0), dev))
    want = {k: spec["prefill_attention"] if k == "flash_attention" else 0 for k in ops.launch_counts()}
    for run in range(2):
        ops.reset_launch_counts()
        with path_kernels_checked(torch, ops, f"serve {arch}") if run == 0 else contextlib.nullcontext(checked) as checked:
            out = serve(arch, reduced=False, device="cuda", params=params, batch=B, prompt_len=L, gen=gen)
        routes = ops.route_launch_counts()
        if run == 0 and checked["flash_attention"]["calls"] != want["flash_attention"]:
            raise AssertionError(f"serve {arch}: calls held against the plain versions {checked}, want {want}")
        if not out["logits_finite"] or out["tokens"].shape != (B, gen):
            raise AssertionError(f"serve {arch}: logits finite {out['logits_finite']}, tokens of shape {out['tokens'].shape}")
        if out["prefill_launches"] != want or set(out["decode_launches"].values()) != {0}:
            raise AssertionError(f"serve {arch}: prefill launches {out['prefill_launches']} (want {want}), decode {out['decode_launches']} (want none)")
        if routes["flash_attention"] != all_on("wgmma", want["flash_attention"]):
            raise AssertionError(f"serve {arch}: attention launches by route {routes['flash_attention']}, want all {want['flash_attention']} on wgmma")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, model.cfg.vocab_size, (B, L)), dtype=torch.int32, device=dev)
    batch = {"tokens": tokens, **frontend_extras(torch, model.cfg, B, dev)}
    with torch.no_grad():
        (_, cache), wall_s, device = device_profile(
            torch, lambda: model.prefill(params, batch, cache_len=L + gen), expect=KERNEL_SYMBOLS["flash_attention"])
        pos = torch.full((B,), L, dtype=torch.int32, device=dev)
        _, step_s, step_device = device_profile(torch, lambda: model.decode_step(params, cache, tokens[:, -1:], pos))
    busy_s, step_busy_s = sum(device.values()), sum(step_device.values())
    attn_s = sum(t for n, t in device.items() if KERNEL_SYMBOLS["flash_attention"] in n)
    print(
        f"serve arch={arch} reduced=False dtype=bfloat16 batch={B} prompt_len={L} gen={gen} "
        f"extras={json.dumps({k: list(v.shape) for k, v in batch.items() if k != 'tokens'})} "
        f"prefill_s={out['prefill_s']} decode_ms_per_token={out['decode_s_per_token'] * 1e3} "
        f"tokens_per_s={out['tokens_per_s']} peak_mem_gb={out['peak_mem_bytes'] / 1e9} "
        f"prefill_launches={json.dumps(out['prefill_launches'])} decode_launches={json.dumps(out['decode_launches'])} "
        f"routes={json.dumps(routes)} path_checked={json.dumps(checked)}",
        flush=True,
    )
    print(
        f"serve_profile arch={arch} prefill_wall_s={wall_s} device_busy_s={busy_s} device_idle_share={1 - busy_s / wall_s} "
        f"attention_s={attn_s} attention_share_of_busy={attn_s / busy_s} decode_step_wall_s={step_s} "
        f"decode_device_busy_s={step_busy_s} decode_device_idle_share={1 - step_busy_s / step_s} "
        f"top={json.dumps(top_kernels(device))} decode_top={json.dumps(top_kernels(step_device))}",
        flush=True,
    )
    return out["prefill_launches"]


def seed_compute_states(torch, dev, arch, kind):
    """The broker's compute runtime draws a state per (arch, step kind,
    device) from seed 0 at its first task; for the vlm family it is drawn
    here first, the same way, with the gates opened, so its tasks run the
    image path too."""
    from repro_torch.configs import get_arch
    from repro_torch.core.managers.compute import COMPUTE_RUNTIME
    from repro_torch.models.model import Model
    from repro_torch.train import step as step_lib

    model = Model(get_arch(arch).reduced())
    params, opt = step_lib.init_train_state(model, torch.Generator(dev).manual_seed(0), dev)
    COMPUTE_RUNTIME._states[(arch, kind, str(dev))] = (open_gates(torch, params), opt)


def run_compute_tasks(torch, ops, Hydra, ProviderSpec, Task, TaskState):
    """kind="compute" prefill tasks, one a family, through the broker on the
    card: ComputeRuntime -> the reduced model's prefill -> the kernels."""
    import concurrent.futures as cf

    h = Hydra(device="cuda", streaming=True, pod_store="memory")
    h.register_provider(ProviderSpec(name="cloud", platform="cloud", connector="caas"))
    h.register_provider(ProviderSpec(name="hpc", platform="hpc", connector="pilot"))
    tasks = [Task(kind="compute", arch=a, step_kind="prefill", max_retries=0) for a in COMPUTE_ARCHS]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    h.dispatch(tasks)
    _, pending = cf.wait(tasks, timeout=300)
    wall = time.perf_counter() - t0
    launches, routes = ops.launch_counts(), ops.route_launch_counts()
    if pending:
        raise AssertionError(f"compute: {len(pending)} tasks unfinished after 300 s")
    for t in tasks:
        if t.tstate != TaskState.DONE or t.result() != {"logits_shape": [2, 1, 256]}:
            raise AssertionError(f"compute: {t.arch} task ended {t.tstate.value}: {t.exception()!r}")
    if launches != COMPUTE_LAUNCHES or any(routes[k] != {r: COMPUTE_LAUNCHES[k] if r == "tf32x3" else 0 for r in routes[k]} for k in ROUTED):
        raise AssertionError(f"compute: launches {launches} by route {routes}, want {COMPUTE_LAUNCHES} (attention and GEMMs on tf32x3)")
    h.shutdown(wait=True)
    print(f"compute tasks={len(tasks)} archs={list(COMPUTE_ARCHS)} wall_s={wall} launches={json.dumps(launches)}", flush=True)


# -- the train path --------------------------------------------------------

# attention backward cases: (label, B, H, KV, Lq, Lk, hd, causal, window,
# dtype, the route the rule gives): every route's kernels, the two that took
# the last CUDA-core widths among them (fp32 at recurrentgemma-2b's hd 256,
# bf16 at hd 16)
BWD_ATTN_CASES = [
    ("llama3_8b", 2, 32, 8, 2048, 2048, 128, True, None, "bfloat16", "wgmma"),
    ("recurrentgemma_2b", 1, 10, 1, 4096, 4096, 256, True, 2048, "bfloat16", "wgmma"),
    ("hd16_reduced", 2, 4, 2, 128, 128, 16, True, 16, "float32", "tf32x3"),
    ("lq96_lk200_non_causal", 1, 4, 2, 96, 200, 64, False, None, "float32", "tf32x3"),
    ("recurrentgemma_2b_fp32", 1, 10, 1, 4096, 4096, 256, True, 2048, "float32", "tf32x3_cluster"),
    ("hd16_reduced_bf16", 2, 4, 2, 128, 128, 16, True, 16, "bfloat16", "tf32"),
    # the cross attentions of CROSS_CASES, non-causal: seamless-m4t-medium's
    # encoder and cross shape, llama-3.2-vision-11b's text to image tokens,
    # and the reduced vlm config's 8 image tokens (one partial 64-row kv block)
    ("seamless_m4t_medium", 1, 16, 16, 4096, 4096, 64, False, None, "bfloat16", "wgmma"),
    ("llama_3_2_vision_11b_cross", 1, 32, 8, 4096, 1024, 128, False, None, "bfloat16", "wgmma"),
    ("vlm_reduced_cross", 2, 4, 2, 16, 8, 16, False, None, "float32", "tf32x3"),
]
BWD_RGLRU_CASE = ("recurrentgemma_2b", 1, 4096, 2560)
# the GEMM backward (dx and dw) at the expert shapes of grok-1-314b's and
# arctic-480b's prefill of 4096 tokens, in both dtypes, timed; then
# GMM_CASES in both dtypes (ragged edges, and the mma route)
BWD_GMM_CASES = [
    ("grok_1_314b", {"E": 8, "C": 1280, "D": 6144, "F": 32768}),
    ("arctic_480b", {"E": 128, "C": 80, "D": 7168, "F": 4864}),
]
# the backward's persistent scheduler at its edges (tests/test_torch_cuda.py
# holds the same): more dw tiles than one wave, ragged, and walks that cross
# experts; a contraction shorter than one 64-deep slice (C 16); a ragged last
# slice after several full ones (C 200); an F edge (F 200); dw's short
# contraction, one slice 96 deep, at its ends (C 65 and 96)
BWD_GMM_EDGE_CASES = [
    ({"E": 40, "C": 80, "D": 384, "F": 512}, "waves"),
    ({"E": 4, "C": 16, "D": 256, "F": 512}, "c16"),
    ({"E": 3, "C": 200, "D": 256, "F": 256}, "c200"),
    ({"E": 6, "C": 128, "D": 384, "F": 200}, "f200"),
    ({"E": 5, "C": 65, "D": 256, "F": 384}, "c65"),
    ({"E": 5, "C": 96, "D": 256, "F": 384}, "c96"),
]
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = 1e-5  # the forward kernel's LSE against the plain one, relative to its largest element
TRAIN = {"arch": "recurrentgemma-2b", "steps": 3, "seq_len": 4096, "global_batch": 1}
# per step of recurrentgemma-2b (8 attention and 18 recurrent layers): the
# forward runs twice under remat="dots" (once more in the backward's recompute)
TRAIN_LAUNCHES = {"flash_attention": 16, "selective_scan": 0, "rglru_scan": 36, "moe_gmm": 0}
TRAIN_BACKWARD_LAUNCHES = {"flash_attention_bwd": 8, "selective_scan_bwd": 0, "rglru_scan_bwd": 18, "moe_gmm_bwd": 0}
# full width, depth cut (``cut``), bf16, through make_train_step, the step
# launch/train.py takes: llama3-8b's 2 layers; llama-3.2-vision-11b's one
# superblock (4 self layers and the gated
# cross layer over its 1024 image tokens, gates opened).  ``launches`` and
# ``backward``: a step's forward and backward launches (no other kernel's):
# each attention layer runs twice a step under remat="dots" and once in the
# backward
DENSE_TRAIN = {"arch": "llama3-8b", "cut": {"n_layers": 2}, "batch": 2, "seq_len": 2048, "steps": 2,
               "launches": {"flash_attention": 4}, "backward": {"flash_attention_bwd": 2}}
VLM_TRAIN = {"arch": "llama-3.2-vision-11b", "cut": {"n_layers": 5}, "batch": 1, "seq_len": 4096, "steps": 2,
             "launches": {"flash_attention": 10}, "backward": {"flash_attention_bwd": 5}}
# seamless-m4t-medium at full size (no cut), 4096 frames: 12 encoder, 12
# decoder and 12 cross attentions
ENCDEC_TRAIN = {"arch": "seamless-m4t-medium", "cut": {}, "batch": 1, "seq_len": 4096, "steps": 2,
                "launches": {"flash_attention": 72}, "backward": {"flash_attention_bwd": 36}}
# falcon-mamba-7b at full width, 8 of its 64 layers (105.3 M parameters a
# layer and a 266 M embedding at 12 bytes a parameter: 13.3 GB of weights,
# gradients and AdamW moments; the 64 layers would take ~84 GB, ROADMAP.md
# item 6): 16 chunks of 256 a layer, each run twice a step under
# remat="dots" and once in the backward.  ``check``: the first step's first
# 16 backward calls (the last layer's chunks) held against the plain
# version; ``profile``: one more step under the profiler
SSM_TRAIN = {"arch": "falcon-mamba-7b", "cut": {"n_layers": 8}, "batch": 1, "seq_len": 4096, "steps": 2,
             "launches": {"selective_scan": 2 * 16 * 8}, "backward": {"selective_scan_bwd": 16 * 8},
             "check": {"selective_scan_bwd": 16}, "profile": True}
# card against CPU in fp32, depth cut to ``cut``: (arch, batch, seq_len, the
# backward launches of the step: one an attention, three GEMMs a moe layer,
# cut); seamless-m4t-medium one encoder and one decoder layer over 512
# frames, llama-3.2-vision-11b one superblock (gates opened)
ONE_LAYER = {"n_layers": 1}
GRAD_CHECKS = [
    ("llama3-8b", 1, 256, {"flash_attention_bwd": 1, "selective_scan_bwd": 0, "rglru_scan_bwd": 0, "moe_gmm_bwd": 0}, ONE_LAYER),
    # grok-1 and vision over 128 tokens: over 256 their CPU sides took 102
    # and 32 s of one thread
    ("grok-1-314b", 1, 128, {"flash_attention_bwd": 1, "selective_scan_bwd": 0, "rglru_scan_bwd": 0, "moe_gmm_bwd": 3}, ONE_LAYER),
    ("seamless-m4t-medium", 1, 256, {"flash_attention_bwd": 3, "selective_scan_bwd": 0, "rglru_scan_bwd": 0, "moe_gmm_bwd": 0},
     {"n_layers": 1, "n_enc_layers": 1, "enc_len_train": 512}),
    ("llama-3.2-vision-11b", 1, 128, {"flash_attention_bwd": 5, "selective_scan_bwd": 0, "rglru_scan_bwd": 0, "moe_gmm_bwd": 0},
     {"n_layers": 5}),
    # falcon-mamba-7b over 512 tokens: two chunks of 256, so the gradient of
    # the state crosses from one chunk's backward into the other's
    ("falcon-mamba-7b", 1, 512, {"flash_attention_bwd": 0, "selective_scan_bwd": 2, "rglru_scan_bwd": 0, "moe_gmm_bwd": 0},
     ONE_LAYER),
]
GRAD_TOL = 1e-4
# the host must hold the weights and the gradients of the CPU side and one
# leaf more: this many times the weights' bytes
GRAD_HOST_FACTOR = 2.5
TRAIN_TASKS = (("llama3-8b", 3), ("recurrentgemma-2b", 3), ("falcon-mamba-7b", 3), ("grok-1-314b", 3),
               ("seamless-m4t-medium", 3), ("llama-3.2-vision-11b", 3))
# a reduced step: llama3-8b 2 attention layers; recurrentgemma-2b 2 attention
# and 4 recurrent layers; falcon-mamba-7b 2 layers of two 8-step chunks over
# its 16 tokens; grok-1-314b 2 attention and 2 moe layers of 3 expert GEMMs;
# seamless-m4t-medium 2 encoder, 2 decoder and 2 cross attentions;
# llama-3.2-vision-11b 2 self and 2 cross (remat="none": one forward)
TRAIN_TASK_LAUNCHES = {"flash_attention": 48, "selective_scan": 12, "rglru_scan": 12, "moe_gmm": 18}
TRAIN_TASK_BACKWARD_LAUNCHES = {"flash_attention_bwd": 48, "selective_scan_bwd": 12, "rglru_scan_bwd": 12, "moe_gmm_bwd": 18}
# grok-1-314b at full width cut to one layer, bf16: one loss and its
# gradients on the card (AdamW's state would not fit: ROADMAP.md item 6).
# Under remat="dots" the forward's attention and GEMMs run again in the
# backward (the expert products are batched over the experts)
MOE_GRAD = {"arch": "grok-1-314b", "layers": 1, "batch": 1, "seq_len": 4096}
MOE_GRAD_LAUNCHES = {"flash_attention": 2, "selective_scan": 0, "rglru_scan": 0, "moe_gmm": 6}
MOE_GRAD_BACKWARD_LAUNCHES = {"flash_attention_bwd": 1, "selective_scan_bwd": 0, "rglru_scan_bwd": 0, "moe_gmm_bwd": 3}
# the train step's kernels in a profiler trace: the forward kernels and the
# backward kernels' symbols (csrc/*_bwd*.cu): csrc/flash_attention_bwd_wgmma.cu
# is the wgmma route, csrc/flash_attention_bwd_tf32x3.cu the three TF32 ones
# (tf32x3, tf32x3_cluster, tf32: one kernel template); the row pass and the
# parts' sum (csrc/attention_bwd_rows.cuh) are every route's, and bwd_pre
# (csrc/flash_attention_bwd.cu) runs only for a caller without the LSE
WGMMA_BWD_SYMBOLS = ("attn_bwd_rowstats", "attn_bwd_kv_wgmma", "attn_bwd_kv_sum", "attn_bwd_q_wgmma")
TF32_BWD_SYMBOLS = ("attn_bwd_rowstats", "tf32_bwd_dqkv", "attn_bwd_kv_sum")
TRAIN_SYMBOLS = {
    "flash_attention": ("flash_fwd",), "selective_scan": ("scan_kernel",), "rglru_scan": ("rglru_kernel",),
    "flash_attention_bwd": tuple(dict.fromkeys(("bwd_pre",) + WGMMA_BWD_SYMBOLS + TF32_BWD_SYMBOLS)),
    "selective_scan_bwd": SS_BWD_SYMBOLS, "rglru_scan_bwd": ("rglru_bwd_kernel",),
}
ROUTE_BWD_SYMBOLS = {"wgmma": WGMMA_BWD_SYMBOLS, "tf32x3": TF32_BWD_SYMBOLS, "tf32x3_cluster": TF32_BWD_SYMBOLS, "tf32": TF32_BWD_SYMBOLS}
BACKWARD_INFO = {
    "flash_attention_bwd": ("cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu", "src/repro/models/attention.py:36"),
    "selective_scan_bwd": ("cuda", "src/repro_torch/kernels/csrc/selective_scan_bwd.cu", "src/repro/models/ssm.py:73"),
    "rglru_scan_bwd": ("cuda", "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu", "src/repro/models/rglru.py:137"),
    "moe_gmm_bwd": ("cuda", "src/repro_torch/kernels/csrc/moe_gmm_bwd.cu", "src/repro/models/moe.py:131"),
}
# the attention backward cases at the encoder-decoder and vision families' shapes
CROSS_BWD = ("seamless_m4t_medium", "llama_3_2_vision_11b_cross")
# the case each backward kernel's report row is read from
BACKWARD_WIDTH = {"flash_attention_bwd": "recurrentgemma_2b", "selective_scan_bwd": "falcon_mamba_7b",
                  "rglru_scan_bwd": "recurrentgemma_2b", "moe_gmm_bwd": "grok_1_314b"}


def check_grads(torch, got, want, dtype: str, label: str) -> float:
    """Each output against its plain version: fp32 within BWD_TOL of its
    largest element; bf16 element by element, |got - want| <= 2e-2 |want| +
    2e-2 max|want| (gradients are small numbers: atol against the largest).
    Returns the worst max-abs error and the worst of it over the largest
    element."""
    worst, worst_abs = 0.0, 0.0
    for g, w in zip(got, want):
        # in slices along the leading axis: a GEMM's fp32 dw at arctic's
        # width is 17.8 GB, and whole-tensor temporaries would not fit beside it
        n = max(1, g.shape[0] // 16)
        gs, ws = g.split(n), w.split(n)
        finite = all(bool(torch.isfinite(c).all()) for c in gs)
        if g.shape != w.shape or g.dtype != w.dtype or not finite:
            raise AssertionError(f"{label}: kernel gave {tuple(g.shape)} {g.dtype} (finite: {finite}), plain {tuple(w.shape)} {w.dtype}")
        scale = max(max(float(c.abs().max()) for c in ws), 1e-30)
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(gs, ws)) / scale
        if dtype == "bfloat16":
            tol = BWD_TOL["bfloat16"]
            n_over = sum(int(((a.float() - b.float()).abs() > tol * b.float().abs() + tol * scale).sum()) for a, b in zip(gs, ws))
            if n_over:
                raise AssertionError(f"{label}: {n_over} of {g.numel()} elements over rtol = atol = {tol:g}")
        elif not err <= BWD_TOL["float32"]:
            raise AssertionError(f"{label}: relative error {err:.3e} over {BWD_TOL['float32']:g}")
        worst, worst_abs = max(worst, err), max(worst_abs, err * scale)
    return worst_abs, worst


def attention_fwd_bound(B, H, KV, Lq, Lk, hd, causal, window, dtype: str, route) -> dict:
    """The forward's two products (S and P V) over the live pairs against
    q, k, v read and o written once (``roofline/count.py``,
    ``attention_fwd``; ``route_bounds``)."""
    from repro_torch.roofline import count

    item = 2 if dtype == "bfloat16" else 4
    return route_bounds(*count.attention_fwd(B, H, KV, Lq, Lk, hd, causal, window, item), dtype, route)


def attention_bwd_bound(B, H, KV, Lq, Lk, hd, causal, window, dtype: str, route) -> dict:
    """2.5x the forward's multiply-adds over the live pairs against q, k, v,
    o, dO read and dq, dk, dv written once (``roofline/count.py``,
    ``attention_bwd``; ``route_bounds``)."""
    from repro_torch.roofline import count

    item = 2 if dtype == "bfloat16" else 4
    return route_bounds(*count.attention_bwd(B, H, KV, Lq, Lk, hd, causal, window, item), dtype, route)


def rglru_bwd_bound(B, L, dr) -> tuple:
    """The RG-LRU backward's bytes over the memory rate; its ~6 fp32
    operations an element are far below (``roofline/count.py``,
    ``rglru_bwd``)."""
    from repro_torch.kernels.autotune import HBM_BYTES_PER_S, PEAK_OPS_PER_S
    from repro_torch.roofline import count

    ops, nbytes = count.rglru_bwd(B, L, dr)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gmm_bwd_bound(E, C, D, F, dtype: str, route, need_dx: bool = True, need_dw: bool = True) -> dict:
    """The gradients asked for, each the forward's products, against the
    operands read and the outputs written once (``roofline/count.py``,
    ``gmm_bwd``; ``route_bounds``)."""
    from repro_torch.roofline import count

    item = 2 if dtype == "bfloat16" else 4
    return route_bounds(*count.gmm_bwd(E, C, D, F, item, need_dx, need_dw), dtype, route)


def gmm_bwd_parts(torch, ops, flush, x, w, dy, out) -> dict:
    """dx alone and dw alone (``need_dw=False``, ``need_dx=False``), each
    timed as the whole call is (``ms``, ``ms_cold``, ``ms_call``) beside
    its own bound and its own ``torch.bmm`` (TF32 off) into ``out``'s
    tensors, as ``dx_*`` and ``dw_*`` keys."""
    E, C, D = x.shape
    F = w.shape[-1]
    dtype = str(x.dtype).removeprefix("torch.")
    path = expected_route("moe_gmm", {"D": D, "F": F}, dtype)
    reps = 5 if dtype == "float32" else 20
    parts = {
        "dx": (lambda: ops.moe_gmm_bwd(x, w, dy, need_dw=False), lambda: torch.bmm(dy, w.transpose(1, 2), out=out[0])),
        "dw": (lambda: ops.moe_gmm_bwd(x, w, dy, need_dx=False), lambda: torch.bmm(x.transpose(1, 2), dy, out=out[1])),
    }
    row = {}
    for part, (run, lib) in parts.items():
        row.update({f"{part}_ms": median_ms(torch, run), f"{part}_ms_cold": cold_ms(torch, run, flush, reps=reps),
                    f"{part}_ms_call": call_ms(torch, run), f"{part}_library_ms": median_ms(torch, lib)})
        bound = gmm_bwd_bound(E, C, D, F, dtype, path, need_dx=part == "dx", need_dw=part == "dw")
        row.update({f"{part}_{k}": v for k, v in bound.items()})
    assert_fp32_exact(torch)
    return row


def check_gmm_backward(torch, ops, dev, flush) -> dict:
    """The GEMM backward against its plain version (fp32 relative BWD_TOL,
    bf16 element by element, ``check_grads``) on the route its forward
    takes: at the model widths in both dtypes, timed whole beside the plain
    version and ``torch.bmm`` (TF32 off) for the same two products, and dx
    and dw each alone (``gmm_bwd_parts``); then at GMM_CASES and
    BWD_GMM_EDGE_CASES, where two calls must give bit-equal dx and dw.
    Each gradient's launch is held to its rule (``gmm_plan``;
    ``parts_dx``, ``parts_dw`` on the line)."""
    from repro_torch.kernels import ref

    rows = {}
    cases = [(label, shape, dtype, True) for label, shape in BWD_GMM_CASES for dtype in ("bfloat16", "float32")]
    cases += [(label, shape, dtype, False) for shape, label in GMM_CASES + BWD_GMM_EDGE_CASES for dtype in ("float32", "bfloat16")]
    for label, shape, dtype, timed in cases:
        E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
        dt = getattr(torch, dtype)
        g = torch.Generator(dev).manual_seed(14)
        x = torch.randn(E, C, D, generator=g, device=dev).to(dt)
        w = (torch.randn(E, D, F, generator=g, device=dev) * D ** -0.5).to(dt)
        dy = torch.randn(E, C, F, generator=g, device=dev).to(dt)
        path = expected_route("moe_gmm", shape, dtype)
        before = ops.backward_route_launch_counts()["moe_gmm_bwd"]
        got = ops.moe_gmm_bwd(x, w, dy)
        torch.cuda.synchronize()
        after = ops.backward_route_launch_counts()["moe_gmm_bwd"]
        if {r: n - before[r] for r, n in after.items()} != {r: int(r == path) for r in after}:
            raise AssertionError(f"moe_gmm_bwd {label} {dtype}: launches by route {after} from {before}, want one on {path}")
        assert_fp32_exact(torch)
        want = ref.moe_gmm_bwd_ref(x, w, dy)
        case = f"{label}_{dtype}" if not timed else (label if dtype == "bfloat16" else f"{label}_fp32")
        abs_err, err = check_grads(torch, got, want, dtype, f"moe_gmm_bwd {case}")
        del want
        row = {"kernel": "moe_gmm_bwd", "case": case, "dtype": dtype, "route": path, "max_abs_err": abs_err, "rel_err": err}
        for grad in ("dx", "dw"):
            plan = gmm_plan(torch, grad, shape, dtype, dev, x=x, w=w, dy=dy)
            row[f"parts_{grad}"] = plan["parts"] if plan else None
        if timed:
            torch.cuda.empty_cache()
            run = lambda: ops.moe_gmm_bwd(x, w, dy)
            fp32 = dtype == "float32"
            row.update({
                "ms": median_ms(torch, run), "ms_cold": cold_ms(torch, run, flush, reps=5 if fp32 else 20), "ms_call": call_ms(torch, run),
                "plain_ms": median_ms(torch, lambda: ref.moe_gmm_bwd_ref(x, w, dy), max_reps=3),
                # the same two products in one library call each, into the kernel's outputs
                "library_ms": median_ms(torch, lambda: (torch.bmm(dy, w.transpose(1, 2), out=got[0]),
                                                        torch.bmm(x.transpose(1, 2), dy, out=got[1]))),
            })
            assert_fp32_exact(torch)
            row.update(gmm_bwd_bound(E, C, D, F, dtype, path))
            row.update(gmm_bwd_parts(torch, ops, flush, x, w, dy, got))
        else:  # no atomics; a split contraction's parts are added in part order: every sum is taken in one order
            again = ops.moe_gmm_bwd(x, w, dy)
            row["bit_equal_again"] = all(torch.equal(a, b) for a, b in zip(got, again))
            if not row["bit_equal_again"]:
                raise AssertionError(f"moe_gmm_bwd {case}: a second call on the same operands gave other dx or dw")
            del again
        print("train_kernel " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        rows[case] = row
        del x, w, dy, got
        torch.cuda.empty_cache()
    return rows


def sdpa_backward(torch, q, k, v, do, causal, window):
    """SDPA's autograd backward on the same operands (a yardstick the port
    never calls): a function that runs it once, or None where SDPA refuses
    the shape."""
    import torch.nn.functional as F

    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    Lq, Lk = q.shape[2], k.shape[2]
    mask = None
    if window is not None or (causal and Lq != Lk):
        qp = torch.arange(Lq, device=q.device)[:, None]
        kp = torch.arange(Lk, device=q.device)[None, :]
        mask = (qp >= kp) if causal else torch.ones(Lq, Lk, dtype=torch.bool, device=q.device)
        if window is not None:
            mask = mask & ((qp - kp) < window)
    try:
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)
        torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)
    except RuntimeError as e:
        print(f"train_kernel sdpa_backward refused: {e}", flush=True)
        return None
    return lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)


def forward_with_lse(torch, q, k, v, causal, window, label):
    """The forward kernel's o and LSE, as the train step's forward makes them
    for the backward.  Raises unless o equals, bit for bit, the
    forward's o without LSE and LSE is within LSE_TOL (relative to its
    largest element) of the plain LSE.  Returns (o, lse, LSE's error)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    o = fa.flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    same = torch.equal(o, fa.flash_attention(q, k, v, causal=causal, window=window))
    want = ref.attention_lse_ref(q, k, causal=causal, window=window)
    err = float((lse - want).abs().max()) / float(want.abs().max())
    if not same or not err <= LSE_TOL:
        raise AssertionError(f"flash_attention {label}: o with LSE equal to o without: {same}; LSE relative error {err:.3e} (limit {LSE_TOL:g})")
    return o, lse, err


def names_kernel(name: str, sym: str) -> bool:
    """Whether a trace's kernel name is the kernel ``sym`` (a whole word:
    ``bwd_dq`` is not ``tf32x3_bwd_dqkv``)."""
    return re.search(rf"\b{sym}\b", name) is not None


def attention_bwd_operands(torch, dev, B, H, KV, Lq, Lk, hd, causal, window, dtype: str, label: str) -> tuple:
    """q, k, v, o, do, the forward kernel's LSE and its error for one
    attention-backward case (BWD_ATTN_CASES), from seed 11."""
    dt = getattr(torch, dtype)
    g = torch.Generator(dev).manual_seed(11)
    q = torch.randn(B, H, Lq, hd, generator=g, device=dev).to(dt)
    k, v = (torch.randn(B, KV, Lk, hd, generator=g, device=dev).to(dt) for _ in range(2))
    do = torch.randn(B, H, Lq, hd, generator=g, device=dev).to(dt)
    o, lse, lse_err = forward_with_lse(torch, q, k, v, causal, window, label)
    return q, k, v, o, do, lse, lse_err


def attention_kv_parts(torch, dev, B, H, KV, Lk, path) -> int:
    from repro_torch.kernels import flash_attention as fa

    return fa.kv_parts(B, KV, H, Lk, torch.cuda.get_device_properties(dev).multi_processor_count
                       // fa.CLUSTER_BLOCKS.get(path, 1), fa.KV_ROLES[path])


def bwd_kernels_traced(torch, run, path, kv_parts, label) -> list:
    """The kernels one attention-backward call off ``wgmma`` ran, by a
    profiler trace (``device_profile``): its route's and no other (the
    parts' sum only where there are parts; no ``bwd_pre``, since the
    forward's LSE is given).  Raises otherwise."""
    needed = [sym for sym in ROUTE_BWD_SYMBOLS[path] if sym != "attn_bwd_kv_sum" or kv_parts > 1]
    _, _, device = device_profile(torch, run, expect=tuple(needed))
    ran = sorted(n for n in device if "bwd" in n)
    if not all(any(names_kernel(n, sym) for n in ran) for sym in needed) or len(ran) != len(needed) or (
            any(names_kernel(n, "bwd_pre") for n in ran)):
        raise AssertionError(f"flash_attention_bwd {label}: one call ran the kernels {ran}, want {needed}")
    return ran


def rglru_bwd_operands(torch, ops, dev) -> tuple:
    """log_a (in [-0.1, 0], so the carries between segments matter), h0, y,
    dy and dh_last of BWD_RGLRU_CASE, from seed 12."""
    _, B, L, dr = BWD_RGLRU_CASE
    g = torch.Generator(dev).manual_seed(12)
    log_a = -torch.rand(B, L, dr, generator=g, device=dev) * 0.1
    gx, dy = (torch.randn(B, L, dr, generator=g, device=dev) for _ in range(2))
    h0, dh = (torch.randn(B, dr, generator=g, device=dev) for _ in range(2))
    y, _ = ops.rglru_scan(log_a, gx, h0)
    return log_a, h0, y, dy, dh


def backward_traces(torch, ops, dev) -> dict:
    """The backward kernels' trace checks, by one profiled call each: every
    attention case of BWD_ATTN_CASES off ``wgmma`` runs its route's kernels
    and no other (``bwd_kernels_traced``), the RG-LRU backward one kernel a
    call.  The kernels each ran, by case, the RG-LRU's as
    ``rglru_scan_bwd`` (``check_backward_kernels`` puts
    them on its lines).  The run takes them in a process of its own
    (``backward_traces_fresh``): after heavy use of the card CUPTI loses a
    trace's first kernels (ROADMAP.md fault 3.8)."""
    from repro_torch.kernels import flash_attention as fa

    traced = {}
    for label, B, H, KV, Lq, Lk, hd, causal, window, dtype, _ in BWD_ATTN_CASES:
        path = fa.bwd_route(getattr(torch, dtype), hd)
        if path == "wgmma":
            continue
        q, k, v, o, do, lse, _ = attention_bwd_operands(torch, dev, B, H, KV, Lq, Lk, hd, causal, window, dtype, label)
        run = lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
        traced[label] = bwd_kernels_traced(torch, run, path, attention_kv_parts(torch, dev, B, H, KV, Lk, path), label)
        del q, k, v, o, do, lse
        torch.cuda.empty_cache()
    operands = rglru_bwd_operands(torch, ops, dev)
    # one kernel a call (the scratch's zeroing is a memset)
    _, _, device = device_profile(torch, lambda: ops.rglru_scan_bwd(*operands), expect="rglru")
    kernels = sorted(n for n in device if "rglru" in n)
    if len(kernels) != 1 or TRAIN_SYMBOLS["rglru_scan_bwd"][0] not in kernels[0]:
        raise AssertionError(f"rglru_scan_bwd: one call ran the kernels {kernels}, want one {TRAIN_SYMBOLS['rglru_scan_bwd']}")
    traced["rglru_scan_bwd"] = kernels
    del operands
    torch.cuda.empty_cache()
    return traced


def backward_traces_fresh() -> dict:
    """``backward_traces`` in a process of its own (``chip_smoke.py
    --trace-checks``): after the model phase CUPTI lost the first kernels
    of every such trace and only ``device_profile``'s retry found them
    (ROADMAP.md fault 3.8; PERF.md).  The kernels each case ran; what
    ``device_profile`` counted of them is one ``trace_checks`` line."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--trace-checks"], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    lines = [line for line in out.stdout.splitlines() if line.startswith("trace_checks ")]
    if out.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"chip_smoke.py --trace-checks: exit {out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    got = json.loads(lines[0].removeprefix("trace_checks "))
    print("trace_checks " + " ".join(f"{key}={n}" for key, n in got["stats"].items()), flush=True)
    return got["traced"]


def check_backward_kernels(torch, ops, dev, flush, traced: dict):
    """Each backward kernel against its plain version on the card, timed.
    The attention backward's cases take each route the rule gives, timed as
    the train step calls them (the forward kernel's o and LSE) and also
    without LSE (``ms_lse_recomputed``: the preprocess ``bwd_pre`` computes
    it).  ``traced``: what ``backward_traces`` found of each case off wgmma
    (its route's kernels and no other: the parts' sum only where there are
    parts, no ``bwd_pre``, since the forward's LSE is given) and of the
    RG-LRU backward (one kernel a call), on the lines as
    ``kernels_per_call``; the wgmma kernels are read in ``train_profile``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rows = {}
    for label, B, H, KV, Lq, Lk, hd, causal, window, dtype, want_path in BWD_ATTN_CASES:
        path = fa.bwd_route(getattr(torch, dtype), hd)
        if path != want_path:
            raise AssertionError(f"flash_attention_bwd {label}: route {path} for {dtype} at hd {hd}, want {want_path}")
        q, k, v, o, do, lse, lse_err = attention_bwd_operands(torch, dev, B, H, KV, Lq, Lk, hd, causal, window, dtype, label)
        run = lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, lse=lse)
        run_no_lse = lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
        want = ref.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
        before = ops.backward_launch_counts()["flash_attention_bwd"]
        routes = ops.backward_route_launch_counts()["flash_attention_bwd"]
        got = run()
        torch.cuda.synchronize()
        after = ops.backward_route_launch_counts()["flash_attention_bwd"]
        if ops.backward_launch_counts()["flash_attention_bwd"] != before + 1 or after[path] != routes[path] + 1:
            raise AssertionError(f"flash_attention_bwd {label}: the wrapper did not launch its {path} kernel")
        abs_err, err = check_grads(torch, got, want, dtype, f"flash_attention_bwd {label}")
        row = {"kernel": "flash_attention_bwd", "case": label, "dtype": dtype, "route": path, "max_abs_err": abs_err, "rel_err": err}
        _, err_no_lse = check_grads(torch, run_no_lse(), want, dtype, f"flash_attention_bwd {label} without LSE")
        row.update(lse_rel_err=lse_err, rel_err_lse_recomputed=err_no_lse)
        lib = sdpa_backward(torch, q, k, v, do, causal, window)
        row.update({
            "ms": median_ms(torch, run), "ms_cold": cold_ms(torch, run, flush), "ms_call": call_ms(torch, run),
            "ms_lse_recomputed": median_ms(torch, run_no_lse),
            "plain_ms": median_ms(torch, lambda: ref.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window), max_reps=3),
            "library_ms": median_ms(torch, lib, max_reps=10) if lib is not None else None,
        })
        row.update(attention_bwd_bound(B, H, KV, Lq, Lk, hd, causal, window, dtype, path))
        row["kv_parts"] = attention_kv_parts(torch, dev, B, H, KV, Lk, path)
        if path != "wgmma":  # the call's kernels, by the trace: its route's and no other
            row["kernels_per_call"] = traced[label]
        print("train_kernel " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        rows.setdefault("flash_attention_bwd", {})[label] = row
        del q, k, v, o, do, got, lib, lse, want
        torch.cuda.empty_cache()
    label, B, L, dr = BWD_RGLRU_CASE
    log_a, h0, y, dy, dh = rglru_bwd_operands(torch, ops, dev)
    run = lambda: ops.rglru_scan_bwd(log_a, h0, y, dy, dh)
    want = ref.rglru_bwd_ref(log_a, h0, y, dy, dh)
    before = ops.backward_launch_counts()["rglru_scan_bwd"]
    got = run()
    torch.cuda.synchronize()
    if ops.backward_launch_counts()["rglru_scan_bwd"] != before + 1:
        raise AssertionError("rglru_scan_bwd: the wrapper did not count its launch")
    abs_err, err = check_grads(torch, got, want, "float32", f"rglru_scan_bwd {label}")
    row = {
        "kernel": "rglru_scan_bwd", "case": label, "dtype": "float32", "max_abs_err": abs_err, "rel_err": err,
        "kernels_per_call": len(traced["rglru_scan_bwd"]),
        "ms": median_ms(torch, run), "ms_cold": cold_ms(torch, run, flush), "ms_call": call_ms(torch, run),
        "plain_ms": median_ms(torch, lambda: ref.rglru_bwd_ref(log_a, h0, y, dy, dh), max_reps=3), "library_ms": None,
    }
    row["bound_ms"], row["bound_by"] = rglru_bwd_bound(B, L, dr)
    print("train_kernel " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    rows["rglru_scan_bwd"] = {label: row}
    del log_a, dy, h0, dh, y, got, want
    torch.cuda.empty_cache()
    rows["moe_gmm_bwd"] = check_gmm_backward(torch, ops, dev, flush)
    return rows


# the backward wrappers of ``kernels/ops.py`` the autograd Functions call, by
# the name their launches are counted under
BACKWARD_WRAPPERS = {"flash_attention_bwd": "flash_attention_bwd", "selective_scan_bwd": "selective_scan_chunk_bwd",
                     "rglru_scan_bwd": "rglru_scan_bwd", "moe_gmm_bwd": "moe_gmm_bwd"}


@contextlib.contextmanager
def backward_kernels_checked(torch, ops, label, first: dict, keep: list | None = None):
    """Holds the first ``first[kernel]`` backward launches of each kernel
    (the launches of one train step) against the plain version on the
    operands the path gave them (fp32 relative 1e-4, bf16 also element by
    element; ``check_grads_by_dtype``): the ``ops`` wrappers are swapped for ones
    that call the original (the path's own launch, counted) and then the
    plain version.  The attention backward's plain version is not given the
    forward's LSE: it computes its own, so that LSE is checked too.  The
    GEMM backward's gradients that autograd did not ask for are None on
    both sides.  Host
    copies of the first RG-LRU backward call's operands go to ``keep`` where
    it is given.  Yields {kernel: {"calls", "rel_err"}}."""
    from repro_torch.kernels import ref

    plain = {"flash_attention_bwd": ref.attention_bwd_ref, "selective_scan_bwd": ref.selective_scan_chunk_bwd_ref,
             "rglru_scan_bwd": ref.rglru_bwd_ref, "moe_gmm_bwd": ref.moe_gmm_bwd_ref}
    seen = {k: {"calls": 0, "rel_err": 0.0} for k in BACKWARD_WRAPPERS}
    originals = {k: getattr(ops, w) for k, w in BACKWARD_WRAPPERS.items()}

    def checked(kernel):
        def call(*args, **kw):
            got = originals[kernel](*args, **kw)
            if seen[kernel]["calls"] < first.get(kernel, 0):
                with torch.no_grad():  # the plain attention backward computes its own LSE
                    want = plain[kernel](*args, **{k: v for k, v in kw.items() if k != "lse"})
                asked = [(g, w) for g, w in zip(got, want) if g is not None]  # the GEMM's gradients autograd asked for
                _, err = check_grads_by_dtype(torch, [g for g, _ in asked], [w for _, w in asked],
                                              f"{label}: {kernel} call {seen[kernel]['calls']}")
                seen[kernel]["rel_err"] = max(seen[kernel]["rel_err"], err)
                seen[kernel]["calls"] += 1
            if keep is not None and not keep and kernel == "rglru_scan_bwd":
                keep.extend(a.to("cpu", copy=True) for a in args)  # on the host: the step's peak memory stays its own
            return got

        return call

    for k, w in BACKWARD_WRAPPERS.items():
        setattr(ops, w, checked(k))
    try:
        yield seen
    finally:
        for k, fn in originals.items():
            setattr(ops, BACKWARD_WRAPPERS[k], fn)


def check_rglru_carries(torch, ops, operands, dev) -> float:
    """The kernel against its plain version on a train step's own RG-LRU
    backward operands (h0, y, dy, dh_last) with log_a redrawn in [-0.1, 0],
    so that the carries between segments are not vanishingly small: at init
    the path's own log_a makes a_t underflow.  Returns the relative error."""
    from repro_torch.kernels import ref

    _, h0, y, dy, dh = (a.to(dev) for a in operands)
    g = torch.Generator(dev).manual_seed(13)
    log_a = -torch.rand(y.shape, generator=g, device=dev) * 0.1
    got = ops.rglru_scan_bwd(log_a, h0, y, dy, dh)
    want = ref.rglru_bwd_ref(log_a, h0, y, dy, dh)
    _, err = check_grads(torch, got, want, "float32", "train: rglru_scan_bwd at the path's operands, log_a in [-0.1, 0]")
    return err


def grad_family(grads) -> str | None:
    """The family of a gradient tree among those whose steps are told apart
    (moe, ssm, audio, vlm), by its keys; None for the others."""
    if "moe" in grads.get("blocks", {}):
        return "moe"
    if "a_log" in grads.get("blocks", {}):
        return "ssm"
    if "enc_blocks" in grads:
        return "audio"
    if "xattn" in grads.get("superblocks", {}):
        return "vlm"
    return None


@contextlib.contextmanager
def grad_leaves_counted(torch, by_family: dict | None = None):
    """Records, for every AdamW step taken inside, the share of parameter
    leaves whose gradient has a nonzero element (``adamw.apply_updates`` is
    wrapped; the step reads it through the module); the moe, audio and vlm
    families' steps also in ``by_family[family]`` where it is given."""
    from repro_torch.models.spec import tree_leaves
    from repro_torch.optim import adamw

    shares = []
    original = adamw.apply_updates

    def counted(cfg, params, grads, state):
        leaves = tree_leaves(grads)
        shares.append(float(torch.stack([g.ne(0).any() for g in leaves]).float().mean()))
        family = grad_family(grads)
        if by_family is not None and family is not None:
            by_family.setdefault(family, []).append(shares[-1])
        return original(cfg, params, grads, state)

    adamw.apply_updates = counted
    try:
        yield shares
    finally:
        adamw.apply_updates = original


def run_train_full_size(torch, ops, dev):
    """recurrentgemma-2b at full size, bf16, through launch/train.py."""
    from repro_torch.launch.train import train

    kept = []
    with backward_kernels_checked(torch, ops, "train", TRAIN_BACKWARD_LAUNCHES, kept) as checked, grad_leaves_counted(torch) as shares:
        ops.reset_launch_counts()
        out = train(TRAIN["arch"], reduced=False, device="cuda", log_every=0,
                    steps=TRAIN["steps"], seq_len=TRAIN["seq_len"], global_batch=TRAIN["global_batch"])
        launches, backward = ops.launch_counts(), ops.backward_launch_counts()
        backward_routes = ops.backward_route_launch_counts()["flash_attention_bwd"]
    carries_err = check_rglru_carries(torch, ops, kept, dev)
    del kept
    want_routes = all_on("wgmma", TRAIN_BACKWARD_LAUNCHES["flash_attention_bwd"] * TRAIN["steps"])
    if backward_routes != want_routes:
        raise AssertionError(f"train: attention backward launches by route {backward_routes}, want {want_routes} (bf16 on wgmma)")
    for k, n in TRAIN_BACKWARD_LAUNCHES.items():
        if checked[k]["calls"] != n:
            raise AssertionError(f"train: {checked[k]['calls']} {k} calls held against the plain version in the first step, want {n}")
    import math

    if out["steps"] != TRAIN["steps"] or not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        raise AssertionError(f"train: losses {out['losses']}, grad norms {out['grad_norms']}")
    for i, (fwd, bwd) in enumerate(zip(out["launches"], out["backward_launches"])):
        if fwd != TRAIN_LAUNCHES or bwd != TRAIN_BACKWARD_LAUNCHES:
            raise AssertionError(f"train step {i}: launches {fwd} / backward {bwd}, want {TRAIN_LAUNCHES} / {TRAIN_BACKWARD_LAUNCHES}")
    if shares != [1.0] * TRAIN["steps"]:
        raise AssertionError(f"train: share of parameter leaves with a nonzero gradient per step {shares}, want 1.0")
    if min(launches["flash_attention"], launches["rglru_scan"], backward["flash_attention_bwd"], backward["rglru_scan_bwd"]) < 1:
        raise AssertionError(f"train: a kernel of the path was not launched: {launches} {backward}")
    print(
        f"train arch={TRAIN['arch']} reduced=False dtype=bfloat16 batch={TRAIN['global_batch']} seq_len={TRAIN['seq_len']} "
        f"steps={out['steps']} step_s={json.dumps(out['step_s'])} losses={json.dumps(out['losses'])} "
        f"grad_norms={json.dumps(out['grad_norms'])} peak_mem_gb={out['peak_mem_bytes'] / 1e9} "
        f"launches_per_step={json.dumps(out['launches'][0])} backward_launches_per_step={json.dumps(out['backward_launches'][0])} "
        f"nonzero_grad_leaf_share={json.dumps(shares)} path_checked={json.dumps(checked)} "
        f"rglru_bwd_carries_rel_err={carries_err} "
        f"backward_routes={json.dumps(backward_routes)}",
        flush=True,
    )
    profile_train_step(torch, out["params"], out["opt"], dev)
    del out
    return backward, backward_routes


def kernel_seconds(device: dict, kernels) -> dict:
    """Each kernel's device time in a trace: the time of every trace kernel
    named by one of its TRAIN_SYMBOLS."""
    return {k: sum(t for n, t in device.items() if any(sym in n for sym in TRAIN_SYMBOLS[k])) for k in kernels}


def profile_train_step(torch, params, opt, dev):
    """One more recurrentgemma-2b step, on the trained state, under
    torch.profiler: the device's busy and idle time, the kernels' share and
    the largest kernels by device time."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    cfg = get_arch(TRAIN["arch"])
    fn = step_lib.make_train_step(Model(cfg), adamw.AdamWConfig())
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"], global_batch=TRAIN["global_batch"])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dc, TRAIN["steps"]).items()}
    # every kernel the step launches must show device time under its symbols
    # (a renamed symbol would read 0): the wgmma backward's four kernels
    # (the parts' sum runs where kv_parts > 1) and each other kernel's
    n_parts = fa.kv_parts(TRAIN["global_batch"], cfg.n_kv_heads, cfg.n_heads, TRAIN["seq_len"],
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    needed = [s for s in WGMMA_BWD_SYMBOLS if s != "attn_bwd_kv_sum" or n_parts > 1]
    kernels = [k for k, n in {**TRAIN_LAUNCHES, **TRAIN_BACKWARD_LAUNCHES}.items() if n]
    expect = tuple(TRAIN_SYMBOLS[k][0] for k in kernels if k != "flash_attention_bwd") + tuple(needed)
    _, wall_s, device = device_profile(torch, lambda: fn(params, opt, batch), grad=True, expect=expect)
    busy_s = sum(device.values())
    kernel_s = kernel_seconds(device, kernels)
    parts = {sym: sum(t for n, t in device.items() if sym in n) for sym in TRAIN_SYMBOLS["flash_attention_bwd"] + TRAIN_SYMBOLS["rglru_scan_bwd"]}
    missing = [k for k, t in kernel_s.items() if not t > 0] + [s for s in needed if not parts[s] > 0]
    if missing:
        raise AssertionError(f"train_profile: no device time under {missing} (symbols {TRAIN_SYMBOLS}) in a step that launches them")
    print(
        f"train_profile arch={TRAIN['arch']} step_wall_s={wall_s} device_busy_s={busy_s} device_idle_share={1 - busy_s / wall_s} "
        f"kernel_s={json.dumps(kernel_s)} kernel_share={sum(kernel_s.values()) / wall_s} backward_parts_s={json.dumps(parts)} "
        f"trace_kernels={len(device)} top={json.dumps(top_kernels(device, 8))}",
        flush=True,
    )


def run_train_width(torch, ops, dev, spec):
    """A config at full width cut to ``spec["cut"]``, bf16, through
    make_train_step, on the family's batches (frontend stubs included) and
    with the vlm gates opened: per step exactly ``spec["launches"]`` forward
    and ``spec["backward"]`` backward launches and none of another kernel,
    the attention backward's all on ``wgmma``; the first step's first
    ``spec["check"]`` backward calls of each kernel (all of them where not
    given) held against the plain version; every gradient leaf nonzero.
    With ``spec["profile"]``, one more step under the profiler: the
    device's busy and idle time, and each kernel of the step's time.
    Returns the run's backward launches."""
    import math

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    cfg = get_arch(spec["arch"]).replace(**spec["cut"])
    model = Model(cfg)
    params, opt = step_lib.init_train_state(model, torch.Generator(dev).manual_seed(0), dev)
    open_gates(torch, params)
    fn = step_lib.make_train_step(model, adamw.AdamWConfig())
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq_len"], global_batch=spec["batch"], enc_len=cfg.enc_len_train,
                    d_model=cfg.d_model, n_img_tokens=cfg.n_img_tokens, family=cfg.family)
    want_fwd = {k: spec["launches"].get(k, 0) for k in ops.LAUNCHES}
    want_bwd = {k: spec["backward"].get(k, 0) for k in ops.BACKWARD_LAUNCHES}
    want_routes = all_on("wgmma", want_bwd["flash_attention_bwd"])
    check = spec.get("check", spec["backward"])
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, losses, norms, per_step = [], [], [], []
    label = f"train {spec['arch']}"
    with backward_kernels_checked(torch, ops, label, check) as checked, grad_leaves_counted(torch) as shares:
        for i in range(spec["steps"]):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dc, i).items()}
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = fn(params, opt, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            per_step.append((ops.launch_counts(), ops.backward_launch_counts(), ops.backward_route_launch_counts()["flash_attention_bwd"]))
    for fwd, bwd, routes in per_step:
        if fwd != want_fwd or bwd != want_bwd or routes != want_routes:
            raise AssertionError(f"{label}: launches {fwd} / backward {bwd} by route {routes}, want {want_fwd} / {want_bwd} "
                                 f"(remat), the attention's on wgmma")
    if any(checked[k]["calls"] != n for k, n in check.items()) or shares != [1.0] * spec["steps"] or (
            not all(math.isfinite(x) for x in losses + norms)):
        raise AssertionError(f"{label}: checked {checked}, nonzero-gradient shares {shares}, losses {losses}")
    print(
        f"train arch={spec['arch']} layers={cfg.n_layers} cut={json.dumps(spec['cut'])} dtype=bfloat16 batch={spec['batch']} "
        f"seq_len={spec['seq_len']} extras={json.dumps({k: list(v.shape) for k, v in batch.items() if k not in ('tokens', 'labels')})} "
        f"steps={len(losses)} step_s={json.dumps(step_s)} losses={json.dumps(losses)} grad_norms={json.dumps(norms)} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated(dev) / 1e9} launches_per_step={json.dumps(per_step[0][0])} "
        f"backward_launches_per_step={json.dumps(per_step[0][1])} backward_routes_per_step={json.dumps(per_step[0][2])} "
        f"nonzero_grad_leaf_share={json.dumps(shares)} path_checked={json.dumps(checked)}",
        flush=True,
    )
    if spec.get("profile"):
        kernels = [k for k, n in {**want_fwd, **want_bwd}.items() if n]
        expect = tuple(sym for k in kernels for sym in TRAIN_SYMBOLS[k])
        _, wall_s, device = device_profile(torch, lambda: fn(params, opt, batch), grad=True, expect=expect)
        busy_s = sum(device.values())
        kernel_s = kernel_seconds(device, kernels)
        parts = {sym: sum(t for n, t in device.items() if sym in n) for k in kernels for sym in TRAIN_SYMBOLS[k]}
        missing = [sym for sym, t in parts.items() if not t > 0]
        if missing:
            raise AssertionError(f"train_profile {spec['arch']}: no device time under {missing} in a step that launches them")
        print(
            f"train_profile arch={spec['arch']} layers={cfg.n_layers} step_wall_s={wall_s} device_busy_s={busy_s} "
            f"device_idle_share={1 - busy_s / wall_s} kernel_s={json.dumps(kernel_s)} kernel_share_of_busy="
            f"{sum(kernel_s.values()) / busy_s} kernel_parts_s={json.dumps(parts)} trace_kernels={len(device)} "
            f"top={json.dumps(top_kernels(device, 8))}",
            flush=True,
        )
    return {k: sum(bwd[k] for _, bwd, _ in per_step) for k in want_bwd}


def host_available_bytes() -> int:
    """The host memory the kernel says a new allocation can take
    (``MemAvailable``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def check_grads_on_card(torch, ops, dev, arch, batch_size, seq_len, want_backward, cut, submit):
    """One loss and its gradients at full width cut to ``cut`` in fp32, on
    the card (the kernels and their backwards) and on the CPU (the plain
    versions, one thread), on the same weights (vlm gates opened) and
    batch (frontend stubs included): every leaf within
    GRAD_TOL of its scale, the backward launches ``want_backward`` all on
    ``tf32x3``, and every attention backward handed its forward's LSE.  The
    card's gradients stay on the card and cross one leaf at a time, so the
    host holds the CPU side's weights and gradients and one leaf more; where
    it has not that much memory, the check says so and is not made.  The
    CPU side and the comparison go to ``submit`` (``cpu_sides``)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves, tree_map

    cfg = get_arch(arch).replace(**cut, param_dtype="float32", compute_dtype="float32")
    model = Model(cfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch_size, enc_len=cfg.enc_len_train,
                    d_model=cfg.d_model, n_img_tokens=cfg.n_img_tokens, family=cfg.family)
    batch = batch_at(dc, 0)
    need, have = GRAD_HOST_FACTOR * 4 * model.param_count(), host_available_bytes()
    if have < need:
        print(f"train_grads arch={arch} layers={cfg.n_layers} dtype=float32 skipped=host_memory host_available_gb={have / 1e9} "
              f"need_gb={need / 1e9}", flush=True)
        return None

    def grads(params, device):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss(params, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        return loss.detach(), torch.autograd.grad(loss, leaves)

    params = open_gates(torch, model.init(torch.Generator(dev).manual_seed(0), dev))
    ops.reset_launch_counts()
    lse_passed, original = [], ops.flash_attention_bwd

    def recording(*args, **kw):  # what the autograd Function hands the backward wrapper on the card
        if args[0].is_cuda:  # another check's CPU side may call it meanwhile
            lse_passed.append(kw.get("lse") is not None)
        return original(*args, **kw)

    ops.flash_attention_bwd = recording
    try:
        t0 = time.perf_counter()
        loss_card, on_card = grads(params, dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    finally:
        ops.flash_attention_bwd = original
    launched = ops.backward_launch_counts()
    routes = ops.backward_route_launch_counts()
    for k, by in routes.items():
        if by != {r: want_backward[k] if r == "tf32x3" else 0 for r in by}:
            raise AssertionError(f"train_grads {arch}: fp32 backward launches by route {routes}, want {want_backward} all on tf32x3")
    if lse_passed != [True] * want_backward["flash_attention_bwd"]:
        raise AssertionError(f"train_grads {arch}: the forward's LSE handed to each attention backward: {lse_passed}")
    if launched != want_backward:
        raise AssertionError(f"train_grads {arch}: backward launches {launched}, want {want_backward}")
    params = tree_map(lambda t: t.detach().cpu(), params)

    def cpu_side():
        t0 = time.perf_counter()
        loss_cpu, on_cpu = grads(params, "cpu")
        cpu_s = time.perf_counter() - t0
        errs = [float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(on_card, on_cpu)]
        loss_err = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
        if max(errs) > GRAD_TOL or loss_err > GRAD_TOL:
            raise AssertionError(f"train_grads {arch}: leaf errors {errs}, loss error {loss_err}")
        print(
            f"train_grads arch={arch} layers={cfg.n_layers} cut={json.dumps(cut)} dtype=float32 batch={batch_size} seq_len={seq_len} "
            f"extras={json.dumps({k: list(v.shape) for k, v in batch.items() if k not in ('tokens', 'labels')})} leaves={len(errs)} "
            f"worst_leaf_rel_err={max(errs)} loss_rel_err={loss_err} card_s={card_s} cpu_s={cpu_s} "
            f"host_available_gb={have / 1e9} backward_launches={json.dumps(launched)} backward_routes={json.dumps(routes)} "
            f"lse_from_forward={json.dumps(lse_passed)}",
            flush=True,
        )

    submit(cpu_side)


def run_moe_grad_pass(torch, ops, dev):
    """grok-1-314b at full width cut to MOE_GRAD["layers"], bf16: one loss
    and its gradients on the card, no optimizer state.  Finite, every
    gradient leaf nonzero (the router's too), exactly the launches of
    MOE_GRAD_LAUNCHES and MOE_GRAD_BACKWARD_LAUNCHES, the backwards on
    ``wgmma``, each backward launch held against its plain version; then
    the pass alone (wall, peak memory) and under the profiler: the device's
    idle share and the GEMMs' share of its busy time, forward and
    backward."""
    import math

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves

    cfg = get_arch(MOE_GRAD["arch"]).replace(n_layers=MOE_GRAD["layers"])
    model = Model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=MOE_GRAD["seq_len"], global_batch=MOE_GRAD["batch"])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dc, 0).items()}

    def step():
        loss, metrics = model.loss(params, batch)
        return loss.detach(), metrics, torch.autograd.grad(loss, leaves)

    with backward_kernels_checked(torch, ops, "train_moe", MOE_GRAD_BACKWARD_LAUNCHES) as checked:
        ops.reset_launch_counts()
        loss, metrics, grads = step()
        torch.cuda.synchronize()
        launches, backward = ops.launch_counts(), ops.backward_launch_counts()
    routes, backward_routes = ops.route_launch_counts(), ops.backward_route_launch_counts()
    finite = math.isfinite(float(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    nonzero = float(torch.stack([g.ne(0).any() for g in grads]).float().mean())
    del grads
    if any(checked[k]["calls"] != n for k, n in MOE_GRAD_BACKWARD_LAUNCHES.items()):
        raise AssertionError(f"train_moe: backward calls held against the plain versions {checked}, want {MOE_GRAD_BACKWARD_LAUNCHES}")
    torch.cuda.reset_peak_memory_stats(dev)  # the pass again, alone: its wall and peak memory
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != MOE_GRAD_LAUNCHES or backward != MOE_GRAD_BACKWARD_LAUNCHES:
        raise AssertionError(f"train_moe: launches {launches} / backward {backward}, want {MOE_GRAD_LAUNCHES} / {MOE_GRAD_BACKWARD_LAUNCHES}")
    for by, want in ((routes, MOE_GRAD_LAUNCHES), (backward_routes, MOE_GRAD_BACKWARD_LAUNCHES)):
        for k, counts in by.items():
            if counts != {r: want[k] if r == "wgmma" else 0 for r in counts}:
                raise AssertionError(f"train_moe: {k} launches by route {counts}, want {want[k]} on wgmma")
    if not finite or nonzero != 1.0:
        raise AssertionError(f"train_moe: loss {float(loss)}, finite {finite}, share of gradient leaves nonzero {nonzero}")
    _, prof_s, device = device_profile(torch, step, grad=True, expect="gmm_bwd")
    busy_s = sum(device.values())
    bwd_s = sum(t for n, t in device.items() if "gmm_bwd" in n)
    fwd_s = sum(t for n, t in device.items() if "gmm_" in n and "gmm_bwd" not in n)
    print(
        f"train_moe arch={MOE_GRAD['arch']} layers={MOE_GRAD['layers']} dtype=bfloat16 batch={MOE_GRAD['batch']} "
        f"seq_len={MOE_GRAD['seq_len']} loss={float(loss)} aux_loss={float(metrics['aux_loss'].detach())} "
        f"z_loss={float(metrics['z_loss'].detach())} "
        f"wall_s={wall_s} peak_mem_gb={peak / 1e9} nonzero_grad_leaf_share={nonzero} launches={json.dumps(launches)} "
        f"backward_launches={json.dumps(backward)} backward_routes={json.dumps(backward_routes['moe_gmm_bwd'])} "
        f"path_checked={json.dumps(checked)}",
        flush=True,
    )
    print(
        f"train_moe_profile wall_s={prof_s} device_busy_s={busy_s} device_idle_share={1 - busy_s / prof_s} "
        f"moe_gmm_s={fwd_s} moe_gmm_bwd_s={bwd_s} moe_gmm_share_of_busy={fwd_s / busy_s} "
        f"moe_gmm_bwd_share_of_busy={bwd_s / busy_s} top={json.dumps(top_kernels(device, 8))}",
        flush=True,
    )
    return backward


def run_train_tasks(torch, ops, Hydra, ProviderSpec, Task, TaskState):
    """kind="compute" train tasks through the broker on the card, every
    family's DONE with finite metrics.  Each moe, ssm, audio and vlm step's
    gradient leaves (the router's, the scan's A and dt bias included) must
    all be nonzero."""
    import concurrent.futures as cf
    import math

    h = Hydra(device="cuda", streaming=True, pod_store="memory")
    h.register_provider(ProviderSpec(name="cloud", platform="cloud", connector="caas"))
    tasks = [Task(kind="compute", arch=a, step_kind="train", max_retries=0) for a, n in TRAIN_TASKS for _ in range(n)]
    seed_compute_states(torch, torch.device("cuda", 0), "llama-3.2-vision-11b", "train")
    by_family = {}
    with grad_leaves_counted(torch, by_family) as shares:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        h.dispatch(tasks)
        _, pending = cf.wait(tasks, timeout=300)
        wall = time.perf_counter() - t0
    launches, backward = ops.launch_counts(), ops.backward_launch_counts()
    fwd_routes, routes = ops.route_launch_counts(), ops.backward_route_launch_counts()
    if pending:
        raise AssertionError(f"train_tasks: {len(pending)} tasks unfinished after 300 s")
    for by, want in ((fwd_routes, TRAIN_TASK_LAUNCHES), (routes, TRAIN_TASK_BACKWARD_LAUNCHES)):
        for k, counts in by.items():
            if counts != {r: want[k] if r == "tf32x3" else 0 for r in counts}:
                raise AssertionError(f"train_tasks: fp32 {k} launches by route {counts}, want all {want[k]} on tf32x3")
    families = {"grok-1-314b": "moe", "falcon-mamba-7b": "ssm", "seamless-m4t-medium": "audio", "llama-3.2-vision-11b": "vlm"}
    want_shares = {f: [1.0] * sum(n for a, n in TRAIN_TASKS if families.get(a) == f) for f in families.values()}
    if by_family != want_shares:
        raise AssertionError(f"train_tasks: share of nonzero gradient leaves in each step by family {by_family}, want {want_shares}")
    for t in tasks:
        r = t.result() if t.tstate == TaskState.DONE else None
        keys = ["ce", "grad_norm", "loss", "lr", "tokens"] + (["aux_loss", "z_loss"] if t.arch == "grok-1-314b" else [])
        if r is None or sorted(r) != sorted(keys) or not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"train_tasks: {t.arch} task ended {t.tstate.value} with {r}: {t.exception()!r}")
    if launches != TRAIN_TASK_LAUNCHES or backward != TRAIN_TASK_BACKWARD_LAUNCHES:
        raise AssertionError(f"train_tasks: launches {launches} / backward {backward}, want {TRAIN_TASK_LAUNCHES} / {TRAIN_TASK_BACKWARD_LAUNCHES}")
    h.shutdown(wait=True)
    print(
        f"train_tasks tasks={len(tasks)} archs={json.dumps(dict(TRAIN_TASKS))} wall_s={wall} launches={json.dumps(launches)} "
        f"backward_launches={json.dumps(backward)} backward_routes={json.dumps(routes)} last_metrics={json.dumps(tasks[-1].result())} "
        f"nonzero_grad_leaf_share={json.dumps(shares)} by_family_nonzero_grad_leaf_share={json.dumps(by_family)}",
        flush=True,
    )


# -- the sharded phase ----------------------------------------------------------

# llama3-8b at full width cut to 2 layers, bf16, B2 x 2048, remat="dots", two
# steps from one init and one batch stream under each setup: the plain step,
# the sharded step under "tp" and "fsdp_tp" on a one-rank NCCL world's (1, 1)
# mesh, and the compressed step on that world.  A step launches the
# attention twice a layer (the forward and remat's recompute) and its
# backward once, all on wgmma.  AdamW at a peak lr of 1e-3 from the first
# step, so that each update moves the bf16 weights by several of their
# steps (at the default warmup the first lr is 3e-6, under half a bf16 step
# of a weight)
SHARDED = {"arch": "llama3-8b", "cut": {"n_layers": 2}, "batch": 2, "seq_len": 2048, "steps": 2, "remat": "dots",
           "opt": {"warmup_steps": 1, "peak_lr": 1e-3}}
SHARDED_SETUPS = ("unsharded", "tp", "fsdp_tp", "compressed")
SHARDED_LAUNCHES = {"flash_attention": 4}
SHARDED_BACKWARD = {"flash_attention_bwd": 2}
# the compressed step against the plain one: its first loss is the plain
# one's, its second within COMPRESSED_LOSS_TOL (relative), which must lie
# below what the plain run's second loss reads without its first update
# (``skipped_update_loss_rel_err``); its last update (the weights after the
# last step less those before it) is the plain step's last update in
# size within COMPRESSED_UPDATE_RATIO and in direction by a cosine of
# COMPRESSED_UPDATE_COS or more (a skipped update reads a size of 0)
# (H100 readings: 3.07e-4, a size of 0.862 and a cosine of 0.883; without
# the first update the second loss reads 7.37e-3)
COMPRESSED_LOSS_TOL = 6e-4
COMPRESSED_UPDATE_RATIO = (0.7, 1.2)
COMPRESSED_UPDATE_COS = 0.75
# one decode step at llama3-8b width, 2 layers, B4, a cache of 4096 slots
# (prompt 2048) in bf16, under tp with flash_decode against the plain decode
FLASH_DECODE = {"arch": "llama3-8b", "cut": {"n_layers": 2}, "batch": 4, "prompt_len": 2048, "cache_len": 4096}
FLASH_DECODE_TOL = 2e-2  # relative, bf16 logits


@contextlib.contextmanager
def one_rank_world(torch):
    """A ``torch.distributed`` world of one rank on NCCL, its rendezvous a
    FileStore in a temporary directory; destroyed on exit."""
    import tempfile

    import torch.distributed as dist

    torch.cuda.set_device(0)  # the rank's device, before the DeviceMesh builds its communicators
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store") as d:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            yield dist
        finally:
            dist.destroy_process_group()


def host_copy(torch, tree) -> list:
    """The leaves of a parameter tree, copied to host memory (so that a kept
    copy adds nothing to the next setup's peak device memory)."""
    from repro_torch.models.spec import tree_leaves

    return [t.detach().to("cpu", copy=True) for t in tree_leaves(tree)]


def weights_equal(torch, dev, got: list, want: list) -> bool:
    """Every host-copied leaf bit-equal, compared on the card a leaf at a time."""
    return all(bool(torch.equal(a.to(dev), b.to(dev))) for a, b in zip(got, want))


def update_agreement(torch, dev, got: tuple, want: tuple) -> tuple:
    """(|u| / |w|, cos(u, w)) of two updates given as (after, before) pairs
    of host-copied leaves, u = got[0] - got[1], w = want[0] - want[1], over
    all leaves, in fp32 on the card a leaf at a time."""
    uu = ww = uw = 0.0
    for a1, a0, b1, b0 in zip(*got, *want):
        u = a1.to(dev).float() - a0.to(dev).float()
        w = b1.to(dev).float() - b0.to(dev).float()
        uu, ww, uw = uu + float(torch.sum(u * u)), ww + float(torch.sum(w * w)), uw + float(torch.sum(u * w))
    return math.sqrt(uu / max(ww, 1e-30)), uw / max(math.sqrt(uu * ww), 1e-30)


def sharded_step_run(torch, ops, dev, model, setup: str, mesh, dc) -> dict:
    """Two steps of one setup from the same init and batches: losses, step
    seconds, peak memory, a step's launches, and the weights after the last
    step (gathered, in host memory); the plain and the compressed runs keep
    those before the last step too, the plain run its initial weights."""
    from repro_torch.data.pipeline import batch_at
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import compression_state
    from repro_torch.parallel.sharding import STRATEGIES, param_pspec_tree
    from repro_torch.train import step as step_lib

    opt_cfg = adamw.AdamWConfig(**SHARDED["opt"])
    strategy = STRATEGIES.get(setup, STRATEGIES["tp"])
    sharded = setup != "unsharded"
    gen = torch.Generator(dev).manual_seed(0)
    if sharded:
        params, opt = step_lib.init_train_state(model, gen, dev, strategy=strategy, mesh=mesh)
    else:
        params, opt = step_lib.init_train_state(model, gen, dev)
    kept = {"params0": host_copy(torch, params)} if not sharded else {}
    specs = param_pspec_tree(model.specs(), strategy, mesh) if sharded else None
    gather = (lambda t: step_lib.gather_tree(t, specs, mesh)) if sharded else (lambda t: t)
    if setup == "compressed":
        comp = compression_state(model.specs(), 1, device=dev)
        fn = step_lib.make_compressed_train_step(model, opt_cfg, strategy=strategy, mesh=mesh)
    else:
        fn = step_lib.make_train_step(model, opt_cfg, strategy=strategy if sharded else None, mesh=mesh if sharded else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s, per_step = [], [], []
    for i in range(SHARDED["steps"]):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dc, i).items()}
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if setup == "compressed":
            params, opt, comp, metrics = fn(params, opt, comp, batch)
        else:
            params, opt, metrics = fn(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        per_step.append((ops.launch_counts(), ops.backward_launch_counts(), ops.route_launch_counts()["flash_attention"],
                         ops.backward_route_launch_counts()["flash_attention_bwd"]))
        if i == SHARDED["steps"] - 2 and setup in ("unsharded", "compressed"):
            kept["params_before_last"] = host_copy(torch, gather(params))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    return {"losses": losses, "step_s": step_s, "peak_mem_gb": peak, "per_step": per_step, "params": host_copy(torch, gather(params)),
            **kept}


def run_sharded(torch, ops, dev) -> dict:
    """The sharded phase on a one-rank NCCL world: the four setups of
    SHARDED, remat "collectives" at the same shape, and the flash-decode
    step.  Returns the attention's forward and backward launches a step of
    the sharded setups."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_map
    from repro_torch.parallel.sharding import STRATEGIES
    from repro_torch.train import step as step_lib

    cfg = get_arch(SHARDED["arch"]).replace(**SHARDED["cut"], remat=SHARDED["remat"])
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=SHARDED["seq_len"], global_batch=SHARDED["batch"])
    want_fwd = {k: SHARDED_LAUNCHES.get(k, 0) for k in ops.LAUNCHES}
    want_bwd = {k: SHARDED_BACKWARD.get(k, 0) for k in ops.BACKWARD_LAUNCHES}
    n_attn, n_bwd = SHARDED_LAUNCHES["flash_attention"], SHARDED_BACKWARD["flash_attention_bwd"]
    runs = {}
    with one_rank_world(torch) as dist:
        mesh = make_local_mesh(1)
        if mesh.device_mesh is None or mesh.group("data") is None:
            raise AssertionError("sharded: the one-rank world's mesh has no process group")
        for setup in SHARDED_SETUPS:
            runs[setup] = run = sharded_step_run(torch, ops, dev, Model(cfg), setup, mesh, dc)
            torch.cuda.empty_cache()
            for fwd, bwd, routes, bwd_routes in run["per_step"]:
                if (fwd, bwd, routes, bwd_routes) != (want_fwd, want_bwd, all_on("wgmma", n_attn), all_on("wgmma", n_bwd)):
                    raise AssertionError(f"sharded {setup}: launches {fwd} / {bwd} by route {routes} / {bwd_routes}, "
                                         f"want {want_fwd} / {want_bwd} all on wgmma")
        plain = runs["unsharded"]
        base = plain["losses"]
        # what the checks below read of a plain run whose first update was
        # skipped: its second loss taken at the initial weights
        model = Model(cfg)
        with torch.no_grad():
            leaves = iter(plain["params0"])
            p0 = tree_map(lambda _: next(leaves).to(dev), model.specs())
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dc, 1).items()}
            skipped_loss = float(model.loss(p0, batch)[0])
        del p0, batch
        skipped_rel = abs(skipped_loss - base[1]) / abs(base[1])
        if not COMPRESSED_LOSS_TOL < skipped_rel:
            raise AssertionError(f"sharded: a skipped first update reads {skipped_rel}, within the compressed bound {COMPRESSED_LOSS_TOL}")
        for setup, run in runs.items():
            rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"], base)]
            ok = all(math.isfinite(x) for x in run["losses"])
            if setup == "compressed":  # int8 gradients: its second loss and last update near the plain ones
                ratio, cos = update_agreement(torch, dev, (run["params"], run["params_before_last"]),
                                              (plain["params"], plain["params_before_last"]))
                lo, hi = COMPRESSED_UPDATE_RATIO
                ok = ok and run["losses"][0] == base[0] and rel[1] <= COMPRESSED_LOSS_TOL and lo <= ratio <= hi and (
                    cos >= COMPRESSED_UPDATE_COS)
                weights = f"last_update_ratio={ratio} last_update_cos={cos}"
            else:  # one rank: the plain step's arithmetic, bit for bit
                equal = weights_equal(torch, dev, run["params"], plain["params"])
                ok = ok and run["losses"] == base and equal
                weights = f"params_bit_equal={equal}"
            if not ok:
                raise AssertionError(f"sharded {setup}: losses {run['losses']} against the plain step's {base} (relative {rel}), "
                                     f"weights against the plain step's: {weights}")
            fwd, bwd, routes, bwd_routes = run["per_step"][0]
            print(
                f"sharded setup={setup} arch={SHARDED['arch']} layers={cfg.n_layers} dtype={cfg.param_dtype} "
                f"batch={SHARDED['batch']} seq_len={SHARDED['seq_len']} remat={cfg.remat} opt={json.dumps(SHARDED['opt'])} "
                f"world={dist.get_world_size()} backend={dist.get_backend()} mesh={list(mesh.shape)} steps={len(run['losses'])} "
                f"step_s={json.dumps(run['step_s'])} losses={json.dumps(run['losses'])} loss_rel_err={json.dumps(rel)} "
                f"bit_equal={run['losses'] == base} {weights} "
                f"skipped_update_loss_rel_err={skipped_rel} peak_mem_gb={run['peak_mem_gb']} "
                f"attention_launches_per_step={fwd['flash_attention']} attention_routes={json.dumps(routes)} "
                f"backward_launches_per_step={bwd['flash_attention_bwd']} backward_routes={json.dumps(bwd_routes)}",
                flush=True,
            )

        # remat "collectives": only the post_collective outputs are saved, so
        # the backward recomputes each layer's attention, as under "dots"
        col = sharded_step_run(torch, ops, dev, Model(cfg.replace(remat="collectives")), "unsharded", None, dc)
        torch.cuda.empty_cache()
        fwd, bwd, routes, bwd_routes = col["per_step"][0]
        equal = weights_equal(torch, dev, col["params"], plain["params"])
        if any(p[:2] != (want_fwd, want_bwd) for p in col["per_step"]) or col["losses"] != base or not equal:
            raise AssertionError(f"sharded remat=collectives: launches {col['per_step']}, losses {col['losses']} against "
                                 f"{base}, weights bit-equal {equal}")
        print(
            f"sharded_remat policy=collectives arch={SHARDED['arch']} layers={cfg.n_layers} batch={SHARDED['batch']} "
            f"seq_len={SHARDED['seq_len']} step_s={json.dumps(col['step_s'])} losses={json.dumps(col['losses'])} "
            f"bit_equal={col['losses'] == base} params_bit_equal={equal} "
            f"peak_mem_gb={col['peak_mem_gb']} dots_peak_mem_gb={plain['peak_mem_gb']} "
            f"attention_launches_per_step={fwd['flash_attention']} attention_routes={json.dumps(routes)} "
            f"backward_launches_per_step={bwd['flash_attention_bwd']} backward_routes={json.dumps(bwd_routes)}",
            flush=True,
        )
        tp_fwd, tp_bwd = runs["tp"]["per_step"][0][:2]
        del runs, col, plain

        # the distributed flash-decode against the plain decode attention
        fd = FLASH_DECODE
        dcfg = get_arch(fd["arch"]).replace(**fd["cut"])
        model = Model(dcfg)
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        gen = torch.Generator(dev).manual_seed(1)
        toks = torch.randint(0, dcfg.vocab_size, (fd["batch"], fd["prompt_len"] + 1), generator=gen, device=dev, dtype=torch.int32)
        _, cache = step_lib.make_prefill_step(model, fd["cache_len"])(params, {"tokens": toks[:, :-1]})
        batch = {"tokens": toks[:, -1:], "pos": torch.full((fd["batch"],), fd["prompt_len"], dtype=torch.int32, device=dev)}
        strategy = dataclasses.replace(STRATEGIES["tp"], name="tp_fd", flash_decode=True)
        plain_decode = step_lib.make_decode_step(model)
        flash = step_lib.make_decode_step(model, strategy=strategy, mesh=mesh)
        want, _ = plain_decode(params, cache, batch)
        got, _ = flash(params, cache, batch)
        err = rel_err(got, want)
        if not (err <= FLASH_DECODE_TOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"flash_decode: logits relative error {err} (<= {FLASH_DECODE_TOL})")
        ms = {name: call_ms(torch, lambda f=f: f(params, cache, batch)) for name, f in (("flash", flash), ("plain", plain_decode))}
        print(
            f"flash_decode arch={fd['arch']} layers={dcfg.n_layers} dtype={dcfg.compute_dtype} batch={fd['batch']} "
            f"cache_len={fd['cache_len']} pos={fd['prompt_len']} world={dist.get_world_size()} rel_err={err} "
            f"step_ms={ms['flash']} plain_step_ms={ms['plain']}",
            flush=True,
        )
        del params, cache
        torch.cuda.empty_cache()
    return {"flash_attention": tp_fwd["flash_attention"], "flash_attention_bwd": tp_bwd["flash_attention_bwd"]}


# the port's examples on the card: (module, keyword arguments, the kernels
# whose launches must be nonzero); serve_lm reaches the attention and both
# scans, train_lm's fp32 100M llama the attention and its backward on tf32x3
EXAMPLES = [
    ("quickstart", {}, ("flash_attention",)),
    ("facts_workflow", {}, ()),
    ("serve_lm", {}, ("flash_attention", "selective_scan", "rglru_scan")),
    ("train_lm", {"steps": 200}, ("flash_attention",)),
]


def run_examples(torch, ops, dev) -> dict:
    """Each example's ``main`` on the card, its output ending in ``OK``:
    its launches per kernel (forward and backward) and by route."""
    import importlib
    import io

    out = {}
    for name, kwargs, must in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        ops.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(device=dev.type, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = buf.getvalue().rstrip().splitlines()
        fwd, bwd = ops.launch_counts(), ops.backward_launch_counts()
        routes, bwd_routes = ops.route_launch_counts(), ops.backward_route_launch_counts()
        missing = [k for k in must if not fwd[k]]
        if not lines or lines[-1] != "OK" or missing:
            raise AssertionError(f"example {name}: last line {lines[-1:]}, no launches of {missing}\n" + "\n".join(lines[-20:]))
        if name == "train_lm":  # fp32: the attention and its backward on tf32x3, every step
            attn, attn_bwd = routes["flash_attention"], bwd_routes["flash_attention_bwd"]
            if not (bwd["flash_attention_bwd"] and attn["tf32x3"] == fwd["flash_attention"] and attn_bwd["tf32x3"] == bwd["flash_attention_bwd"]):
                raise AssertionError(f"example train_lm: attention routes {attn}, backward {attn_bwd}")
        out[name] = fwd
        print(
            f"example name={name} ok=true wall_s={wall} launches={json.dumps(fwd)} backward_launches={json.dumps(bwd)} "
            f"routes={json.dumps({k: {r: n for r, n in v.items() if n} for k, v in routes.items()})} "
            f"backward_routes={json.dumps({k: {r: n for r, n in v.items() if n} for k, v in bwd_routes.items()})} "
            f"last_lines={json.dumps(lines[-3:])}",
            flush=True,
        )
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# tp: tensor parallelism over a (1, 2) mesh of two gloo ranks on the one card
# ---------------------------------------------------------------------------

# NCCL refuses two ranks on one GPU, so the two ranks of the (1, 2) mesh
# ("data", "model") meet over gloo, which carries each collective of a CUDA
# tensor through host memory: the times show the path, not what NVLink or a
# 16-way "model" axis costs.  Each case runs in this process on one rank (no
# mesh) and on the two ranks, from the same weights (drawn from one seed on
# the card) and the same batch, twice: in bf16, the models' own dtype, and
# in fp32 (the twin), where one rank and two differ only by the order of
# fp32 sums.  The train case takes two AdamW steps at a peak lr of 1e-3 from
# the first step; a leaf's update error is the norm of the ranks' gathered
# leaf less one rank's, over the norm of one rank's update of that leaf.
# - Updates: AdamW moves an element whose gradient is near 0 by about lr
#   whatever its sign, so an update has a floor of noise in either dtype,
#   which one rank's run again from the weights nudged by one step of their
#   dtype here and there reads, leaf by leaf: each leaf's update error must
#   stay within TP_NOISE_FACTOR of its dtype times its own (in bf16 a
#   row-parallel product also sums bf16 partial results where one rank sums
#   in fp32; in fp32 the ranks' sums in another order move every leaf's
#   update about twice what the nudge does).  AdamW's update does not see a
#   gradient's scale, so the gradient norms are held too.
# - The fp32 twin: the losses and gradient norms within TP_FP32_TOL["loss"]
#   (relative), the last token's logits within TP_FP32_TOL["logits"] of the
#   largest, and the greedy tokens equal on every row whose top two logits
#   lie further apart than twice that; a case with no such row fails.
# - bf16: the losses within TP_TOL, the gradient norms and the logits within
#   TP_NOISE_FACTOR of what the nudge moves one rank's, or TP_TOL where that
#   is more.
# - Both: the local shapes the kernels saw (TP_LOCAL), and each kernel's
#   first call on each rank held against its plain version on the same
#   operands, at the rank's local shapes (``tp_plain_check``: WIDTH_TOL and
#   bf16 element by element for the forwards, ``check_grads`` for the
#   attention backward).
# The fp32 twin of arctic-480b keeps 64 of its 128 experts (TP_FP32_CUT):
# 128 experts take 53.5 GB a layer in fp32, and a rank drawing its half
# beside the other's would leave the card under 10 GB.
# - Decode: after each prefill the ranks take TP_DECODE_STEPS decode steps
#   on their own caches (the rank's KV heads, channels and rows, as the
#   prefill leaves them), fed the tokens one rank's greedy decode of the
#   same weights took, and each step's logits are held as the prefill's
#   (fp32: TP_FP32_TOL["logits"], the greedy tokens equal on the rows that
#   tolerance cannot swap; bf16: TP_NOISE_FACTOR of what the nudge moves
#   one rank's decode, or TP_TOL), with moe_gmm's first decode call held
#   against its plain version at the rank's experts.  The flash-decode case
#   cuts llama3-8b to one KV head: with 8, "model" divides the KV heads, a
#   rank's cache holds its own and its query heads read only them, so the
#   sequence split has nothing to do (models/attention.py).
# - The compressed step (bf16) takes the train case's two steps on the same
#   mesh: its first loss is the plain "tp" step's bit for bit (the same
#   forward), its second within TP_TOL of it.
# "serve_2dtp" runs on a (2, 2) world of four gloo ranks on the card
# (SERVE2D): the dense prefill case and its decode steps, held against one
# rank as above, with no parameter gathered by any rank.
TP_WORLD = 2
TP_TOL = 2e-2  # bf16
TP_FP32_TOL = {"loss": 1e-5, "logits": 1e-4}
TP_OPT = {"warmup_steps": 1, "peak_lr": 1e-3}
TP_NOISE_FACTOR = {"bfloat16": 2.0, "float32": 4.0}
TP_DTYPES = ("bfloat16", "float32")
TP_TRAIN = {"arch": "llama3-8b", "cut": {"n_layers": 2}, "batch": 2, "seq_len": 2048, "steps": 2, "remat": "dots"}
# the train case under each strategy of a "model" axis: "tp" (the config's
# default), the sequence-parallel pair, and "fsdp" (its split dims over
# ("data", "model"), read after the per-layer gather)
TP_TRAIN_STRATEGIES = ("tp", "tp_sp", "fsdp_tp_sp", "fsdp")
TP_PREFILLS = [  # under the config's default strategy, or the case's
    # 8 of 26 layers (two superblocks and the two-layer tail): gloo's
    # all-reduces of the 26 took 21 s a run in both dtypes
    {"arch": "recurrentgemma-2b", "cut": {"n_layers": 8}, "batch": 4, "seq_len": 4096},
    {"arch": "falcon-mamba-7b", "cut": {"n_layers": 2}, "batch": 1, "seq_len": 4096},
    {"arch": "falcon-mamba-7b", "cut": {"n_layers": 2}, "batch": 1, "seq_len": 4096, "strategy": "tp_sp"},
    {"arch": "arctic-480b", "cut": {"n_layers": 1}, "batch": 1, "seq_len": 4096},
    {"arch": "llama3-8b", "cut": {"n_layers": 2}, "batch": 4, "seq_len": 2048},
    # the distributed flash-decode on sharded weights: one KV head, which
    # "model" cannot divide, so each rank's cache holds it whole
    {"arch": "llama3-8b", "cut": {"n_layers": 2, "n_kv_heads": 1}, "batch": 4, "seq_len": 2048, "flash_decode": True},
]
TP_FP32_CUT = {"arctic-480b": {"n_experts": 64}}
TP_DECODE_STEPS = 4
# what a rank's decode launches a step, by case (moe_gmm: gate, up and down
# a layer); the other kernels have no decode launch (decode attention is
# plain, as in the reference)
TP_DECODE_LAUNCHES = {"arctic-480b": {"moe_gmm": 3}}
SERVE2D_MESH = (2, 2)
SERVE2D_CASE = TP_PREFILLS[4]  # llama3-8b, full width, 2 layers, B4 x 2048, bf16
SERVE2D_TIMEOUT_S = 300
# what a rank's kernels see at the local shapes, by case: attention
# (query heads, key heads), the RG-LRU's dr, the scan's di, the GEMM's experts
TP_LOCAL = {
    "llama3-8b": {"flash_attention": (16, 4), "flash_attention_bwd": (16, 4)},
    "llama3-8b/flash_decode": {"flash_attention": (16, 1)},
    "recurrentgemma-2b": {"flash_attention": (5, 1), "rglru_scan": 1280},
    "falcon-mamba-7b": {"selective_scan": 4096},
    "arctic-480b": {"flash_attention": (28, 4), "moe_gmm": 64},
}
TP_LOCAL_FP32 = {"arctic-480b": {"moe_gmm": 32}}
TP_TIMEOUT_S = 480
# the model path's kernels under tp, by the ``ops`` wrapper each launches from
TP_WRAPPERS = {"flash_attention": "flash_attention", "flash_attention_bwd": "flash_attention_bwd",
               "rglru_scan": "rglru_scan", "selective_scan": "selective_scan_chunk", "moe_gmm": "moe_gmm"}


def _tp_shape_of(name: str, args) -> object:
    """The local dims a kernel call shows (``TP_LOCAL``'s keys)."""
    if name in ("flash_attention", "flash_attention_bwd"):
        return (args[0].shape[1], args[1].shape[1])
    if name == "rglru_scan":
        return args[0].shape[-1]
    if name == "selective_scan":
        return args[0].shape[-1]
    return args[0].shape[0]  # moe_gmm: experts


def tp_local(arch: str, dtype: str) -> dict:
    return {**TP_LOCAL[arch], **(TP_LOCAL_FP32.get(arch, {}) if dtype == "float32" else {})}


def tp_strategy(case: dict, cfg):
    """A case's strategy: the case's, or the config's default, with the
    flash-decode where the case asks for it."""
    import dataclasses

    from repro_torch.parallel.sharding import STRATEGIES, default_strategy

    strategy = STRATEGIES[case["strategy"]] if "strategy" in case else default_strategy(cfg)
    if case.get("flash_decode"):
        strategy = dataclasses.replace(strategy, name=strategy.name + "_fd", flash_decode=True)
    return strategy


def one_key(case: dict) -> str:
    """The one-rank run a case is held against: its arch and cut (a
    strategy's case shares the config's)."""
    return json.dumps([case["arch"], case["cut"]], sort_keys=True)


def decode_run(torch, decode, params, cache, logits, pos: int, dev, tokens=None) -> dict:
    """TP_DECODE_STEPS decode steps after a prefill: fed ``tokens`` (one
    (B, 1) host tensor a step), or greedily from the prefill's ``logits``
    and each step's.  Returns each step's logits (host, fp32), the tokens
    fed, and each step's milliseconds."""
    out = {"logits": [], "tokens": [], "ms": []}
    for i in range(TP_DECODE_STEPS):
        tok = tokens[i] if tokens is not None else logits[:, -1].argmax(-1)[:, None].int().cpu()
        batch = {"tokens": tok.to(dev), "pos": torch.full((tok.shape[0],), pos + i, dtype=torch.int32, device=dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, batch)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["logits"].append(logits.float().cpu())
        out["tokens"].append(tok)
    return out


def tp_measured(torch, fn):
    """``fn()`` timed, with the launches by kernel and route, and the
    collectives by op (bytes and calls) and the parameter bytes gathered,
    since the counters' reset here."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import tensor as tp

    ops.reset_launch_counts()
    tp.COLLECTIVES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, {"s": time.perf_counter() - t0, "launches": ops.launch_counts(), "backward": ops.backward_launch_counts(),
                    "routes": ops.route_launch_counts(), "backward_routes": ops.backward_route_launch_counts(),
                    "collectives": dict(tp.COLLECTIVES.bytes_by_op), "collective_calls": dict(tp.COLLECTIVES.count_by_op),
                    "params_gathered": tp.COLLECTIVES.param_bytes}


def _kept(torch, t):
    """A call's operand or output as kept for the check after the run: a
    copy, or from 1 GiB up the tensor itself (a weight, which the run does
    not change)."""
    if not isinstance(t, torch.Tensor):
        return t
    t = t.detach()
    return t if t.numel() * t.element_size() >= 1 << 30 else t.clone()


@contextlib.contextmanager
def recording_kernel_calls(torch, ops):
    """The ``ops`` wrappers of TP_WRAPPERS, each recording the local dims of
    its calls (``_tp_shape_of``) and keeping its first call's operands and
    outputs (``_kept``).  Yields {kernel: {"shapes": set, "first": (args,
    kwargs, outputs)}}."""
    seen: dict = {}
    real = {attr: getattr(ops, attr) for attr in TP_WRAPPERS.values()}

    def wrap(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            rec = seen.setdefault(name, {"shapes": set(), "first": None})
            rec["shapes"].add(_tp_shape_of(name, args))
            if rec["first"] is None:
                rec["first"] = ([_kept(torch, a) for a in args], {k: _kept(torch, v) for k, v in kwargs.items()},
                                [_kept(torch, o) for o in as_tuple(out)])
            return out
        return call

    for name, attr in TP_WRAPPERS.items():
        setattr(ops, attr, wrap(name, real[attr]))
    try:
        yield seen
    finally:
        for attr, fn in real.items():
            setattr(ops, attr, fn)


def tp_plain_check(torch, seen: dict, label: str) -> dict:
    """Each kernel's first call in ``seen`` held against its plain version
    on the same operands (the forwards by ``check_plain``, the attention
    backward by ``check_grads``): {kernel: relative error}; raises over the
    tolerance."""
    from repro_torch.kernels import ref

    errs = {}
    for name, rec in seen.items():
        args, kwargs, got = rec["first"]
        where = f"{label}: {name} at local {_tp_shape_of(name, args)}"
        if name == "flash_attention_bwd":
            want = ref.attention_bwd_ref(*args, **kwargs)
            errs[name] = check_grads(torch, got, want, str(args[0].dtype).removeprefix("torch."), where)[1]
        else:
            want = as_tuple(plain_version(TP_WRAPPERS[name])(*args, **kwargs))
            errs[name] = max(check_plain(torch, g, w, where) for g, w in zip(got, want))
        del want
    return errs


def init_shards(torch, dist, model, dev, specs, mesh):
    """A rank's shards of the weights ``init_params`` draws from seed 0 on
    ``dev``: each leaf drawn whole in fp32, in its order, and only the
    rank's slice cast to its dtype, so that no rank holds the whole model;
    the ranks draw one after the other, as an fp32 draw of arctic's largest
    leaf alone takes 16.6 GiB."""
    import dataclasses

    from repro_torch.models.spec import _init_leaf, torch_dtype, tree_leaves, tree_map
    from repro_torch.train import step as step_lib

    def draw(s, gen, spec):
        full = _init_leaf(dataclasses.replace(s, dtype="float32"), gen, dev)
        part = full[step_lib.local_slices(full.shape, spec, mesh)]
        return torch.empty(part.shape, dtype=torch_dtype(s.dtype), device=dev).copy_(part)

    params = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            gen, flat = torch.Generator(dev).manual_seed(0), iter(tree_leaves(specs))
            params = tree_map(lambda s: draw(s, gen, next(flat)), model.specs())
            torch.cuda.empty_cache()
        dist.barrier()
    return params


def tp_cfg(case: dict, dtype: str = "bfloat16"):
    from repro_torch.configs import get_arch

    cfg = get_arch(case["arch"]).replace(**case["cut"])
    if "remat" in case:
        cfg = cfg.replace(remat=case["remat"])
    if dtype == "float32":
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32", **TP_FP32_CUT.get(case["arch"], {}))
    return cfg


def tp_batches(torch, case: dict, cfg) -> list:
    """A case's batches (one a step; a prefill's one), on the host."""
    from repro_torch.data.pipeline import DataConfig, batch_at

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=case["seq_len"], global_batch=case["batch"])
    return [{k: torch.from_numpy(v) for k, v in batch_at(dc, i).items()} for i in range(case.get("steps", 1))]


def gloo_cuda_probe(torch, dist, rank: int, world: int, dev) -> dict:
    """all_reduce, all_gather, broadcast and reduce_scatter_tensor of
    tensors on ``dev`` on gloo: "ok", or the error gloo raised."""
    out = {}
    x = torch.full((4,), float(rank + 1), device=dev)
    tests = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "reduce_scatter": lambda: (getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor)(
            torch.empty(4 // world, device=dev), x.clone()),
    }
    for name, fn in tests.items():
        try:
            fn()
            out[name] = "ok"
        except Exception as e:  # reported: the phase fails on it below
            out[name] = f"{type(e).__name__}: {e}"[:200]
    return out


def tp_rank_cases(torch, dist, rank: int, mesh, dev, dtype: str, ref_path: str, decode_path: str) -> dict:
    """On one rank, each case in ``dtype`` on ``mesh`` under the config's
    default strategy ("tp" for every case): losses or logits, step seconds,
    peak memory (allocated and reserved), launches forward and backward by
    route, the local shapes the kernels saw, the kernels against their plain
    versions there, and the collective bytes by op; in bf16 the compressed
    step too; after each prefill its decode steps, fed the one-rank run's
    tokens (``decode_path``)."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import STRATEGIES, default_strategy, param_pspec_tree
    from repro_torch.train import step as step_lib

    measured = functools.partial(tp_measured, torch)

    def peaks() -> dict:
        return {"peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9}

    out = {"train": {}}
    cfg = tp_cfg(TP_TRAIN, dtype)
    model = Model(cfg)
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    for name in TP_TRAIN_STRATEGIES:
        strategy = default_strategy(cfg) if name == "tp" else STRATEGIES[name]
        torch.cuda.reset_peak_memory_stats(dev)
        params, opt = step_lib.init_train_state(model, torch.Generator(dev).manual_seed(0), dev, strategy=strategy, mesh=mesh)
        fn = step_lib.make_train_step(model, adamw.AdamWConfig(**TP_OPT), strategy=strategy, mesh=mesh)
        steps = []
        with recording_kernel_calls(torch, ops) as seen:
            for batch in tp_batches(torch, TP_TRAIN, cfg):
                batch = {k: v.to(dev) for k, v in batch.items()}
                (params, opt, metrics), row = measured(lambda: fn(params, opt, batch))
                row.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))
                steps.append(row)
        sums = shard_update_sums(torch, dist, params, param_pspec_tree(model.specs(), strategy, mesh), mesh, ref, dev)
        out["train"][name] = {"strategy": strategy.name, "steps": steps, **peaks(),
                              "shapes": {k: sorted(v["shapes"]) for k, v in seen.items()},
                              "plain": tp_plain_check(torch, seen, f"tp train {name} {dtype} rank {rank}"),
                              "update_sums": sums}
        del params, opt, fn, seen
        torch.cuda.empty_cache()
    if dtype == "bfloat16":  # the compressed step: the train case's steps, its gradients reduced in int8
        strategy = default_strategy(cfg)
        params, opt = step_lib.init_train_state(model, torch.Generator(dev).manual_seed(0), dev, strategy=strategy, mesh=mesh)
        comp = step_lib.init_compression_state(model, strategy=strategy, mesh=mesh, device=dev)
        fn = step_lib.make_compressed_train_step(model, adamw.AdamWConfig(**TP_OPT), strategy=strategy, mesh=mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        steps = []
        for batch in tp_batches(torch, TP_TRAIN, cfg):
            batch = {k: v.to(dev) for k, v in batch.items()}
            (params, opt, comp, metrics), row = measured(lambda: fn(params, opt, comp, batch))
            row.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))
            steps.append(row)
        out["compressed"] = {"strategy": strategy.name, "steps": steps, **peaks()}
        del params, opt, comp, fn
        torch.cuda.empty_cache()
    tokens = torch.load(decode_path, weights_only=False)
    for case in TP_PREFILLS:
        out[tp_key(case)] = tp_rank_prefill_decode(torch, dist, rank, mesh, dev, dtype, case, tp_strategy(case, tp_cfg(case, dtype)),
                                                   tokens[one_key(case)])
    return out


def tp_rank_prefill_decode(torch, dist, rank: int, mesh, dev, dtype: str, case: dict, strategy, tokens: list) -> dict:
    """On one rank, a prefill case under ``strategy`` on ``mesh``: the
    prefill (logits, seconds, peak, launches, collectives, local shapes,
    the kernels against their plain versions) and ``decode_run`` on the
    rank's cache fed ``tokens`` (each step's logits, milliseconds, the
    decode's launches and collectives, moe_gmm's first decode call against
    its plain version).  Logits on rank 0 only."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import param_pspec_tree
    from repro_torch.train import step as step_lib

    cfg = tp_cfg(case, dtype)
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_shards(torch, dist, model, dev, param_pspec_tree(model.specs(), strategy, mesh), mesh)
    prefill = step_lib.make_prefill_step(model, case["seq_len"] + TP_DECODE_STEPS, strategy=strategy, mesh=mesh)
    batch = {"tokens": tp_batches(torch, case, cfg)[0]["tokens"].to(dev)}
    with recording_kernel_calls(torch, ops) as seen:
        (logits, cache), row = tp_measured(torch, lambda: prefill(params, batch))
    row.update(strategy=strategy.name, peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9, shapes={k: sorted(v["shapes"]) for k, v in seen.items()},
               plain=tp_plain_check(torch, seen, f"tp {tp_key(case)} {dtype} rank {rank}"),
               logits=logits.float().cpu() if rank == 0 else None)
    del seen
    decode = step_lib.make_decode_step(model, strategy=strategy, mesh=mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    with recording_kernel_calls(torch, ops) as seen:
        dec, counts = tp_measured(torch, lambda: decode_run(torch, decode, params, cache, logits, case["seq_len"], dev, tokens))
    if rank:
        dec["logits"] = None
    row["decode"] = {**dec, **counts, "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                     "shapes": {k: sorted(v["shapes"]) for k, v in seen.items()},
                     "plain": tp_plain_check(torch, {k: v for k, v in seen.items() if k == "moe_gmm"},
                                             f"tp decode {tp_key(case)} {dtype} rank {rank}")}
    del params, logits, cache, seen
    torch.cuda.empty_cache()
    return row


def tp_key(case: dict) -> str:
    """A prefill case's name: its arch, and its strategy or flash-decode
    where it names one."""
    return case["arch"] + (f"/{case['strategy']}" if "strategy" in case else "") + ("/flash_decode" if case.get("flash_decode") else "")


def tp_rank_run(torch, dist, rank: int, world: int, dev, ref_dir: str) -> dict:
    """On one rank: the probe, then ``tp_rank_cases`` in each of TP_DTYPES
    on the (1, world) mesh (one rank's train weights in ``ref_dir``)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_local_mesh

    out = {"probe": gloo_cuda_probe(torch, dist, rank, world, dev)}
    if any(v != "ok" for v in out["probe"].values()):
        return out
    _build.load(*_build.SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mesh = make_local_mesh(world, world)
    for dtype in TP_DTYPES:
        out[dtype] = tp_rank_cases(torch, dist, rank, mesh, dev, dtype, os.path.join(ref_dir, f"train_{dtype}.pt"),
                                   os.path.join(ref_dir, f"decode_{dtype}.pt"))
    return out


def serve2d_rank_run(torch, dist, rank: int, world: int, dev, ref_dir: str) -> dict:
    """On one rank of the SERVE2D_MESH world: SERVE2D_CASE's prefill and
    decode steps under "serve_2dtp" in bf16 (``tp_rank_prefill_decode``)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.sharding import STRATEGIES

    _build.load(*_build.SOURCES)
    mesh = make_local_mesh(world, SERVE2D_MESH[1])
    tokens = torch.load(os.path.join(ref_dir, "decode_bfloat16.pt"), weights_only=False)[one_key(SERVE2D_CASE)]
    return tp_rank_prefill_decode(torch, dist, rank, mesh, dev, "bfloat16", SERVE2D_CASE, STRATEGIES["serve_2dtp"], tokens)


def tp_rank_main(rank: int, world: int, tmp: str, ref_dir: str, what: str = "tp") -> None:
    """A spawned rank: a gloo world over a FileStore in ``tmp``, its results
    saved there (``rank<r>.pt``), its traceback too where it fails; ``what``
    names the run ("tp": ``tp_rank_run``, "serve2d": ``serve2d_rank_run``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import traceback

    # two ranks and this process share the card: freed blocks of one size
    # serve a later draw of another
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world), rank=rank, world_size=world)
        run = {"tp": tp_rank_run, "serve2d": serve2d_rank_run}[what]
        torch.save(run(torch, dist, rank, world, torch.device("cuda", 0), ref_dir), os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        Path(tmp, f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_one_rank_train(torch, dev, case: dict, dtype: str) -> dict:
    """A train case in ``dtype`` on this process's one rank, no mesh: its
    losses, gradient norms, step seconds, peak memory, initial and final
    weights (host), and again from nudged weights (``nudge``): the gradient
    norms and each leaf's update error."""
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    cfg = tp_cfg(case, dtype)
    model = Model(cfg)
    torch.zeros(1, device=dev)  # the allocator's state for dev exists before its peak is reset
    out = {}
    for nudged in (False, True):
        torch.cuda.reset_peak_memory_stats(dev)
        params, opt = step_lib.init_train_state(model, torch.Generator(dev).manual_seed(0), dev)
        if nudged:
            nudge(torch, params, dev)
        start = host_copy(torch, params)
        fn = step_lib.make_train_step(model, adamw.AdamWConfig(**TP_OPT))
        losses, norms, step_s = [], [], []
        for batch in tp_batches(torch, case, cfg):
            batch = {k: v.to(dev) for k, v in batch.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = fn(params, opt, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        if nudged:
            out.update(nudged_grad_norms=norms, nudged_leaf_errs=update_errs(torch, dev, host_copy(torch, params), out["params"], start))
        else:
            out = {"losses": losses, "grad_norms": norms, "step_s": step_s, "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                   "params": host_copy(torch, params), "start": start, "names": leaf_names(params)}
        del params, opt, fn, start
        torch.cuda.empty_cache()
    return out


def tp_one_rank(torch, dev, dtype: str) -> dict:
    """Every tp case in ``dtype`` on this process's one rank, no mesh: the
    train case's (``tp_one_rank_train``), and by ``one_key`` each prefill's
    logits (host), seconds and peak memory, its greedy decode steps
    (``decode_run``), and both again from nudged weights (the decode fed
    the same tokens)."""
    from repro_torch.models.model import Model
    from repro_torch.train import step as step_lib

    out = {"train": tp_one_rank_train(torch, dev, TP_TRAIN, dtype)}
    for case in TP_PREFILLS:
        if one_key(case) in out:  # a strategy's case: one rank has no strategy
            continue
        cfg = tp_cfg(case, dtype)
        model = Model(cfg)
        torch.cuda.reset_peak_memory_stats(dev)
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        prefill = step_lib.make_prefill_step(model, case["seq_len"] + TP_DECODE_STEPS)
        decode = step_lib.make_decode_step(model)
        batch = {"tokens": tp_batches(torch, case, cfg)[0]["tokens"].to(dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        row = {"s": time.perf_counter() - t0, "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "logits": logits.float().cpu()}
        row["decode"] = decode_run(torch, decode, params, cache, logits, case["seq_len"], dev)
        nudge(torch, params, dev)
        logits, cache = prefill(params, batch)
        row["nudged_logits"] = logits.float().cpu()
        row["nudged_decode"] = decode_run(torch, decode, params, cache, logits, case["seq_len"], dev, row["decode"]["tokens"])["logits"]
        out[one_key(case)] = row
        del params, logits, cache
        torch.cuda.empty_cache()
    return out


def nudge(torch, params, dev) -> None:
    """Each nonzero weight one step of its dtype up, down or not (a draw
    from seed 1), in place: the noise of one rounding, to read what it moves."""
    from repro_torch.models.spec import tree_leaves

    gen = torch.Generator(dev).manual_seed(1)
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    chunk = 1 << 26  # elements a draw: arctic's largest leaf holds 4.5e9
    for p in tree_leaves(params):
        words = p.view(-1).view(bits[p.dtype])
        for i in range(0, words.numel(), chunk):
            seg = words[i:i + chunk]
            seg.add_(torch.randint(-1, 2, seg.shape, generator=gen, device=dev, dtype=seg.dtype) * (seg != 0))


def leaf_names(tree, prefix: str = "") -> list:
    """The paths of a parameter tree's leaves, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def update_errs(torch, dev, got: list, want: list, start: list) -> list:
    """Each leaf's update error: norm(got - want) / norm(want - start), of
    host-copied leaves, in fp32 on the card a leaf at a time (0 where the
    leaf did not move and ``got`` equals ``want``, inf where only ``got``
    moved)."""
    errs = []
    for g, w, w0 in zip(got, want, start):
        w = w.to(dev).float()
        d = float((g.to(dev).float() - w).norm())
        u = float((w - w0.to(dev).float()).norm())
        errs.append(d / u if u else (0.0 if d == 0 else math.inf))
    return errs


def shard_update_sums(torch, dist, params, specs, mesh, ref: dict, dev, chunk: int = 1 << 26) -> list:
    """What ``update_errs`` reads, summed over the world's shards: for each
    leaf, the squared distance of this rank's shard from the same slice of
    one rank's final weights (``ref["params"]``, host leaves) and the
    squared size of one rank's update there (from ``ref["start"]``), both
    summed over the ranks (fp64 sums; a leaf whole on several ranks counts
    once a rank in both, so their ratio is the leaf's).  A leaf is taken
    ``chunk`` elements at a time along its first dim, so the fp32 copies
    stay small beside the ranks' state.  Every rank calls it; no rank
    gathers the weights."""
    from repro_torch.models.spec import tree_leaves
    from repro_torch.train import step as step_lib

    sums = []
    for p, spec, w, w0 in zip(tree_leaves(params), tree_leaves(specs), ref["params"], ref["start"]):
        sl = step_lib.local_slices(tuple(w.shape), spec, mesh)
        parts = [(p, w[sl], w0[sl])]
        if p.dim() and p.numel() > chunk:
            rows = max(1, chunk // (p.numel() // p.shape[0]))
            parts = [(p[i:i + rows], w[sl][i:i + rows], w0[sl][i:i + rows]) for i in range(0, p.shape[0], rows)]
        leaf = torch.zeros(2, dtype=torch.float64, device=dev)
        for pc, wc, w0c in parts:
            wc = wc.to(dev).float()
            d = pc.float() - wc
            leaf[0] += torch.sum(d * d, dtype=torch.float64)
            d = wc - w0c.to(dev).float()
            leaf[1] += torch.sum(d * d, dtype=torch.float64)
            del wc, d
        sums.append(leaf)
    total = torch.stack(sums)
    dist.all_reduce(total)
    return total.cpu().tolist()


def errs_of_sums(sums: list) -> list:
    """``update_errs``' ratios from ``shard_update_sums``."""
    return [math.sqrt(d / u) if u else (0.0 if d == 0 else math.inf) for d, u in sums]


def save_update_ref(torch, one: dict, path) -> None:
    """One rank's initial and final weights (host leaves) for the ranks'
    ``shard_update_sums``."""
    torch.save({"params": one["params"], "start": one["start"]}, path)


def tp_check_train(torch, dev, dtype: str, one: dict, tr: list, card: str) -> list:
    """The train case's ``tp`` line in ``dtype``; returns what is off (the
    checks above TP_WORLD)."""
    bf16 = dtype == "bfloat16"
    losses, norms = [s["loss"] for s in tr[0]["steps"]], [s["grad_norm"] for s in tr[0]["steps"]]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, one["losses"]))
    norm_err = max(abs(a - b) / abs(b) for a, b in zip(norms, one["grad_norms"]))
    norm_floor = max(abs(a - b) / abs(b) for a, b in zip(one["nudged_grad_norms"], one["grad_norms"]))
    loss_tol = TP_TOL if bf16 else TP_FP32_TOL["loss"]
    norm_tol = max(TP_TOL, TP_NOISE_FACTOR[dtype] * norm_floor) if bf16 else TP_FP32_TOL["loss"]
    errs = errs_of_sums(tr[0]["update_sums"])
    limits = [TP_NOISE_FACTOR[dtype] * n for n in one["nudged_leaf_errs"]]
    worst = max(range(len(errs)), key=lambda i: errs[i] / limits[i] if limits[i] else math.inf)
    last = tr[0]["steps"][-1]
    print(f"tp case=train dtype={dtype} arch={TP_TRAIN['arch']} layers={TP_TRAIN['cut']['n_layers']} batch={TP_TRAIN['batch']} "
          f"seq_len={TP_TRAIN['seq_len']} mesh=1x{TP_WORLD} strategy={tr[0]['strategy']} backend=gloo "
          f"losses={losses} one_rank_losses={one['losses']} loss_rel_err={loss_err} grad_norms={norms} "
          f"one_rank_grad_norms={one['grad_norms']} grad_norm_rel_err={norm_err} nudged_grad_norm_rel_err={norm_floor} "
          f"leaf_update_errs={json.dumps(dict(zip(one['names'], errs)))} "
          f"nudged_leaf_update_errs={json.dumps(dict(zip(one['names'], one['nudged_leaf_errs'])))} "
          f"worst_leaf={one['names'][worst]} worst_leaf_err={errs[worst]} worst_leaf_limit={limits[worst]} "
          f"kernel_vs_plain_rel_err={json.dumps([r['plain'] for r in tr])} "
          f"step_s={[s['s'] for s in tr[0]['steps']]} rank1_step_s={[s['s'] for s in tr[1]['steps']]} "
          f"one_rank_step_s={one['step_s']} peak_mem_gb_rank={[r['peak_mem_gb'] for r in tr]} "
          f"peak_reserved_gb_rank={[r['peak_reserved_gb'] for r in tr]} one_rank_peak_mem_gb={one['peak_mem_gb']} "
          f"launches={json.dumps(last['launches'])} backward_launches={json.dumps(last['backward'])} "
          f"routes={json.dumps(last['routes']['flash_attention'])} "
          f"backward_routes={json.dumps(last['backward_routes']['flash_attention_bwd'])} "
          f"local_shapes={json.dumps(tr[0]['shapes'])} collective_bytes={json.dumps(last['collectives'])} "
          f"collective_calls={json.dumps(last['collective_calls'])} card={card}", flush=True)
    off = tp_shapes_off(TP_TRAIN["arch"], dtype, tr)
    if not (loss_err <= loss_tol and norm_err <= norm_tol):
        off.append(f"tp train {tr[0]['strategy']} {dtype}: loss error {loss_err} (tolerance {loss_tol}), gradient norm error {norm_err} "
                   f"(tolerance {norm_tol})")
    if not all(e <= lim for e, lim in zip(errs, limits)):
        off.append(f"tp train {tr[0]['strategy']} {dtype}: leaf {one['names'][worst]}'s update error {errs[worst]} over its limit "
                   f"{limits[worst]}")
    wgmma = last["routes"]["flash_attention"]["wgmma"]
    if not last["launches"]["flash_attention"] or not last["backward"]["flash_attention_bwd"] or (wgmma == last["launches"]["flash_attention"]) != bf16:
        off.append(f"tp train {tr[0]['strategy']} {dtype}: attention launches {last['launches']} by route {last['routes']}, "
                   f"backward {last['backward']}")
    return off


def tp_shapes_off(arch: str, dtype: str, rows: list, names=None) -> list:
    """What is off in the local shapes the rows' kernels saw: every kernel
    of ``tp_local``, or of ``names`` among them."""
    return [f"tp {arch} {dtype} rank {r}: {name} at local {row['shapes'].get(name)}, want [{want}]"
            for r, row in enumerate(rows) for name, want in tp_local(arch, dtype).items()
            if (names is None or name in names) and row["shapes"].get(name) != [want]]


def local_key(case: dict) -> str:
    return case["arch"] + ("/flash_decode" if case.get("flash_decode") else "")


def logits_agreement(torch, got, want, nudged, bf16: bool) -> dict:
    """``got`` against ``want`` (host logits, the last token's): the error
    relative to the largest logit, the tolerance (bf16: TP_NOISE_FACTOR of
    the nudge's, or TP_TOL; fp32: TP_FP32_TOL), and the greedy tokens,
    equal on every row whose top two the tolerance cannot swap."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    floor = float((nudged - want).abs().max()) / scale
    tol = max(TP_TOL, TP_NOISE_FACTOR["bfloat16" if bf16 else "float32"] * floor) if bf16 else TP_FP32_TOL["logits"]
    greedy, greedy_one = got[:, -1].argmax(-1), want[:, -1].argmax(-1)
    top2 = want[:, -1].topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    tied = gap <= 2 * tol * scale  # rows whose top two the allowed error could swap
    return {"err": err, "tol": tol, "floor": floor, "greedy": greedy.tolist(), "greedy_one": greedy_one.tolist(), "gap": gap.tolist(),
            "tied": tied.tolist(), "greedy_equal": bool(torch.equal(greedy, greedy_one)),
            "untied_equal": bool(torch.equal(greedy[~tied], greedy_one[~tied])), "all_tied": bool(tied.all())}


def tp_check_decode(torch, dtype: str, case: dict, one: dict, rows: list, card: str, label: str = "tp", mesh: str = "") -> list:
    """A prefill case's decode steps' line (``<label> case=decode``) in
    ``dtype``; returns what is off: a step's logits against one rank's,
    moe_gmm's launches a step where the case launches it."""
    bf16, arch = dtype == "bfloat16", case["arch"]
    dec = rows[0]["decode"]
    steps = [logits_agreement(torch, g, w, n, bf16) for g, w, n in zip(dec["logits"], one["decode"]["logits"], one["nudged_decode"])]
    want_launches = {k: n * TP_DECODE_STEPS * tp_cfg(case, dtype).n_layers for k, n in TP_DECODE_LAUNCHES.get(arch, {}).items()}
    launches = {k: n for k, n in dec["launches"].items() if n}
    print(f"{label} case=decode dtype={dtype} arch={arch} cut={json.dumps(case['cut'])} batch={case['batch']} "
          f"prompt={case['seq_len']} steps={TP_DECODE_STEPS} mesh={mesh or f'1x{TP_WORLD}'} strategy={rows[0]['strategy']} "
          f"backend=gloo logits_rel_err={[a['err'] for a in steps]} logits_tol={[a['tol'] for a in steps]} "
          f"nudged_logits_rel_err={[a['floor'] for a in steps]} greedy_equal={[a['greedy_equal'] for a in steps]} "
          f"greedy_equal_untied={[a['untied_equal'] for a in steps]} tied_rows={[a['tied'] for a in steps]} "
          f"ms_per_token_rank={[r['decode']['ms'] for r in rows]} one_rank_ms_per_token={one['decode']['ms']} "
          f"peak_mem_gb_rank={[r['decode']['peak_mem_gb'] for r in rows]} launches={json.dumps(launches)} "
          f"want_launches={json.dumps(want_launches)} kernel_vs_plain_rel_err={json.dumps([r['decode']['plain'] for r in rows])} "
          f"local_shapes={json.dumps(dec['shapes'])} collective_bytes={json.dumps(dec['collectives'])} "
          f"collective_calls={json.dumps(dec['collective_calls'])} params_gathered_bytes={[r['decode']['params_gathered'] for r in rows]} "
          f"card={card}", flush=True)
    off = tp_shapes_off(local_key(case), dtype, [r["decode"] for r in rows], names=("moe_gmm",))
    for i, a in enumerate(steps):
        if not (a["err"] <= a["tol"] and a["untied_equal"] and (bf16 or not a["all_tied"])):
            off.append(f"{label} decode {tp_key(case)} {dtype} step {i}: logits error {a['err']} (tolerance {a['tol']}), greedy "
                       f"{a['greedy']} vs {a['greedy_one']} (rows the tolerance could swap: {a['tied']})")
    if any({k: n for k, n in r["decode"]["launches"].items() if n} != want_launches for r in rows):
        off.append(f"{label} decode {tp_key(case)} {dtype}: launches {[r['decode']['launches'] for r in rows]}, want {want_launches}")
    if "moe_gmm" in want_launches and any("moe_gmm" not in r["decode"]["plain"] for r in rows):
        off.append(f"{label} decode {tp_key(case)} {dtype}: moe_gmm's decode call not held against its plain version")
    return off


def tp_check_prefill(torch, dtype: str, case: dict, one: dict, rows: list, card: str, label: str = "tp", mesh: str = "") -> list:
    """A prefill case's ``<label>`` line in ``dtype``, and its decode's
    (``tp_check_decode``); returns what is off: the ranks' logits against
    one rank's, a kernel of the case that did not launch."""
    bf16, arch = dtype == "bfloat16", case["arch"]
    a = logits_agreement(torch, rows[0]["logits"], one["logits"], one["nudged_logits"], bf16)
    err, tol, floor, tied = a["err"], a["tol"], a["floor"], a["tied"]
    greedy, greedy_one, untied_equal = a["greedy"], a["greedy_one"], a["untied_equal"]
    cfg = tp_cfg(case, dtype)
    print(f"{label} case=prefill dtype={dtype} arch={arch} layers={cfg.n_layers} experts={cfg.n_experts} kv_heads={cfg.n_kv_heads} "
          f"batch={case['batch']} seq_len={case['seq_len']} mesh={mesh or f'1x{TP_WORLD}'} strategy={rows[0]['strategy']} backend=gloo "
          f"logits_rel_err={err} logits_tol={tol} nudged_logits_rel_err={floor} greedy_equal={a['greedy_equal']} "
          f"greedy_equal_untied={untied_equal} tied_rows={tied} greedy={greedy} one_rank_greedy={greedy_one} "
          f"one_rank_top2_gap={a['gap']} kernel_vs_plain_rel_err={json.dumps([r['plain'] for r in rows])} "
          f"s={[r['s'] for r in rows]} one_rank_s={one['s']} "
          f"peak_mem_gb_rank={[r['peak_mem_gb'] for r in rows]} peak_reserved_gb_rank={[r['peak_reserved_gb'] for r in rows]} "
          f"one_rank_peak_mem_gb={one['peak_mem_gb']} "
          f"launches={json.dumps({k: n for k, n in rows[0]['launches'].items() if n})} "
          f"routes={json.dumps({k: {q: n for q, n in v.items() if n} for k, v in rows[0]['routes'].items()})} "
          f"local_shapes={json.dumps(rows[0]['shapes'])} collective_bytes={json.dumps(rows[0]['collectives'])} "
          f"collective_calls={json.dumps(rows[0]['collective_calls'])} params_gathered_bytes={[r['params_gathered'] for r in rows]} "
          f"card={card}", flush=True)
    fwd = tuple(k for k in tp_local(local_key(case), dtype) if not k.endswith("_bwd"))
    off = tp_shapes_off(local_key(case), dtype, rows, names=fwd)
    if not (err <= tol and untied_equal and (bf16 or not a["all_tied"])):
        off.append(f"{label} {tp_key(case)} {dtype}: logits error {err} (tolerance {tol}), greedy {greedy} vs "
                   f"{greedy_one} (rows the tolerance could swap: {tied})")
    missing = [k for k in fwd if k in rows[0]["launches"] and not rows[0]["launches"][k]]
    if missing:
        off.append(f"{label} {tp_key(case)} {dtype}: no launch of {missing}: {rows[0]['launches']}")
    return off + tp_check_decode(torch, dtype, case, one, rows, card, label, mesh)


def run_tp(torch, ops, dev) -> tuple:
    """The tp phase: the one-rank runs here, then the two gloo ranks, then
    the four of "serve_2dtp"; one ``tp`` line a case and dtype, one for
    each case's decode, the compressed step's, and the ``serve_2dtp``
    lines.  Returns rank 0's launches of each kernel over the tp world's
    cases in both dtypes (forward and backward; the train case's last
    step; the decode steps), and those of its decode steps alone."""
    import tempfile

    card = card_line()
    one = {dtype: tp_one_rank(torch, dev, dtype) for dtype in TP_DTYPES}
    torch.cuda.empty_cache()
    reserved_here = torch.cuda.memory_reserved(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_ref") as ref_dir:
        for dtype in TP_DTYPES:
            save_update_ref(torch, one[dtype]["train"], os.path.join(ref_dir, f"train_{dtype}.pt"))
            torch.save({k: r["decode"]["tokens"] for k, r in one[dtype].items() if k != "train"},
                       os.path.join(ref_dir, f"decode_{dtype}.pt"))
        t0 = time.perf_counter()
        ranks, min_free = run_ranks_on_card(torch, dev, tp_rank_main, TP_WORLD, TP_TIMEOUT_S, (ref_dir,), "tp")
        world_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        world2d = SERVE2D_MESH[0] * SERVE2D_MESH[1]
        serve2d, min_free_2d = run_ranks_on_card(torch, dev, tp_rank_main, world2d, SERVE2D_TIMEOUT_S, (ref_dir, "serve2d"),
                                                 "serve2d")
        serve2d_s = time.perf_counter() - t0
    print(f"tp probe backend=gloo device=cuda ops={json.dumps(ranks[0]['probe'])} card={card}", flush=True)
    if any(v != "ok" for r in ranks for v in r["probe"].values()):
        raise AssertionError(f"tp: gloo refused a collective on CUDA tensors: {[r['probe'] for r in ranks]}")
    launches: dict = {}
    decode_launches: dict = {}

    def add(counts: dict) -> None:
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    def decode_launches_of(counts: dict) -> None:
        for k, n in counts.items():
            decode_launches[k] = decode_launches.get(k, 0) + n

    off = []
    for dtype in TP_DTYPES:
        for name in TP_TRAIN_STRATEGIES:
            tr = [r[dtype]["train"][name] for r in ranks]
            add(tr[0]["steps"][-1]["launches"])
            add(tr[0]["steps"][-1]["backward"])
            off += tp_check_train(torch, dev, dtype, one[dtype]["train"], tr, card)
        for case in TP_PREFILLS:
            rows = [r[dtype][tp_key(case)] for r in ranks]
            add(rows[0]["launches"])
            add(rows[0]["decode"]["launches"])
            decode_launches_of(rows[0]["decode"]["launches"])
            off += tp_check_prefill(torch, dtype, case, one[dtype][one_key(case)], rows, card)
    off += tp_check_compressed(ranks, card)
    off += tp_check_prefill(torch, "bfloat16", SERVE2D_CASE, one["bfloat16"][one_key(SERVE2D_CASE)], serve2d, card, "serve_2dtp",
                            "x".join(map(str, SERVE2D_MESH)))
    if any(r["params_gathered"] or r["decode"]["params_gathered"] for r in serve2d):
        off.append(f"serve_2dtp: parameters gathered, prefill {[r['params_gathered'] for r in serve2d]} bytes, decode "
                   f"{[r['decode']['params_gathered'] for r in serve2d]}")
    total = torch.cuda.mem_get_info(dev)[1]
    print(f"tp world_s={world_s} ranks={TP_WORLD} serve2d_world_s={serve2d_s} serve2d_ranks={world2d} backend=gloo "
          f"card_total_gb={total / 1e9} card_min_free_gb={min_free / 1e9} serve2d_card_min_free_gb={min_free_2d / 1e9} "
          f"reserved_here_gb={reserved_here / 1e9} note=host-memory collectives, not NVLink card={card}", flush=True)
    if off:
        raise AssertionError("\n".join(off))
    return launches, decode_launches


def tp_check_compressed(ranks: list, card: str) -> list:
    """The compressed step's ``tp case=compressed`` line; returns what is
    off: a first loss other than the plain "tp" step's, a second off it by
    more than TP_TOL."""
    comp, plain = ranks[0]["bfloat16"]["compressed"], ranks[0]["bfloat16"]["train"]["tp"]
    losses, plain_losses = [s["loss"] for s in comp["steps"]], [s["loss"] for s in plain["steps"]]
    second = abs(losses[1] - plain_losses[1]) / abs(plain_losses[1])
    last = comp["steps"][-1]
    print(f"tp case=compressed dtype=bfloat16 arch={TP_TRAIN['arch']} layers={TP_TRAIN['cut']['n_layers']} batch={TP_TRAIN['batch']} "
          f"seq_len={TP_TRAIN['seq_len']} mesh=1x{TP_WORLD} strategy={comp['strategy']} backend=gloo losses={losses} "
          f"plain_losses={plain_losses} first_loss_equal={losses[0] == plain_losses[0]} second_loss_rel_err={second} "
          f"grad_norms={[s['grad_norm'] for s in comp['steps']]} step_s={[s['s'] for s in comp['steps']]} "
          f"peak_mem_gb_rank={[r['bfloat16']['compressed']['peak_mem_gb'] for r in ranks]} "
          f"collective_bytes={json.dumps(last['collectives'])} collective_calls={json.dumps(last['collective_calls'])} card={card}",
          flush=True)
    if losses[0] != plain_losses[0] or not second <= TP_TOL:
        return [f"tp compressed: losses {losses} against the plain step's {plain_losses} (second within {TP_TOL})"]
    return []


# ---------------------------------------------------------------------------
# fsdp: a layer at a time over "data", two gloo ranks on the one card
# ---------------------------------------------------------------------------

# The (2, 1) mesh: each rank takes one row of the batch, holds its shard of
# every parameter (under "fsdp_tp" the "embed" dims cut over "data"; under
# "tp" whole, its moments cut by ZeRO-1) and gathers one layer's at a time
# inside the layer's remat (ROADMAP.md item 6c).  Each strategy's two bf16
# steps are held against one rank's, as the tp phase holds its train case
# (the losses within TP_TOL, the gradient norms and each leaf's update
# within TP_NOISE_FACTOR of what the one-step nudge moves one rank's), and
# each rank's peak (``max_memory_allocated`` over the steps, the state
# resident) against the port's dry run of the same step on an abstract
# (2, 1) mesh (``launch/dryrun``: a rank's argument bytes plus its peak
# temp), which it may exceed by FSDP_PEAK_OVER_DRYRUN at most.
# ``python3 chip_smoke.py --fsdp-peak SRC`` runs the two ranks alone on the
# tree at SRC (a parent's, to compare peaks in one call) and prints one
# ``fsdp_peak`` line a strategy.
FSDP_CASE = {"arch": "llama3-8b", "cut": {"n_layers": 8}, "batch": 2, "seq_len": 2048, "steps": 2, "remat": "dots"}
FSDP_STRATEGIES = ("fsdp_tp", "tp")
FSDP_WORLD = 2
FSDP_PEAK_OVER_DRYRUN = 0.10
FSDP_TIMEOUT_S = 480


def fsdp_dryrun(cfg, strategy: str) -> dict:
    """The dry run's count of the case's train step on an abstract (2, 1)
    mesh: a rank's argument bytes, its peak temp and its collectives."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    shape = ShapeConfig("fsdp", FSDP_CASE["seq_len"], FSDP_CASE["batch"], "train")
    fn, args, meta = dryrun.build_cell(cfg, shape, Mesh(("data", "model"), (FSDP_WORLD, 1)), strategy)
    counts, io = dryrun.run_counted(fn, args, meta)
    return {"argument_bytes": int(io["argument"]), "temp_bytes": int(counts.peak_temp_bytes),
            "collective_bytes": dict(counts.collectives.bytes_by_op), "collective_calls": dict(counts.collectives.count_by_op)}


def fsdp_rank_run(torch, dist, rank: int, dev, ref_path: str = "") -> dict:
    """On one rank of the (2, 1) mesh, each of FSDP_STRATEGIES: two steps
    from seed 0's weights (the peak reset once the state is built), each
    step's loss, gradient norm, seconds and collectives, the peak, the
    update sums against one rank's weights at ``ref_path`` where given
    (``shard_update_sums``), and on rank 0 the dry run's count."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.parallel import tensor as tp
    from repro_torch.parallel.sharding import STRATEGIES, param_pspec_tree
    from repro_torch.train import step as step_lib

    mesh = make_local_mesh(FSDP_WORLD)
    cfg = tp_cfg(FSDP_CASE)
    model = Model(cfg)
    ref = torch.load(ref_path, mmap=True, weights_only=True) if ref_path else None
    out = {}
    for name in FSDP_STRATEGIES:
        strategy = STRATEGIES[name]
        params, opt = step_lib.init_train_state(model, torch.Generator(dev).manual_seed(0), dev, strategy=strategy, mesh=mesh)
        fn = step_lib.make_train_step(model, adamw.AdamWConfig(**TP_OPT), strategy=strategy, mesh=mesh)
        batches = [{k: v.to(dev) for k, v in b.items()} for b in tp_batches(torch, FSDP_CASE, cfg)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state_gb = torch.cuda.memory_allocated(dev) / 1e9
        steps = []
        for batch in batches:
            tp.COLLECTIVES.reset()
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = fn(params, opt, batch)
            torch.cuda.synchronize()
            steps.append({"s": time.perf_counter() - t0, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                          "collective_bytes": dict(tp.COLLECTIVES.bytes_by_op), "collective_calls": dict(tp.COLLECTIVES.count_by_op),
                          "launches": ops.launch_counts(), "backward": ops.backward_launch_counts()})
        row = {"steps": steps, "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "state_gb": state_gb}
        if ref is not None:
            row["update_sums"] = shard_update_sums(torch, dist, params, param_pspec_tree(model.specs(), strategy, mesh), mesh, ref, dev)
        del params, opt, fn, batches
        torch.cuda.empty_cache()
        if rank == 0:
            row["dryrun"] = fsdp_dryrun(cfg, name)
        out[name] = row
    return out


def fsdp_rank_main(rank: int, world: int, tmp: str, src: str, ref_path: str = "") -> None:
    """A spawned rank of the fsdp world, on the port at ``src``: a gloo
    world over a FileStore in ``tmp``, its results saved there."""
    sys.path.insert(0, src)
    import traceback

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world), rank=rank, world_size=world)
        from repro_torch.kernels import _build

        _build.load(*_build.SOURCES)
        torch.save(fsdp_rank_run(torch, dist, rank, torch.device("cuda", 0), ref_path), os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        Path(tmp, f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks_on_card(torch, dev, target, world: int, timeout_s: float, args=(), label: str = "") -> tuple:
    """``target(rank, world, tmp, *args)`` in processes of their own: their
    results in rank order (``rank<r>.pt`` in ``tmp``), and the least free
    memory of the card while they ran (``torch.cuda.mem_get_info``, read
    here every 50 ms).  A rank that fails or a world past ``timeout_s``
    fails the call, every rank stopped."""
    import multiprocessing
    import tempfile

    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{label}") as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=target, args=(r, world, tmp) + tuple(args)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        min_free = torch.cuda.mem_get_info(dev)[0]
        try:
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                min_free = min(min_free, torch.cuda.mem_get_info(dev)[0])
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        errors = "\n".join(f"rank {r}:\n{Path(tmp, f'rank{r}.err').read_text()}" for r in range(world)
                           if Path(tmp, f"rank{r}.err").exists())
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"{label}: rank exit codes {codes}\n{errors}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)], min_free


def fsdp_line(name: str, ranks: list, src: str, card: str) -> dict:
    """One ``fsdp_peak`` line of a strategy's world: each rank's peak, the
    dry run's count, the collectives of a step by op."""
    dry = ranks[0][name]["dryrun"]
    counted = (dry["argument_bytes"] + dry["temp_bytes"]) / 1e9
    peaks = [r[name]["peak_mem_gb"] for r in ranks]
    last = ranks[0][name]["steps"][-1]
    row = {"strategy": name, "src": src, "peak_mem_gb_rank": peaks, "state_gb_rank": [r[name]["state_gb"] for r in ranks],
           "dryrun_argument_gb": dry["argument_bytes"] / 1e9, "dryrun_temp_gb": dry["temp_bytes"] / 1e9,
           "dryrun_count_gb": counted, "peak_over_dryrun": max(peaks) / counted - 1,
           "losses": [s["loss"] for s in ranks[0][name]["steps"]], "grad_norms": [s["grad_norm"] for s in ranks[0][name]["steps"]],
           "step_s": [s["s"] for s in ranks[0][name]["steps"]], "collective_bytes": last["collective_bytes"],
           "collective_calls": last["collective_calls"], "dryrun_collective_bytes": dry["collective_bytes"],
           "dryrun_collective_calls": dry["collective_calls"],
           "collectives_as_dryrun": (last["collective_bytes"], last["collective_calls"]) == (dry["collective_bytes"], dry["collective_calls"]),
           "launches": {k: n for k, n in last["launches"].items() if n}, "backward_launches": {k: n for k, n in last["backward"].items() if n}}
    print(f"fsdp_peak arch={FSDP_CASE['arch']} layers={FSDP_CASE['cut']['n_layers']} batch={FSDP_CASE['batch']} "
          f"seq_len={FSDP_CASE['seq_len']} mesh={FSDP_WORLD}x1 backend=gloo " + json.dumps(row) + f" card={card}", flush=True)
    return row


def run_fsdp_peak(src: str) -> int:
    """``--fsdp-peak SRC``: the fsdp world alone on the port at SRC."""
    import torch

    card = card_line()
    dev = torch.device("cuda", 0)
    ranks, min_free = run_ranks_on_card(torch, dev, fsdp_rank_main, FSDP_WORLD, FSDP_TIMEOUT_S, (str(Path(src).resolve()),), "fsdp")
    for name in FSDP_STRATEGIES:
        fsdp_line(name, ranks, src, card)
    print(f"fsdp_peak card_min_free_gb={min_free / 1e9} card={card}", flush=True)
    return 0


def run_fsdp(torch, dev) -> None:
    """The fsdp phase: one rank's two steps here (and again from nudged
    weights), then the two gloo ranks under each of FSDP_STRATEGIES; one
    ``fsdp`` line a strategy, printed before the phase raises what is off."""
    import tempfile

    card = card_line()
    one = tp_one_rank_train(torch, dev, FSDP_CASE, "bfloat16")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fsdp_ref") as ref_dir:
        ref_path = os.path.join(ref_dir, "train.pt")
        save_update_ref(torch, one, ref_path)
        t0 = time.perf_counter()
        ranks, min_free = run_ranks_on_card(torch, dev, fsdp_rank_main, FSDP_WORLD, FSDP_TIMEOUT_S, (str(ROOT / "src"), ref_path),
                                            "fsdp")
        world_s = time.perf_counter() - t0
    off = []
    for name in FSDP_STRATEGIES:
        row = fsdp_line(name, ranks, "src", card)
        losses, norms = row["losses"], row["grad_norms"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, one["losses"]))
        norm_err = max(abs(a - b) / abs(b) for a, b in zip(norms, one["grad_norms"]))
        norm_floor = max(abs(a - b) / abs(b) for a, b in zip(one["nudged_grad_norms"], one["grad_norms"]))
        norm_tol = max(TP_TOL, TP_NOISE_FACTOR["bfloat16"] * norm_floor)
        errs = errs_of_sums(ranks[0][name]["update_sums"])
        limits = [TP_NOISE_FACTOR["bfloat16"] * n for n in one["nudged_leaf_errs"]]
        worst = max(range(len(errs)), key=lambda i: errs[i] / limits[i] if limits[i] else math.inf)
        print(f"fsdp strategy={name} dtype=bfloat16 losses={losses} one_rank_losses={one['losses']} loss_rel_err={loss_err} "
              f"grad_norm_rel_err={norm_err} nudged_grad_norm_rel_err={norm_floor} worst_leaf={one['names'][worst]} "
              f"worst_leaf_err={errs[worst]} worst_leaf_limit={limits[worst]} one_rank_peak_mem_gb={one['peak_mem_gb']} "
              f"one_rank_step_s={one['step_s']} card={card}", flush=True)
        if not (loss_err <= TP_TOL and norm_err <= norm_tol):
            off.append(f"fsdp {name}: loss error {loss_err} (tolerance {TP_TOL}), gradient norm error {norm_err} (tolerance {norm_tol})")
        if not all(e <= lim for e, lim in zip(errs, limits)):
            off.append(f"fsdp {name}: leaf {one['names'][worst]}'s update error {errs[worst]} over its limit {limits[worst]}")
        if not (row["launches"].get("flash_attention") and row["backward_launches"].get("flash_attention_bwd")):
            off.append(f"fsdp {name}: attention launches {row['launches']}, backward {row['backward_launches']}")
        if row["peak_over_dryrun"] > FSDP_PEAK_OVER_DRYRUN:
            off.append(f"fsdp {name}: a rank's peak {max(row['peak_mem_gb_rank'])} GB over the dry run's {row['dryrun_count_gb']} GB "
                       f"by more than {FSDP_PEAK_OVER_DRYRUN:.0%}")
    total = torch.cuda.mem_get_info(dev)[1]
    print(f"fsdp world_s={world_s} ranks={FSDP_WORLD} backend=gloo card_total_gb={total / 1e9} card_min_free_gb={min_free / 1e9} "
          f"note=host-memory collectives, not NVLink card={card}", flush=True)
    if off:
        raise AssertionError("\n".join(off))


# ---------------------------------------------------------------------------
# dryrun: the roofline of two production cells, counted on meta tensors
# ---------------------------------------------------------------------------

DRYRUN_CELLS = [("llama3-8b", "train_4k"), ("arctic-480b", "prefill_32k")]


def start_dryrun() -> list:
    """``python -m repro_torch.launch.dryrun`` on each DRYRUN_CELLS cell, a
    subprocess a cell, all started at once (host work: no device, no
    process group), to run beside the card's phases; ``finish_dryrun``
    waits for them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [(arch, shape, time.perf_counter(),
             subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape],
                              cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for arch, shape in DRYRUN_CELLS]


def finish_dryrun(runs: list) -> None:
    """One ``dryrun`` line a cell of ``start_dryrun`` with its record's
    roofline row, memory and collectives, at the H100's data-sheet figures
    (``wall_s``: from its start to its end, beside the card's phases)."""
    for arch, shape, t0, proc in runs:
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"dryrun {arch} {shape}: exit {proc.returncode}\n{out[-3000:]}\n{err[-3000:]}")
        record = json.loads((ROOT / "artifacts" / "dryrun_torch" / f"{arch}__{shape}__16x16__default.json").read_text())
        print(f"dryrun arch={arch} shape={shape} mesh={record['mesh']} strategy={record['strategy']} wall_s={time.perf_counter() - t0} "
              f"memory_analysis={json.dumps(record['memory_analysis'])} collectives={json.dumps(record['raw_collectives'])} "
              f"roofline={json.dumps(record['roofline'])} figures=data-sheet", flush=True)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on a GPU only", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--fsdp-peak"] and len(sys.argv) == 3:  # the fsdp world alone, on another tree
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        from repro_torch.kernels import _build

        _build.load(*_build.SOURCES)
        return run_fsdp_peak(sys.argv[2])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Hydra, ProviderSpec, Task, TaskState
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import registry as kreg

    if sys.argv[1:] == ["--trace-checks"]:  # backward_traces in a fresh process (backward_traces_fresh)
        _build.load(*_build.SOURCES)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        traced = backward_traces(torch, ops, torch.device("cuda", 0))
        print("trace_checks " + json.dumps({"traced": traced, "stats": PROFILE_STATS}), flush=True)
        return 0

    # -- 1. set-up -------------------------------------------------------------
    phase_t0 = time.perf_counter()
    card = card_line()
    print(f"card {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.load(*_build.SOURCES)
    print(f"build sources={list(_build.SOURCES)} dir={_build.BUILD_DIR.relative_to(ROOT)} seconds={time.perf_counter() - t0}", flush=True)
    # registers and spills (nvcc -Xptxas -v) of the tensor-core attention and
    # GEMM kernels (the persistent GEMM backward's among them) and of the
    # two scans' backwards, and the dynamic shared memory of the attention
    # backward and of the persistent GEMM backward (ring and staging tile)
    for source in ("flash_attention", "flash_attention_bwd_wgmma", "flash_attention_bwd_tf32x3", "moe_gmm", "moe_gmm_bwd", "rglru_scan_bwd",
                   "selective_scan_bwd"):
        for usage in _build.ptxas_usage(_build.BUILD_LOGS.get(source, "")):
            print(f"ptxas source={source} " + " ".join(f"{k}={v}" for k, v in usage.items()), flush=True)
    import ctypes

    smem = _build.function("flash_attention_bwd_wgmma", "flash_attention_bwd_wgmma_smem", [ctypes.c_int, ctypes.c_int])
    print("smem flash_attention_bwd_wgmma " + " ".join(f"hd{hd}_kv={smem(hd, 0)} hd{hd}_q={smem(hd, 1)}" for hd in (32, 64, 128, 256)), flush=True)
    gmm_smem = _build.function("moe_gmm_bwd", "moe_gmm_bwd_wgmma_smem", [ctypes.c_int])
    print(f"smem moe_gmm_bwd gmm_bwd_dx_wgmma={gmm_smem(0)} gmm_bwd_dw_wgmma={gmm_smem(1)} "
          f"gmm_bwd_dw_wgmma_short_k={gmm_smem(2)}", flush=True)
    print_selective_bwd_occupancy(torch)
    print_gmm_occupancy(torch, torch.device("cuda", 0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert_fp32_exact(torch)
    dev = torch.device("cuda", 0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    print(f"phase name=setup wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 2. kernels --------------------------------------------------------------
    phase_t0 = time.perf_counter()
    for name in sorted(kreg.KERNELS):
        kdef = kreg.get_kernel(name)
        for tier in ("tiny", "smoke", "full"):
            shape = dict(getattr(kdef, f"{tier}_shape"))
            check_kernel(torch, kreg, ops, name, shape, "float32", 0, TIER_TOL, False, tier, dev, flush=flush)
    for shape, label in ATTN_VARIANTS:
        for dtype, tol in (("float32", TIER_TOL), ("bfloat16", 2e-2)):
            check_kernel(
                torch, kreg, ops, "flash_attention", shape, dtype, 1, tol, False, f"{label}_{dtype}", dev,
                timed=False, config={"block_q": 64, "block_k": 64},
            )
    for shape, label in HD16_CASES:
        for dtype, tol in (("float32", TIER_TOL), ("bfloat16", 2e-2)):
            check_kernel(
                torch, kreg, ops, "flash_attention", shape, dtype, 1, tol, False, f"{label}_{dtype}", dev,
                timed=False, config={"block_q": 64, "block_k": 64},
            )
    shape, label = HD16_BF16_TIMED
    attn_bf16_hd16 = check_kernel(torch, kreg, ops, "flash_attention", shape, "bfloat16", 1, WIDTH_TOL["bfloat16"], True,
                                  label, dev, config={"block_q": 64, "block_k": 64}, flush=flush)
    for shape, label in GMM_CASES:
        for dtype, tol in (("float32", TIER_TOL), ("bfloat16", 2e-2)):
            check_kernel(torch, kreg, ops, "moe_gmm", shape, dtype, 1, tol, False, f"{label}_{dtype}", dev, timed=False)
    check_chunk_chaining(torch, ops, dev)
    for name, shape, dtype, label in SCAN_CASES:
        fp32 = dtype == "float32"
        block = {"block_d": min(shape.get("di", shape.get("dr")), 512)}
        check_kernel(
            torch, kreg, ops, name, shape, dtype, 2, TIER_TOL if fp32 else SCAN_BF16X_TOL, not fp32, label, dev,
            timed=False, config=block,
        )
    check_concurrent(torch, kreg, ops, dev)
    ss_bwd_rows = check_selective_scan_bwd(torch, ops, dev, flush)
    widths, gemm_rows, attn_fp32, seen = {}, {}, {}, set()
    for name, model, shape, dtype in MODEL_WIDTHS:
        label = f"{model}_fp32" if (name, model) in seen else model  # a GEMM width's second dtype
        seen.add((name, model))
        # the fp32 GEMMs at the model widths take tens of ms a call: fewer cold reps
        row = check_kernel(torch, kreg, ops, name, shape, dtype, 0, WIDTH_TOL[dtype], True, label, dev, flush=flush,
                           cold_reps=5 if (name, dtype) == ("moe_gmm", "float32") else 20)
        widths.setdefault(name, row)  # the first width of a kernel goes in the report
        if name == "moe_gmm":
            gemm_rows[label] = row
        if dtype == "bfloat16" and name == "flash_attention":
            # the same width in fp32, where the relative tolerance is tight,
            # timed beside fp32 SDPA, TF32 off: llama3-8b's on tf32x3,
            # recurrentgemma-2b's on tf32x3_cluster
            attn_fp32[model] = check_kernel(torch, kreg, ops, name, shape, "float32", 0, WIDTH_TOL["float32"], True,
                                            f"{model}_fp32", dev, flush=flush)
        torch.cuda.empty_cache()
    lq_lk = check_attention_lq_lk(torch, ops, dev, flush)
    cross = check_attention_lq_lk(torch, ops, dev, flush, CROSS_CASES)
    torch.cuda.empty_cache()

    print(f"phase name=kernels wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 3. broker ---------------------------------------------------------------
    phase_t0 = time.perf_counter()
    launches, routes = run_broker(torch, kreg, ops, Hydra, ProviderSpec, Task, TaskState)
    print(f"phase name=broker wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 4. scenario -------------------------------------------------------------
    phase_t0 = time.perf_counter()
    scenario_launches = run_scenarios(ops, device="cuda")
    print(f"phase name=scenario wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 5. autotune and FACTS ---------------------------------------------------
    phase_t0 = time.perf_counter()
    run_autotune(torch, kreg, dev)
    run_facts(torch, Hydra, ProviderSpec, dev)
    print(f"phase name=autotune_facts wall_s={time.perf_counter() - phase_t0}", flush=True)

    # the backward kernels' trace checks, in a fresh process: after heavy
    # use of the card CUPTI loses traces' first kernels (ROADMAP.md fault 3.8);
    # this process's cached blocks go back to the card first
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"card_memory before=trace_checks free_gb={free / 1e9} total_gb={total / 1e9} "
          f"reserved_here_gb={torch.cuda.memory_reserved(dev) / 1e9}", flush=True)
    traced = backward_traces_fresh()

    # -- 6. model ----------------------------------------------------------------
    phase_t0 = time.perf_counter()
    del flush
    torch.cuda.empty_cache()
    with cpu_sides(torch) as submit:
        for name, n_layers, prompt, want, attn_route in MODEL_CHECKS:
            check_model_on_card(torch, ops, name, n_layers, prompt, want, attn_route, dev, submit)
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    for name, n_layers, prompt, want in MODEL_WIDTH_RUNS:
        run_full_width(torch, ops, name, n_layers, prompt, want, dev)
        torch.cuda.empty_cache()
    model_launches = run_serve(torch, ops, dev)
    torch.cuda.empty_cache()
    moe_serve_launches = run_moe_serve(torch, ops, dev)
    torch.cuda.empty_cache()
    family_serve_launches = {}
    for spec in FAMILY_SERVES:
        family_serve_launches[spec["arch"]] = run_family_serve(torch, ops, dev, spec)["flash_attention"]
        torch.cuda.empty_cache()
    seed_compute_states(torch, dev, "llama-3.2-vision-11b", "prefill")
    run_compute_tasks(torch, ops, Hydra, ProviderSpec, Task, TaskState)
    print(f"phase name=model wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 7. train ----------------------------------------------------------------
    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    bwd_rows = check_backward_kernels(torch, ops, dev, flush, traced)
    bwd_rows["selective_scan_bwd"] = ss_bwd_rows
    del flush
    torch.cuda.empty_cache()
    train_backward, train_backward_routes = run_train_full_size(torch, ops, dev)
    torch.cuda.empty_cache()
    run_train_width(torch, ops, dev, DENSE_TRAIN)
    torch.cuda.empty_cache()
    run_train_width(torch, ops, dev, ENCDEC_TRAIN)
    torch.cuda.empty_cache()
    run_train_width(torch, ops, dev, VLM_TRAIN)
    torch.cuda.empty_cache()
    train_backward["selective_scan_bwd"] = run_train_width(torch, ops, dev, SSM_TRAIN)["selective_scan_bwd"]
    torch.cuda.empty_cache()
    train_backward["moe_gmm_bwd"] = run_moe_grad_pass(torch, ops, dev)["moe_gmm_bwd"]
    torch.cuda.empty_cache()
    with cpu_sides(torch) as submit:
        for arch, batch_size, seq_len, want_backward, cut in GRAD_CHECKS:
            check_grads_on_card(torch, ops, dev, arch, batch_size, seq_len, want_backward, cut, submit)
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    run_train_tasks(torch, ops, Hydra, ProviderSpec, Task, TaskState)
    print(f"device_profile calls={PROFILE_STATS['calls']} retried={PROFILE_STATS['retried']} "
          f"missing_from_events_but_in_kineto={PROFILE_STATS['in_kineto_only']} missing_from_both={PROFILE_STATS['in_neither']} "
          f"retry_found={PROFILE_STATS['retry_found']}", flush=True)
    print(f"phase name=train wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 8. sharded --------------------------------------------------------------
    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    sharded_launches = run_sharded(torch, ops, dev)
    example_launches = run_examples(torch, ops, dev)
    print(f"phase name=sharded wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 9. tp, fsdp and dryrun --------------------------------------------------
    dryruns = start_dryrun()  # host work, beside the two phases on the card
    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    tp_launches, tp_decode_launches = run_tp(torch, ops, dev)
    print(f"phase name=tp wall_s={time.perf_counter() - phase_t0}", flush=True)
    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    run_fsdp(torch, dev)
    print(f"phase name=fsdp wall_s={time.perf_counter() - phase_t0}", flush=True)
    phase_t0 = time.perf_counter()
    finish_dryrun(dryruns)
    print(f"phase name=dryrun wall_s={time.perf_counter() - phase_t0}", flush=True)

    # -- 10. report --------------------------------------------------------------
    report = []
    for name in sorted(kreg.KERNELS):
        route, source, replaces = KERNEL_INFO[name]
        row = widths[name]
        report.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "route_launches": routes.get(name), "width_route": row["route"],
            "scenario_launches": {tag: n[name] for tag, n in scenario_launches.items()},
            "model_launches": model_launches[name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "ms_cold": row["ms_cold"], "ms_call": row["ms_call"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "model": row["case"], "dtype": row["dtype"],
            "sharded_launches_per_step": sharded_launches.get(name, 0),
            "example_launches": {ex: n[name] for ex, n in example_launches.items()},
            "tp_launches_rank0": tp_launches.get(name, 0), "tp_decode_launches_rank0": tp_decode_launches.get(name, 0),
        })
        fp32_keys = ("case", "route", "max_abs_err", "rel_err", "ms", "ms_cold", "ms_call", "plain_ms", "library_ms",
                     "bound_ms", "bound_by", "bound_3x_ms", "simt_bound_ms")
        if name == "moe_gmm":  # the fp32 width, on tf32x3, beside the bf16 one; arctic's widths and grok's decode
            report[-1]["fp32_width"] = {k: gemm_rows["grok_1_314b_fp32"][k] for k in fp32_keys}
            report[-1]["other_widths"] = {label: {k: row.get(k) for k in fp32_keys + ("dtype",)}
                                          for label, row in gemm_rows.items() if label not in ("grok_1_314b", "grok_1_314b_fp32")}
            report[-1]["moe_serve_launches"] = moe_serve_launches[name]
        if name == "flash_attention":  # both widths in fp32, bf16 at hd 16, and Lq != Lk
            report[-1]["fp32_width"] = {k: attn_fp32["llama3_8b"][k] for k in fp32_keys}
            report[-1]["fp32_hd256"] = {k: attn_fp32["recurrentgemma_2b"][k] for k in fp32_keys}
            report[-1]["bf16_hd16"] = {k: attn_bf16_hd16.get(k) for k in fp32_keys}
            report[-1]["lq_ne_lk"] = lq_lk
            report[-1]["cross"] = cross  # the encoder-decoder and vision families' shapes
            report[-1]["family_serve_launches"] = family_serve_launches
    for name, (route, source, replaces) in BACKWARD_INFO.items():
        row = bwd_rows[name][BACKWARD_WIDTH[name]]
        extra = {}
        if name == "flash_attention_bwd":  # bf16 on wgmma (this source) and tf32, fp32 on tf32x3 and tf32x3_cluster
            others = {label: {k: r.get(k) for k in ("dtype", "route", "rel_err", "ms", "ms_cold", "ms_call",
                                                    "ms_lse_recomputed", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                                    "bound_3x_ms", "simt_bound_ms", "kv_parts", "kernels_per_call")}
                      for label, r in bwd_rows[name].items() if r["route"] != "wgmma" or label in CROSS_BWD}
            extra = {"width_route": row["route"], "route_launches": train_backward_routes,
                     "tf32_source": "src/repro_torch/kernels/csrc/flash_attention_bwd_tf32x3.cu", "other_cases": others}
        elif name == "moe_gmm_bwd":  # launches: grok-1-314b's full-width loss and gradient pass (bf16, wgmma)
            part_keys = tuple(f"{p}_{k}" for p in ("dx", "dw") for k in ("ms", "ms_cold", "ms_call", "library_ms", "bound_ms", "bound_by"))
            others = {label: {k: r.get(k) for k in ("dtype", "route", "max_abs_err", "rel_err", "ms", "ms_cold", "ms_call",
                                                    "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_3x_ms") + part_keys}
                      for label, r in bwd_rows[name].items() if label != BACKWARD_WIDTH[name]}
            extra = {"width_route": row["route"], "parts": {k: row[k] for k in part_keys}, "other_cases": others}
        elif name == "selective_scan_bwd":  # launches: falcon-mamba-7b's train run (SSM_TRAIN); bf16 x beside fp32
            keys = ("dtype", "parts", "max_abs_err", "rel_err", "ms", "ms_cold", "ms_call", "plain_ms", "bound_ms", "bound_by",
                    "exp_floor_ms")
            extra = {"kernels_per_call": row["kernels_per_call"], "bit_equal_again": row["bit_equal_again"], "parts": row["parts"],
                     "exp_floor_ms": row["exp_floor_ms"], "other_cases": {label: {k: r.get(k) for k in keys}
                                                                         for label, r in bwd_rows[name].items() if label != BACKWARD_WIDTH[name]}}
        else:
            extra = {"kernels_per_call": row["kernels_per_call"]}
        report.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "note": "backward kernel; the reference has no Pallas backward and differentiates this function with XLA",
            **extra,
            "launches": train_backward[name], "sharded_launches_per_step": sharded_launches.get(name, 0),
            "tp_launches_rank0": tp_launches.get(name, 0),
            "max_abs_err": row["max_abs_err"], "rel_err": row["rel_err"],
            "ms": row["ms"], "ms_cold": row["ms_cold"], "ms_call": row["ms_call"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "model": row["case"], "dtype": row["dtype"],
        })
    print(f"card {card_line()}", flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
