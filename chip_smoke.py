#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--src DIR]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. It imports the port (``src/repro_torch``, or ``DIR/repro_torch``
with ``--src``, e.g. an unpacked parent commit, so that one call can
compare two versions on one card) and nothing of the JAX package, and
runs seventeen phases, each printing JSON lines:

1. ``build``   — compile the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel) into the ignored build dir.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card at the serving path's full-width shapes, at every row-tile
   boundary of K1 (C = 1 … 64; C_MIN − 1, C_MIN, C_MIN + 1, 65, 128, 129
   around the threshold of its ``wgmma``/TMA path and that path's 128-row
   tiles; C = 1,279 over 8 slots), at ragged edges (D = 520, F = 264 on
   both bf16 paths) and the router's limits and at many-block router
   shapes (T = 1000, 4096); check that K1 gives the same bytes twice and
   under a permutation of its slots, that one profiler trace shows each
   case on its path's kernel (``ffn_wgmma_kernel`` from C_MIN rows on,
   ``ffn_mma_kernel`` below, ``grouped_gemm_kernel`` for fp32), that a
   call's rows equal the same rows of a larger-C call bit for bit within
   a path (printing the |Δ| of one row across the threshold), and that
   K2's statistics are bit-equal from call to call; time kernel, plain
   version and one library call with CUDA events, and the kernels alone
   with torch.profiler, next to the card's bound for the same work. K1 is
   also held and timed at the replicated pool's S = 84 slots (decode C =
   3, prefill C = 2) and at Mixtral-8x7B's shapes, (16, 4, 4096)×(16,
   4096, 7168) at decode and C = 1,279 for the ``swa`` phase's longest
   prompt, and K2 at Mixtral's (8, 8) and (4,090, 8), k 2. K1 is also
   held and timed at one rank's share of the ``mesh`` phase's (1, 4)
   decode, (20, 4, 1536)×(20, 1536, 256), and of the ``mesh_train``
   phase's forward, (20, 205, 1536)×(20, 1536, 256) at (1, 4), (40,
   103, 1536)×(40, 1536, 256) at (2, 2) and (80, 52, 1536)×(80, 1536,
   256) at FSDP (4, 1) (a rank's one row of the batch, the weights
   gathered whole over ``data``), K2 at those (2, 2) and (4, 1) ranks'
   (256, 40) and (128, 40), k 8.
3. ``parity``  — granite-moe-3b-a800m at full width, 2 layers, fp32: the
   engine on the card (kernels) and on the CPU (plain versions), same
   seeded weights and placement, must give equal greedy tokens. Then the
   replicated + shed engine of the shed scenario (below) on the card in
   ``"scan"`` and ``"python"`` and on the CPU: equal greedy tokens and
   equal per-step (L,) overflow, shed and dropped counts, some steps
   shedding, one capture. Then Mixtral-8x7B at full width, 2 layers,
   fp32, window 4,096, under a placement: one request of 4,088 prompt
   tokens and 16 new tokens, so the dense ring wraps at the ninth step, on
   the card and on the CPU: equal greedy tokens.
4. ``serve``   — full granite-moe-3b-a800m (32 layers, bf16, seeded random
   weights, paged KV, max_batch 8) serves 8 requests under a seeded
   non-identity placement in the engine's default ``decode_mode="scan"``
   (first checking that the weights are the bits of a whole-tensor fp32
   draw, as they were before large stacks were drawn a layer at a time)
   (the decode step captured once as a CUDA graph when the engine is
   built, replayed every step); tokens must equal an identity-placement
   run bit for bit, every MoE layer call must have launched the FFN and
   router kernels (launch counts = 32 × (prefills + decode steps), replays
   counted), each engine must have captured once, and K2's arrival
   counters must be back at 0.
5. ``graph``   — the same placed run in ``decode_mode="python"`` (the eager
   per-layer loop): tokens must equal the ``"scan"`` run's; it reports
   whether every step's logits are bit-equal, both modes' decode-step
   medians (CUDA events), decode-only tokens/s, the capture counts and the
   graph pool's bytes. Then ``profile`` traces three decode steps in each
   mode: device busy and idle time, host time, launches (``cudaLaunch*``
   and ``cudaGraphLaunch``) and the port kernels' device time per step; it
   fails if the trace holds none of the port's kernels.
6. ``dense_ref`` — the capacity-free oracle
   (``EngineConfig(moe_backend="dense_ref")``: the router, K2, then every
   expert on every token, with no dispatch and no K1). First the
   ``parity`` phase's 2-layer fp32 set-up under the oracle: the card's
   greedy tokens must equal the CPU's. Then full granite-moe-3b-a800m
   (32 layers, bf16, seed-0 weights, paged KV, max_batch 8) serving 8
   requests of 16 new tokens in ``"scan"``, placed and at identity:
   tokens equal, one capture per engine, no dropped or overflowing
   assignment on any step, K2 launched 32 × (prefills + decode steps) and
   K1 never. It prints the decode-step median (CUDA events), peak memory
   and the graph pool's bytes beside the ``serve`` phase's staged median.
7. ``replan``  — GEM's one-shot control plane at full granite (32 layers,
   bf16), built by the port's launcher (``repro_torch.launch.serve``:
   seed-0 weights, 8 requests of 32 new tokens, a 4-device emulated
   fleet at high variability): the replan fires at step 16, the planner's
   placement is applied by permuting the expert pool on the card in place
   and swapping the router tables, and decoding goes on through K1/K2. It
   checks that the placement moved every layer, that each slot's rows
   after the swap are the bytes of the expert the plan put there, that the
   tables are the plan's inverse, that the greedy tokens equal a
   ``linear``-policy run, that K1/K2 launched on every MoE layer call
   before and after the swap, that the swap added no capture of the decode
   step (``"scan"`` mode), and that the swap took at most one layer's
   rows of memory beyond the pool. It prints the planner's host seconds,
   the migration's CUDA-event time beside its HBM bound and the cost
   model's charge, peak memory, and the decode-step medians before and
   after the replan.
8. ``online`` — GEM's online plane at full granite (32 layers, bf16,
   seed-0 weights, paged KV, max_batch 8, ``"scan"``), driven by the
   port's ``serve_scenario``: 48 requests of fig23's chat/summarize mix
   (shifting from 0.8/0.2 to 0.2/0.8 halfway) from ``generate_arrivals``,
   a 4-device emulated fleet at high variability whose fastest device
   slows to 2/3 of its speed at step 34, and batches of at most 256 row
   moves. It checks that a ``warmup`` and a ``variability-drift`` replan
   were applied, that at least two batches landed at distinct steps
   within the budget and all of them drained, that each slot's rows are
   the bytes of the expert the live placement puts there (per-row
   checksums taken in virtual order before the run) and the tables its
   inverse, that the greedy tokens equal a ``linear`` non-online run of
   the same stream, that K1/K2 launched 32 × (prefills + decode steps),
   that the decode step was captured once for the whole run, that K2's
   counters are at 0, and that no batch took more than one layer's rows
   of one weight beyond the pool. It prints each replan's reason, step
   and host seconds, each batch's moves and swap time (CUDA events)
   beside its HBM bound, the decode-step medians before, during and
   after the batches, the host ms a step of the controller, attribution
   and regret, and tokens/s.
9. ``replicated`` — the shed scenario at full granite (32 layers, bf16,
   seed-0 weights with the router zeroed so that every token ties onto
   experts 0…7, paged KV, max_batch 8, ``"scan"``, decode capacity factor
   1.5, one replica slot on each of 4 emulated devices, online GEM, shed
   priced with a drop penalty, the fastest card slowed to 0.2 of its
   believed speed at step 12). It checks that the pool holds 84 slots a
   layer, 302 MB (4 × 32 × 3 × 1536 × 256 × 2 B) more than the 80-slot
   pool; that each slot's rows are the bytes of the expert the live layout
   puts there after the install and after every replica batch (per-row
   checksums taken in virtual order) and the tables ``replica_table(P)``
   of the live layouts; that tokens were shed, with dropped = overflow −
   shed on every step and layer; that the enables flipped while the step
   was captured once; K1/K2 launches = 32 × (prefills + decode steps) and
   K2's counters at 0. A one-shot replicated GEM run with shed off then
   checks the rows and tables after its one retarget. It prints the
   decode-step median beside the ``serve`` phase's 80-slot one, the
   device operations and busy time of the captured step with and without
   the shed pass, the host ms a step of the shed accounting, the shed
   counts, the install, batch and retarget times beside their HBM
   bounds, and peak memory.
10. ``swa`` — Mixtral-8x7B at its published width and 4,096-token sliding
   window, depth cut to 16 of 32 layers (32 × 2.82 GB of bf16 expert
   weights do not fit the card), seeded random weights, the dense KV ring
   (``kv_mode="auto"``), max_batch 8, max_len 4,160, 8 requests of
   4,064–4,090 prompt tokens and 48 new tokens, so every row's ring wraps.
   Tokens under a seeded non-identity placement (applied in place) must
   equal the identity run's, and ``"python"`` must equal ``"scan"``; one
   capture per engine, K1/K2 launches = 16 × (prefills + decode steps),
   K2's counters at 0. It prints the decode-step median beside its byte
   bound (every weight but the embedding table, and every layer's ring),
   decode tokens/s, each prefill's seconds, peak memory and the graph
   pool's bytes.
11. ``families`` — the eight configs without MoE layers (qwen1.5-4b,
   qwen2.5-14b, qwen3-32b, gemma-7b, mamba2-1.3b, zamba2-1.2b,
   musicgen-medium, internvl2-76b) at full width, bf16, whole depth for
   mamba2, zamba2, qwen1.5 and musicgen and 4 layers for the others (to
   bound the card's time): 4 requests of 16 new tokens in ``"scan"`` and
   ``"python"``, tokens equal, one capture, no port kernel launched (no
   MoE layer); then each at 2 layers (zamba2: 7, one stage and the shared
   block), fp32, card tokens equal the CPU's. It prints the decode-step
   medians.
12. ``train`` — full granite-moe-3b-a800m (32 layers, bf16 parameters,
   fp32 moments, seed-0 weights, a seeded non-identity placement) through
   the port's training launcher (``repro_torch.launch.train``): 20 AdamW
   steps of 4 × 128 tokens from the synthetic stream at capacity factor
   2.0 (C = 205), through K1/K2 forward and their ``torch.autograd.
   Function`` backwards. It checks that every loss and grad norm is
   finite, that the last loss is below the first, that each step's
   expert counts sum to 512 × 8 a layer, and that K1 and K2 launched
   32 × 20 times and K3 never. It prints the step time (CUDA events at
   each step's end, median of steps 5–18), tokens/s, the model TFLOP/s
   (6 · ``active_param_count()`` · tokens over the step, with the card's
   name and power limit), the median shares of
   the step spent in the forward, the backward and the update, peak
   memory, and the last step under torch.profiler: device busy time
   against its wall, device operations, and the kernels by device time. Then, at full width, 2 layers, fp32: one step's loss, expert
   counts and gradients on the card against the CPU's (loss within 1e-4
   relative, each gradient leaf within 1e-3 of its max), and the placed
   run against an identity run on the card (counts equal, loss within
   1e-4, expert gradients in virtual order within 1e-3); then the
   launcher at ``--smoke`` with a checkpoint directory: 20 steps straight
   against 10, a kill, a restart and 10 more (losses within 1e-4
   relative). ``kernels`` also holds and times K1 at the train shape
   (80, 205, 1536)×(80, 1536, 256) and K2 at (512, 40), k 8.
13. ``dryrun`` — first the mesh dry run (:func:`mesh_predictions`): each
   gloo run of the ``mesh`` and ``mesh_train`` phases at its own config,
   shape, dtype and policy on a metadata mesh (``launch/meta_mesh.py``,
   rank 0 of a (1, 4), (2, 2) or (4, 1) grid of ranks that do not exist),
   predicting the parameter, moment and cache bytes a rank holds and the
   collectives its step runs by kind; granite's must be the bytes and the
   34 / 51 / 37 collectives a decode step those phases hold, and the later
   phases hold every gloo run to its prediction. Then the port's dry run
   (``repro_torch.launch.dryrun``) of every
   (arch × shape) cell on the meta device, on one card and on rank 0 of
   JAX's 16×16 mesh, but the SSD families' four
   4k/32k train and prefill cells (``DRYRUN_HOST_ONLY``: 52–122 host
   seconds each; the CPU's ``--all`` runs them), spread over worker
   processes that never touch the card: every cell must be ``ok`` (29 a
   mesh) or ``skipped`` (7); it prints each cell's line and the sweep's
   host seconds. Then granite's cells at this card's own shapes — the ``train``
   phase's 4 × 128 at capacity factor 2.0 with remat off, and a dense
   ``decode_step`` of 8 rows over 4,096 positions — each against one eager
   step on the card: the predicted parameter, gradient, moment and cache
   bytes must equal the ``nbytes`` sums of the tensors the card holds (the
   gradients' from one autograd pass after the train step), and
   the predicted peak must lie within ±1 % of ``max_memory_allocated``
   over the step (after ``reset_peak_memory_stats``), less what the card
   held before the cell's inputs were made. It prints the train
   cell's FLOPs beside the ``train`` phase's median step time and the
   achieved TFLOP/s, beside the model TFLOP/s of 6 · N_active a token, and what the card holds before and after the phase
   (after it also without cuBLAS's workspaces).
14. ``examples`` — ``examples/torch_quickstart.py`` and
   ``examples/torch_serve_moe.py --requests 4`` in this process on the
   card: the quickstart's data-plane Δ against the identity placement
   must be 0 under the GEM placement, every request must be served, and
   K1/K2 must have launched.
15. ``collective`` — the ``replan`` scenario at full width, 4 layers, under
   ``migration_via="collective"`` and ``"host"``: equal tokens, equal rows
   and tables after the swap, equal migration records (``"via":
   "host"``: one card has no expert sharding), K1/K2 launched on every MoE
   layer call, one capture.
16. ``mesh`` — the data plane across ranks under JAX's layout
   (``repro_torch.launch.mesh``, ``sharding``, ``kernels/sharded.py``):
   granite at full width, bf16, the ``collective`` scenario (8 requests of
   32 new tokens, GEM's one-shot replan at step 16 under
   ``migration_via="collective"``) at 8 of its 32 layers, served by 4
   ranks that share this card over ``gloo`` (NCCL puts no two ranks on one
   GPU; the collectives stage through pinned host buffers) in
   ``decode_mode="python"``. The phase's gloo runs share one world of 4
   ranks started once (``launch/mesh.py::World``: each run a fresh mesh
   of its shape over the same processes), each rank drawing its shard of the same seed-0
   weights (the expert stacks a layer at a time). Each rank holds its
   shard of every leaf by ``param_specs`` (the projections and the
   vocabulary over ``model``, the expert slots) and its block of the dense
   KV cache's positions. At (1, 4), GEM over the 4 emulated devices, each
   rank holding 20 of the 80 slots, against a one-process run on the card
   (dense cache, the same draws). bf16 router logits tie, and the layout's
   summation orders would break some ties the other way, so the ranks run
   on one process's router logits at every MoE layer (K2 runs on them) and
   take one process's tokens at every step (:func:`_pin_calls`): the
   routed counts at every step, the tables and the slot rows after the
   swap equal one process's, the logits of every prefill and decode step
   lie within ``MESH_LOGITS_TOL`` of one process's, and a rank's own arg
   max may differ from one process's token only where one process's top-1
   margin lies within that row's |Δ|. Each rank holds 64,048,128 +
   377,487,360 parameter bytes (every leaf's bytes its shard's) and a
   quarter of one process's cache bytes, and runs 4 collectives a layer
   and 2 more a decode step (q/k/v, the softmax partials, ``wo``, K1's
   outputs; the embedding, the logits); its tables are every other rank's
   and ``argsort`` of its plan; the measured ``cross_rows`` and
   ``payload_bytes`` equal ``stats_for_dense_sources(src, 4, 2,359,296)``
   and the ranks shipped exactly those rows, K1/K2 launched 16 ×
   (prefills + steps) a rank with K1 on (20, C, 1536)×(20, 1536, 256),
   K2's counters are at 0, and an engine in ``"scan"`` over gloo on the
   card raises ``ValueError``. At (2, 2), GEM over 2 devices: the same
   checks against a one-process run that dispatches the batch in 2 groups,
   each rank holding 127,060,992 + 754,974,720 bytes, a quarter of the
   cache (half the rows, half the positions) and running 6 collectives a
   layer and 3 more a step (K2's statistics and the dispatch counts over
   ``data``, the logits over ``data``). Then both shapes in fp32 at 4
   layers, as they come (no ties): tokens, every step's routed counts, the
   tables and the rows equal one process's, the logits within
   ``MESH_FP32_LOGITS_TOL``. Then the FSDP serve: ``policy_for(mesh,
   step_kind="decode", config=<full granite>)`` at (4, 1), which must give
   ``fsdp=True``, ``batch_axes=()`` and ``cache_batch_axes=("data",)``
   (the bf16 model is 6.14 GB a model-axis shard), at 2 layers in bf16:
   each rank holds 44,399,616 + 94,371,840 bytes (a quarter of the
   projections', the vocabulary's and the expert stacks', the norms and
   the router whole) and a quarter of the cache's rows, gathers each
   layer's blocks over ``data`` before it runs, runs every row as one
   dispatch group and attends its own cache rows (9 collectives a layer
   and 1 a step), against one process dispatching one group. That is one
   device's arithmetic, so the run is not pinned: tokens, routed counts,
   tables and rows equal one process's and every logit is one process's
   bit for bit (``MESH_FSDP_LOGITS_TOL``, 0); the replan's swap is each
   rank's own on a 1-wide model axis. NCCL ``"scan"`` runs only with 4
   cards (``"not run: N card(s)"`` otherwise), a card a rank, at (1, 4)
   and under the FSDP policy at (4, 1): full granite in bf16 with three
   replays of rank 0's captured step profiled (device time of the port
   kernels, the collectives, the products and the rest), then in fp32 at
   8 layers, held to one process exactly. A captured step cannot be
   pinned, so the (1, 4) bf16 run's tokens and logits are printed and its
   tables and rows held to the rank's own plan; the FSDP bf16 run is held
   bit for bit as over gloo. It prints each run's decode-step medians,
   walls and staged bytes: over gloo, times of 4 processes sharing one
   card, not of a multi-card fleet.
   Then the SSM and hybrid families (:data:`MESH_SSM_RUNS`): mamba2-1.3b
   at full width (64 SSD heads, state 128), 8 of 48 layers, and
   zamba2-1.2b at full width, 7 layers (one stage of 6 mamba blocks and
   the shared attention + MLP block, one tail block), served on the dense
   cache by the gloo ranks (each its SSD heads, its share of the tied
   vocabulary and the shared block, its heads of the SSM state and its
   rows over ``data``) at (1, 4) and (2, 2) in fp32 against one process
   and against the witness of the mesh (one process doing the mesh's
   sums, :class:`_MeshSums`): tokens equal both, logits within
   ``MESH_SSM_FP32_LOGITS_TOL`` of one process's and
   ``MESH_FP32_LOGITS_TOL`` of the witness's; and mamba2 at (1, 4) in
   bf16 on one process's tokens, logits within ``MESH_LOGITS_TOL`` of the
   witness's (the notes at :data:`MESH_SSM_RUNS` say why the witness
   carries the tight bounds here). Each rank's parameter and
   state bytes and its collectives a decode step (counts and bytes by
   kind) must be the mesh dry run's. With 4 cards also mamba2 over NCCL
   in ``"scan"`` at (1, 4), one capture a rank: its whole depth in bf16
   and 8 layers in fp32 held to one process and to the witness.
17. ``mesh_train`` — training under the mesh (``make_train_step(…,
   policy=…)``): granite at full width, 4 of 32 layers (4 ranks share the
   card, one world for the phase's gloo runs as in ``mesh``), bf16 parameters and fp32 moments, seed-0 weights drawn whole and
   placed by the ``train`` phase's seed, its batches (4 × 128 tokens,
   capacity factor 2.0) and optimizer, 5 AdamW steps, remat off, on 4 gloo
   ranks at (1, 4) under ``ShardingPolicy(mesh)`` and at (2, 2) and (4, 1)
   under the production policy ``policy_for(mesh, step_kind="train")``
   (ZeRO-3: the projections, the vocabulary and the expert stacks, with
   their moments, stored over ``data`` too; gathered a layer at a time,
   their gradients reduce-scattered), each against one process on the
   card (dispatched in as many groups as data ranks). The first step's
   loss within 1e-3 relative and grad norm within 1e-2 of one process's,
   its expert counts and dropped share equal, each rank's gradient (after
   the reduction over ranks) within 2e-2 of the one-process rows, over
   the max |g| of the leaf as the rank held it before FSDP (whole over
   ``data``); the second step's loss within 1e-3 and grad norm within
   5e-2; the later losses within 10 % and grad norms within 30 % (bf16
   parameters part in their last bits from the first update on; the
   later counts are printed); every rank the same metrics; each rank's
   expert update over the run (p_5 − p_0) at cosine ≥ 0.9 with one
   process's on its block, and its expert block after the last step
   within ``MESH_TRAIN_PARAM_TOL`` (0.033, Adam's bound on how far two
   runs' weights part in 5 warm-up steps) of one process's max; the
   whole leaves (parameters and moments) bit-equal on every rank and each
   model-axis shard on the ranks that hold it; parameter and moment bytes
   those of the rank's shards by ``param_specs`` (239,692,800 and
   958,771,200 at each shape: at (1, 4) its model-axis shards, under
   FSDP its ZeRO blocks); K1/K2 launched 4 × 5 times a rank, K1 on
   (E_v/m, C, 1536) × (E_v/m, 1536, 256). The (2, 2) ranks then save a
   checkpoint from the FSDP mesh; the (4, 1) ranks restore it onto their
   own blocks (``restore_sharded``) before they train: it restores on one
   process in JAX's dtypes, and the (2, 2) ranks' blocks and the (4, 1)
   ranks' restored blocks have the checksums of their blocks of it. With 4
   cards, full granite (32 layers) also trains over NCCL, a card a rank,
   at (1, 4) under ``ShardingPolicy(mesh)`` and under FSDP at (2, 2)
   (1,652,591,616 and 6,610,366,464 bytes a rank), each against one
   process dispatching as many groups, and one more step is profiled on
   every rank (``"not run: N card(s)"`` otherwise). It prints each run's
   losses, the per-rank step medians (host clock, steps 2–5) beside one
   process's, staged bytes and peak memory a rank.
   Then mamba2-1.3b at full width, 4 layers, fp32, 3 steps of the same
   batches on the gloo ranks at (1, 4) and under ``policy_for(mesh,
   step_kind="train")`` (FSDP) at (2, 2) against one process: step 1's
   loss within 1e-3 relative, each gradient leaf's block at cosine ≥
   ``MESH_SSM_TRAIN_GRAD_COS`` with one process's and within
   ``MESH_SSM_TRAIN_GRAD_TOL`` of its max, every rank the same
   metrics, and a rank's parameter and moment bytes the mesh dry run's.

Every phase's closing line carries its ``seconds``. Then it prints the
``kernels`` summary line, the ``timing`` line (each phase's seconds, the
gloo worlds of ranks it started, 2, and the script's total), the card's
name and power limit, and as its last line ``{"ok": true, "device": …}``.
Any failed check
raises and the script exits non-zero. TF32 is off for matmuls and cuDNN:
fp32 products are full fp32.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ARCH = "granite-moe-3b-a800m"
# the ``swa`` phase: Mixtral-8x7B at its published width and 4,096-token
# window, depth cut to 16 of 32 layers (32 × 2.82 GB of bf16 expert weights
# do not fit the card's 80 GB), 8 slots, prompts of 4,064–4,090 tokens and
# 48 new tokens on a ring of min(4096, 4160) = 4,096 entries: every row's
# ring wraps during decode
MIXTRAL = "mixtral-8x7b"
SWA_LAYERS = 16
SWA_BATCH = 8
SWA_MAX_LEN = 4160
SWA_PROMPTS = (4064, 4090)
SWA_NEW = 48
# the ``families`` phase: the eight configs without MoE layers at full
# width, bf16; None keeps the whole depth, a number cuts it to bound the
# card's time
FAMILIES = {
    "qwen1.5-4b": None, "qwen2.5-14b": 4, "qwen3-32b": 4, "gemma-7b": 4,
    "mamba2-1.3b": None, "zamba2-1.2b": None, "musicgen-medium": None,
    "internvl2-76b": 4,
}
# the ``train`` phase: full granite through the port's training launcher,
# 4 sequences of 128 tokens a step (512 tokens, C = ⌈512·8/40 · 2.0⌉ = 205),
# 20 steps, step times from step 5 to the last but one (the last is
# profiled)
TRAIN_STEPS = 20
TRAIN_BATCH = 4
TRAIN_SEQ = 128
TRAIN_TIMED_FROM = 5
TRAIN_TOP = 25  # kernels listed from the profiled step
TRAIN_PLACEMENT_SEED = 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {  # dense, H100 SXM data sheet
    torch.bfloat16: 989e12,  # tensor cores
    torch.float32: 67e12,  # CUDA cores (TF32 is off)
}


# CUDA kernel names of the port: K1 bf16 (tensor cores: mma.sync below
# C_MIN token rows a slot, wgmma/TMA from it), K1 fp32 (and K1 bf16 before
# the tensor-core redesign), K2/K3
PORT_KERNELS = ("ffn_mma_kernel", "ffn_wgmma_kernel", "grouped_gemm_kernel",
                "router_kernel")
# the profiler's kernel name of each K1 path (kernels.moe_gemm.kernel_path)
K1_PATH_KERNEL = {"mma.sync": "ffn_mma_kernel", "wgmma": "ffn_wgmma_kernel",
                  "fp32": "grouped_gemm_kernel"}
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.int32: torch.int32}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# each phase's seconds, by its closing line: what the ``timing`` line prints
PHASE_S: dict[str, float] = {}


def close_phase(record: dict, start: float) -> None:
    """Emit a phase's closing line with its seconds since ``start``."""
    record["seconds"] = PHASE_S[record["phase"]] = time.perf_counter() - start
    emit(record)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _cards() -> list[str]:
    """Each card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Time per call of ``fn`` on the card's clock (CUDA events): the
    median over 5 loops of ``iters`` calls each, so that one loop slowed
    by the shared host does not set the number."""
    for _ in range(warmup):
        fn()
    loops = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        loops.append(start.elapsed_time(end) / iters)
    return statistics.median(loops)


def same_bits(a, b) -> bool:
    return torch.equal(a.view(_BITS[a.dtype]), b.view(_BITS[b.dtype]))


def _is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def _traced(run, attempts: int = 3):
    """``run()`` under torch.profiler: (the trace's averages, what ``run``
    returned, the number of traces taken). The profiler on the card at
    times returns a window's trace without its device events, so a trace
    that holds no port kernel is taken again, up to ``attempts`` times;
    the caller reports the number and its check still fails when no trace
    holds a port kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = run()
        avgs = prof.key_averages()
        if any(e.device_type == DeviceType.CUDA and _is_port_kernel(e.key)
               for e in avgs):
            break
    return avgs, out, attempt


def device_us(fn, iters: int = 20) -> tuple[float, float, int]:
    """Device time of one call of ``fn`` (µs): of the port kernels it
    launches, summed over them, and of all its device work (the plain
    reductions around a kernel included); and the number of traces taken.
    torch.profiler over ``iters`` calls; fails when the trace holds no port
    kernel."""
    from torch.autograd import DeviceType

    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    avgs, _, attempts = _traced(run)
    dev = [e for e in avgs if e.device_type == DeviceType.CUDA]
    port = sum(e.self_device_time_total for e in dev if _is_port_kernel(e.key))
    check(port > 0, "profile: no port kernel in the trace")
    every = sum(e.self_device_time_total for e in dev)
    return port / iters, every / iters, attempts


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


# --------------------------------------------------------------------- build
def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    close_phase({"phase": "build", "sources": list(_build.SOURCES)}, t0)


# ------------------------------------------------------------------- kernels
def _ffn_case(S, C, D, F, dtype, gen, dev):
    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    x = randn(S, C, D)
    return (x, randn(S, D, F, scale=D ** -0.5), randn(S, D, F, scale=D ** -0.5),
            randn(S, F, D, scale=(2 * F) ** -0.5))


def _rel_err(got, want) -> tuple[float, float]:
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-30)


def _router_logits(T, E, gen, dev):
    logits = torch.randn((T, E), generator=gen, device=dev) * 2
    logits[0] = 0.0  # a fully tied row: ids 0..k-1 must win
    if T > 1:
        logits[1, : E // 2] = logits[1, 0]
    return logits.contiguous()


def _k1_kernel_names(calls, attempts: int = 3) -> list:
    """The device kernels that one call of each of ``calls`` ran, in the
    order the card ran them (torch.profiler; a trace that lost device
    events is taken again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fn in calls:
                fn()
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        names = [e.name for e in kern]
        if len(names) == 2 * len(calls):
            break
    return names


def _k1_rows(min_c, S, D, F, gen, dev) -> list:
    """Within each bf16 path of K1 a row's bits do not depend on C: a
    call's rows equal the same rows of a call with more rows (same x rows,
    same weights) bit for bit. Across the threshold nothing promises that
    wgmma and mma.sync round their k16 sums alike, so that |delta| is
    printed, not checked (0 at every shape the H100 has compared)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gemm import kernel_path

    bf16 = torch.bfloat16
    rows = []
    for small, large in ((1, 32), (9, min_c - 1), (min_c, min_c + 1),
                         (min_c, 1279), (129, 1279)):
        path = kernel_path(bf16, small)
        check(path == kernel_path(bf16, large),
              f"moe_ffn rows: C {small} and {large} take two paths")
        args = _ffn_case(S, large, D, F, bf16, gen, dev)
        y_large = ops.moe_ffn(*args)
        y_small = ops.moe_ffn(args[0][:, :small].contiguous(), *args[1:])
        torch.cuda.synchronize()
        check(same_bits(y_small, y_large[:, :small]),
              f"moe_ffn rows ({path}): the first {small} rows of a C = "
              f"{large} call differ from a C = {small} call")
        rows.append({"kernel": "moe_ffn", "case": f"rows_c{small}_of_c{large}",
                     "path": path, "shape": [S, large, D, F],
                     "rows_bit_equal": True})
    args = _ffn_case(S, min_c, D, F, bf16, gen, dev)
    y_hi = ops.moe_ffn(*args)
    y_lo = ops.moe_ffn(args[0][:, :min_c - 1].contiguous(), *args[1:])
    torch.cuda.synchronize()
    delta = (y_lo.float() - y_hi[:, :min_c - 1].float()).abs()
    rows.append({"kernel": "moe_ffn", "case": "rows_across_threshold",
                 "shape": [S, min_c, D, F],
                 "paths": [kernel_path(bf16, min_c - 1),
                           kernel_path(bf16, min_c)],
                 "max_abs_delta": delta.max().item(),
                 "max_rel_delta": delta.max().item()
                 / max(y_hi.float().abs().max().item(), 1e-30),
                 "differing_share": (delta > 0).float().mean().item(),
                 "bit_equal": bool((delta == 0).all())})
    return rows


def phase_kernels():
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moe_ffn_ref, topk_router_ref

    start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    cfg = get_config(ARCH)
    S, D = cfg.num_virtual_experts, cfg.d_model
    F = cfg.expert_d_ff // cfg.expert_tp
    k, E = cfg.experts_per_token, cfg.num_experts
    # decode: C = ceil(8·8/40·2.0) = 4 at max_batch 8; prefill: C = 32 at P=128
    # the replicated pool (phase ``replicated``): S = 80 + 4 devices × 1
    # replica slot, C shrunk by 80/84 at decode_capacity_factor 1.5 (C = 3)
    # and, for its 8-token prompts, at capacity_factor 1.25 (C = 2)
    from repro_torch.models.dispatch import slot_capacity

    S_rep = S + SHED_DEVICES * SHED_REPLICA_SLOTS
    c_rep = {tag: slot_capacity(n, cfg, capacity_factor=cf, num_slots=S_rep,
                                replicated=True)
             for tag, n, cf in (("decode_s84", 8, SHED_DECODE_CF),
                                ("prefill_s84", SHED_PROMPT,
                                 cfg.capacity_factor))}
    # Mixtral-8x7B (the ``swa`` phase): 16 virtual experts of D = 4096,
    # F_v = 7168, top-2; decode C = 4 at max_batch 8, prefill C for the
    # phase's longest prompt (4,090 tokens) at capacity factor 1.25
    mix = get_config(MIXTRAL)
    mS, mD = mix.num_virtual_experts, mix.d_model
    mF = mix.expert_d_ff // mix.expert_tp
    m_cap = {tag: slot_capacity(n, mix, capacity_factor=cf, num_slots=mS,
                                replicated=False)
             for tag, n, cf in (("mixtral_decode", SWA_BATCH,
                                 mix.decode_capacity_factor),
                                ("mixtral_prefill", SWA_PROMPTS[1],
                                 mix.capacity_factor))}
    c_train = slot_capacity(TRAIN_BATCH * TRAIN_SEQ, cfg, capacity_factor=2.0,
                            num_slots=S, replicated=False)
    # a (2, 2) rank of ``mesh_train`` dispatches its data half of the batch
    c_train_2x2 = slot_capacity(TRAIN_BATCH * TRAIN_SEQ // 2, cfg,
                                capacity_factor=2.0, num_slots=S,
                                replicated=False)
    # a (4, 1) FSDP rank dispatches its one row of the batch
    c_train_4x1 = slot_capacity(TRAIN_BATCH * TRAIN_SEQ // 4, cfg,
                                capacity_factor=2.0, num_slots=S,
                                replicated=False)
    from repro_torch.kernels.moe_gemm import kernel_path, wgmma_min_c

    min_c = wgmma_min_c()
    rows = []
    tol = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
    summary = {"moe_ffn_wgmma_min_c": min_c}
    # bf16 at every row-tile boundary of the tensor-core kernels (8/16/32
    # token rows, the wgmma path's threshold C_MIN and its 128-row tiles)
    # plus the fp32 path and a ragged F
    edges = sorted({min_c - 1, min_c, min_c + 1, 65, 128, 129}
                   - {2, 5, 7, 8, 9, 16, 17, 64})
    ffn_cases = [
        ("decode", S, 4, D, F, torch.bfloat16),
        # one rank's expert shard of the ``mesh`` phase's (1, 4) decode:
        # the shape every card of an expert-parallel deployment runs
        ("decode_rank", S // MESH_MODEL, 4, D, F, torch.bfloat16),
        ("prefill", S, 32, D, F, torch.bfloat16),
        ("decode_fp32", S, 4, D, F, torch.float32),
        ("ragged_c1", S, 1, D, F, torch.bfloat16),
        ("ragged_c3", S, 3, D, F, torch.float32),
        ("ragged_c33", S, 33, D, F, torch.bfloat16),
        ("ragged_f96", 8, 4, D, 96, torch.float32),
        *((f"c{c}", S, c, D, F, torch.bfloat16)
          for c in (2, 5, 7, 8, 9, 16, 17, 64)),
        *((f"c{c}", S, c, D, F, torch.bfloat16) for c in edges),
        # C = 1,279 (Mixtral's prefill) over several slots at granite's
        # width, and ragged D and F on both bf16 paths
        ("c1279", 8, 1279, D, F, torch.bfloat16),
        ("ragged_d520_f264_c7", 4, 7, 520, 264, torch.bfloat16),
        ("ragged_d520_f264_c130", 4, 130, 520, 264, torch.bfloat16),
        *((tag, S_rep, c, D, F, torch.bfloat16) for tag, c in c_rep.items()),
        *((tag, mS, c, mD, mF, torch.bfloat16) for tag, c in m_cap.items()),
        # the ``train`` phase's forward: 512 tokens at capacity factor 2.0
        ("train", S, c_train, D, F, torch.bfloat16),
        # one rank's expert shard of the ``mesh_train`` phase's (1, 4)
        # forward: the same 512 tokens on 20 of the 80 slots
        ("train_rank", S // MESH_MODEL, c_train, D, F, torch.bfloat16),
        # and one rank's of its (2, 2) forward: 256 tokens on 40 slots
        ("train_rank_2x2", S // 2, c_train_2x2, D, F, torch.bfloat16),
        # and one rank's of its FSDP (4, 1) forward: 128 tokens on all 80
        # slots, the weights gathered whole over data
        ("train_rank_4x1", S, c_train_4x1, D, F, torch.bfloat16),
    ]
    # loops of calls for the timings; the prefill shape takes milliseconds
    # a call (fp32 for the plain version)
    iters = {"mixtral_prefill": (10, 3, 10)}
    path_calls = []  # (tag, path, inputs) of every case, for the trace below
    for tag, s, c, d, f, dtype in ffn_cases:
        args = _ffn_case(s, c, d, f, dtype, gen, dev)
        path_calls.append((tag, kernel_path(dtype, c), args))
        got = ops.moe_ffn(*args)
        want = moe_ffn_ref(*args)
        again = ops.moe_ffn(*args)
        perm = torch.randperm(s, generator=gen, device=dev)
        permuted = ops.moe_ffn(*(t[perm].contiguous() for t in args))
        torch.cuda.synchronize()
        abs_err, rel = _rel_err(got, want)
        check(bool(torch.isfinite(got.float()).all()), f"moe_ffn {tag}: non-finite")
        check(rel <= tol[dtype],
              f"moe_ffn {tag}: relative error {rel} > {tol[dtype]}")
        check(same_bits(got, again), f"moe_ffn {tag}: two calls differ")
        check(same_bits(permuted, got[perm]),
              f"moe_ffn {tag}: permuting the slots does not permute y bit for bit")
        row = {"kernel": "moe_ffn", "case": tag, "shape": [s, c, d, f],
               "dtype": str(dtype), "path": kernel_path(dtype, c),
               "max_abs_err": abs_err, "rel_err": rel,
               "bit_equal_twice": True, "slot_permutation_exact": True}
        if tag in ("decode", "decode_rank", "prefill", "train", "train_rank",
                   "train_rank_2x2", "train_rank_4x1", *c_rep, *m_cap):
            x, wg, wu, wd = args
            n_kernel, n_plain, n_library = iters.get(tag, (50, 20, 50))

            def library():
                h = torch.nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)
                return torch.bmm(h, wd)

            el = x.element_size()
            nbytes = (2 * x.numel() + wg.numel() + wu.numel() + wd.numel()) * el
            b_ms, b_by = bound(nbytes, 2.0 * s * c * d * f * 3, dtype)
            row.update(
                ms=time_ms(lambda: ops.moe_ffn(*args), n_kernel),
                plain_ms=time_ms(lambda: moe_ffn_ref(*args), n_plain),
                library_ms=time_ms(library, n_library),
                bound_ms=b_ms, bound_by=b_by,
            )
            (row["device_us"], row["call_device_us"],
             row["trace_attempts"]) = device_us(lambda: ops.moe_ffn(*args))
            row["bound_share"] = b_ms / (row["device_us"] / 1e3)
            summary[f"moe_ffn/{tag}"] = row
        rows.append(row)
        del args, got, want, again, permuted
    # each case ran the kernel of its path: the trace's kernel names, two
    # launches a call (gate/up, down)
    names = _k1_kernel_names([lambda a=a: ops.moe_ffn(*a)
                              for _, _, a in path_calls])
    check(len(names) == 2 * len(path_calls),
          f"moe_ffn paths: {len(names)} kernels traced for "
          f"{len(path_calls)} calls")
    for i, (tag, path, _) in enumerate(path_calls):
        ran = names[2 * i: 2 * i + 2]
        check(all(K1_PATH_KERNEL[path] in n for n in ran),
              f"moe_ffn {tag}: the {path} path ran {ran}")
    rows.append({"kernel": "moe_ffn", "case": "paths", "wgmma_min_c": min_c,
                 "path_by_case": {tag: path for tag, path, _ in path_calls},
                 "kernel_names_checked": True})
    del path_calls
    rows.extend(_k1_rows(min_c, 8, D, F, gen, dev))

    router_cases = [("decode", 8, E, k), ("prefill", 128, E, k),
                    ("train", TRAIN_BATCH * TRAIN_SEQ, E, k),
                    # a (2, 2) rank of ``mesh_train``: its data half
                    ("train_rank_2x2", TRAIN_BATCH * TRAIN_SEQ // 2, E, k),
                    # a (4, 1) FSDP rank of ``mesh_train``: its one row
                    ("train_rank_4x1", TRAIN_BATCH * TRAIN_SEQ // 4, E, k),
                    ("mixtral_decode", SWA_BATCH, mix.num_experts,
                     mix.experts_per_token),
                    ("mixtral_prefill", SWA_PROMPTS[1], mix.num_experts,
                     mix.experts_per_token),
                    ("ragged_t5", 5, E, k), ("limits", 64, 128, 8),
                    ("many_blocks_t1000", 1000, E, k),
                    ("many_blocks_t4096", 4096, E, k)]
    for with_stats, name in ((True, "topk_router_stats"), (False, "topk_router")):
        for tag, T, e, kk in router_cases:
            logits = _router_logits(T, e, gen, dev)
            runs = [ops.topk_router(logits, kk, with_stats=with_stats)
                    for _ in range(3)]
            want = topk_router_ref(logits, kk, with_stats=with_stats)
            torch.cuda.synchronize()
            got = runs[0]
            check(torch.equal(got[1], want[1]), f"{name} {tag}: ids differ")
            check(torch.equal(got[1][0].cpu(), torch.arange(kk, dtype=torch.int32)),
                  f"{name} {tag}: tied row did not pick the lowest ids")
            abs_err, rel = _rel_err(got[0], want[0])
            check(rel <= 1e-5, f"{name} {tag}: gates rel error {rel}")
            check(all(same_bits(a, b) for run in runs[1:]
                      for a, b in zip(run, got)),
                  f"{name} {tag}: repeated calls differ")
            if with_stats:
                check(torch.equal(got[3], want[3]), f"{name} {tag}: counts differ")
                ps_abs, ps_rel = _rel_err(got[2], want[2])
                check(ps_rel <= 1e-5, f"{name} {tag}: probs_sum rel error {ps_rel}")
                abs_err = max(abs_err, ps_abs)
            row = {"kernel": name, "case": tag, "shape": [T, e, kk],
                   "max_abs_err": abs_err, "bit_equal_repeated": True}
            if tag in ("decode", "prefill", "train", "train_rank_2x2",
                       "train_rank_4x1", "mixtral_decode", "mixtral_prefill"):
                def kernel():
                    return ops.topk_router(logits, kk, with_stats=with_stats)

                def plain():
                    return topk_router_ref(logits, kk, with_stats=with_stats)

                def library():
                    return torch.topk(torch.softmax(logits, dim=-1), kk, dim=-1)

                nbytes = 4 * (T * e + 2 * T * kk + (2 * e if with_stats else 0))
                b_ms, b_by = bound(nbytes, T * e * (5 + 2 * kk), torch.float32)
                row.update(
                    ms=time_ms(kernel, 200),
                    plain_ms=time_ms(plain, 100),
                    library_ms=time_ms(library, 200),
                    bound_ms=b_ms, bound_by=b_by,
                )
                (row["device_us"], row["call_device_us"],
                 row["trace_attempts"]) = device_us(kernel)
                row["bound_share"] = b_ms / (row["device_us"] / 1e3)
                summary[f"{name}/{tag}"] = row
            rows.append(row)
    close_phase({"phase": "kernels", "cases": rows}, start)
    return summary


# ------------------------------------------------------------ shed scenario
# The replicated + shed engine of the ``parity`` and ``replicated`` phases,
# the twin of the JAX tests' ``_run_shed_engine`` at granite width: a zeroed
# router ties every token onto experts 0…7 (virtual 0…15), decode capacity
# factor 1.5 makes the copies overflow, one replica slot a device, online
# GEM without the replica refinement, shed priced with a drop penalty, and
# a 4-device emulated staircase fleet whose fastest card falls to 0.2 of
# its believed speed at step 12: the profile repair re-shares the hot
# experts' copies so skewed that the small-share copy has free rows.
SHED_DEVICES = 4
SHED_REPLICA_SLOTS = 1
SHED_DECODE_CF = 1.5
SHED_BELIEVED = (0.6, 0.8, 1.0, 1.3)
SHED_TRUE = (0.6, 0.8, 1.0, 0.2)
SHED_SLOWDOWN_STEP = 12
SHED_REQUESTS, SHED_PROMPT, SHED_NEW = 16, 8, 24
SHED_MOVES_PER_STEP = 256


def _shed_profile(speeds):
    from repro_torch.core import DeviceFleet, profile_fleet, simulator_measure_fn

    fleet = DeviceFleet.from_speeds(np.asarray(speeds, dtype=np.float64),
                                    tile=1, tile_time=50e-6, base=10e-6)
    return profile_fleet(simulator_measure_fn(fleet, seed=0), SHED_DEVICES,
                         max_tokens=64, tile=1, repeats=5).profile


def _shed_engine(params, cfg, device, mode, *, online=True, shed=True):
    from repro_torch.core import GEMConfig
    from repro_torch.online import DriftConfig, MigrationConfig
    from repro_torch.replication import ReplicationConfig
    from repro_torch.serving import EngineConfig, ServingEngine, ShedConfig

    ecfg = EngineConfig(
        max_batch=8, max_len=64, decode_mode=mode,
        gem=GEMConfig(trace_length=8, num_restarts=4),
        other_time_per_step=1e-4, online=online,
        drift=DriftConfig(min_steps=4, threshold=100.0, var_threshold=2.0),
        migration=MigrationConfig(max_moves_per_step=SHED_MOVES_PER_STEP,
                                  base_overhead=0.0),
        replan_cooldown=8, payback_horizon=100_000,
        replication=ReplicationConfig(
            replica_slots=SHED_REPLICA_SLOTS, exclude_speed_below=0.0,
            consistent_only=False, refine=False),
        shed=ShedConfig(enabled=shed, min_overflow=1, drop_penalty_s=0.01),
    )
    return ServingEngine(params, cfg, ecfg, profile=_shed_profile(SHED_BELIEVED),
                         num_devices=SHED_DEVICES, device=device)


def _shed_params(cfg, device, dtype):
    from repro_torch.models import init_params

    params = init_params(cfg, seed=0, device=device, dtype=dtype)
    params["blocks"]["moe"]["router"].zero_()  # all ties: experts 0…7
    return params


def _profile_replay(eng, steps: int = 5, top: int = 0):
    """Device operations, busy ms and host ms of the captured decode step
    alone, all rows idle (torch.profiler over ``steps`` replays), and with
    ``top`` the ``top`` kernels by device time a step. On the dense cache
    an idle step still reads every layer's whole ring."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph, B = eng.decode_graph, eng.ecfg.max_batch
    L = eng.config.num_layers
    paged = graph.block_tables is not None
    args = (np.zeros(B if paged else (), np.int32), np.zeros((B, 1), np.int32))
    kw = {"block_tables": np.zeros((B, graph.n_max), np.int32) if paged else None,
          "shed_enables": (np.ones(L, np.int32)
                           if graph.shed_enables is not None else None)}

    def replay():
        eng._decode(eng.params, eng.caches, *args, eng.config,
                    eng.placements, **kw)

    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = {"device_ops_per_step": sum(e.count for e in dev) / steps,
           "device_busy_ms_per_step":
               sum(e.self_device_time_total for e in dev) / steps / 1e3,
           "host_ms_per_step": wall / steps * 1e3}
    if top:
        dev.sort(key=lambda e: -e.self_device_time_total)
        out["top_kernels"] = [
            {"name": e.key[:80], "ms_per_step":
                 e.self_device_time_total / steps / 1e3,
             "calls_per_step": e.count / steps} for e in dev[:top]]
    return out


def _record_shed(eng, steps, host_s=None):
    """Record each decode step's (L,) overflow, shed and dropped counts as
    the engine reads them back after the step, and the host seconds of
    its ``_shed_step``."""
    inner = eng._shed_step

    def recorded(counts_virt, aux, cost_mx):
        steps.append([getattr(aux, n).cpu().tolist() for n in (
            "overflow_tokens", "shed_tokens", "dropped_tokens")])
        t0 = time.perf_counter()
        out = inner(counts_virt, aux, cost_mx)
        if host_s is not None:
            host_s.append(time.perf_counter() - t0)
        return out

    eng._shed_step = recorded


def _drive_shed(eng, vocab_size, *, requests=SHED_REQUESTS, new=SHED_NEW):
    """Submit the scenario's requests and step until done, slowing the
    fastest card at SHED_SLOWDOWN_STEP; returns the tokens."""
    rng = np.random.default_rng(17)
    for _ in range(requests):
        eng.submit(rng.integers(0, vocab_size, size=SHED_PROMPT),
                   max_new_tokens=new)
    true = _shed_profile(SHED_TRUE)
    for step in range(2_000):
        if not eng.scheduler.has_work():
            break
        if step == SHED_SLOWDOWN_STEP:
            eng.set_true_profile(true)
        eng.step()
    check(not eng.scheduler.has_work(), "shed scenario: the stream never drained")
    return {r.uid: r.generated for r in eng.finished}


def _check_shed_counts(tag, steps):
    check(any(sum(shed) > 0 for _, shed, _ in steps),
          f"{tag}: no step shed a token")
    for overflow, shed, dropped in steps:
        check(dropped == [o - x for o, x in zip(overflow, shed)],
              f"{tag}: dropped {dropped} != overflow {overflow} − shed {shed}")


# -------------------------------------------------------------------- parity
def _placement(num_layers, num_slots, seed):
    rng = np.random.default_rng(seed)
    s2e = np.stack([rng.permutation(num_slots) for _ in range(num_layers)])
    return s2e, np.argsort(s2e, axis=1)


def _with_placement(params, s2e):
    from repro_torch.models import apply_placement

    blocks = dict(params["blocks"])
    blocks["moe"] = apply_placement(blocks["moe"], torch.as_tensor(s2e))
    return {**params, "blocks": blocks}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _serve(params, cfg, ecfg, device, e2s, requests):
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(params, cfg, ecfg, device=device)
    if e2s is not None:
        eng.placements = torch.as_tensor(e2s, dtype=torch.int32, device=device)
    for prompt, new in requests:
        eng.submit(prompt, max_new_tokens=new)
    return eng


def _card_against_cpu(phase, ecfg):
    """Granite at full width, 2 layers, fp32, seed-1 weights under a
    seeded placement, 4 requests of 8 new tokens, served under ``ecfg``
    on the card and on the CPU: the greedy tokens must be equal. Returns
    the card run's launch counts and the tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(ARCH), num_layers=2)
    params = init_params(cfg, seed=1, device="cuda", dtype=torch.float32)
    s2e, e2s = _placement(cfg.num_layers, cfg.num_virtual_experts, seed=2)
    params = _with_placement(params, s2e)
    rng = np.random.default_rng(3)
    requests = [(rng.integers(0, cfg.vocab_size, size=int(n)), 8)
                for n in rng.integers(16, 41, size=4)]
    torch.set_num_threads(8)
    tokens, counts = [], []  # the card's run, then the CPU's
    for device, p in (("cuda", params), ("cpu", _to(params, "cpu"))):
        eng = _serve(p, cfg, ecfg, device, e2s, requests)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run()
        counts.append(ops.launch_counts())
        tokens.append({r.uid: r.generated for r in done})
        check(len(done) == len(requests), f"{phase} {device}: not all finished")
        emit({"phase": phase, "device": device,
              "moe_backend": eng.config.moe_backend,
              "seconds": round(time.perf_counter() - t0, 3)})
    check(tokens[0] == tokens[1],
          f"{phase}: GPU tokens {tokens[0]} != CPU tokens {tokens[1]}")
    emit({"phase": phase, "ok": True, "layers": cfg.num_layers,
          "dtype": "float32", "requests": len(requests), "tokens": tokens[0]})
    return counts[0], tokens[0]


def phase_parity():
    from repro_torch.serving import EngineConfig

    start = time.perf_counter()
    _card_against_cpu("parity", EngineConfig(max_batch=4, max_len=64))
    phase_parity_shed()
    phase_parity_swa()
    close_phase({"phase": "parity", "ok": True}, start)


def phase_parity_shed():
    """The replicated + shed engine at full width, 2 layers, fp32: card
    ``"scan"``, card ``"python"`` and CPU give equal greedy tokens and
    equal per-step (L,) overflow, shed and dropped counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_config(ARCH), num_layers=2,
                              decode_capacity_factor=SHED_DECODE_CF)
    params = _shed_params(cfg, "cuda", torch.float32)
    runs = {}
    for device, mode in (("cuda", "scan"), ("cuda", "python"), ("cpu", "python")):
        eng = _shed_engine(_to(params, device), cfg, device, mode)
        steps = []
        _record_shed(eng, steps)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tokens = _drive_shed(eng, cfg.vocab_size)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        calls = cfg.num_layers * (eng.prefill_count + eng.decode_count)
        if device == "cuda":
            check(counts["moe_ffn"] == counts["topk_router_stats"] == calls,
                  f"parity shed {mode}: launches {counts} != {calls}")
        _check_shed_counts(f"parity shed {device} {mode}", steps)
        runs[device, mode] = (eng, tokens, steps)
        emit({"phase": "parity", "engine": "replicated+shed", "device": device,
              "decode_mode": mode, "seconds": round(wall, 3),
              "decode_steps": eng.decode_count, "launches": counts,
              "graph_capture_counts": eng.graph_capture_counts,
              "shed_tokens": sum(sum(x) for _, x, _ in steps),
              "replans": [(r["step"], r["reason"]) for r in eng.controller.replans],
              "batches": len(eng.migration_records)})
    _, ref_tokens, ref_steps = runs["cpu", "python"]
    for key, (eng, tokens, steps) in runs.items():
        check(tokens == ref_tokens, f"parity shed {key}: tokens differ from the CPU's")
        check(steps == ref_steps,
              f"parity shed {key}: per-step shed counts differ from the CPU's")
    check(runs["cuda", "scan"][0].graph_capture_counts
          == {"decode": 1, "prefill": 0, "migrate": 0},
          "parity shed: the scan engine captured more than once")
    emit({"phase": "parity", "engine": "replicated+shed", "ok": True,
          "layers": cfg.num_layers, "dtype": "float32",
          "slots": int(runs["cpu", "python"][0].params["blocks"]["moe"]
                       ["w_gate"].shape[1]),
          "steps": len(ref_steps),
          "shed_steps": sum(1 for _, x, _ in ref_steps if sum(x) > 0),
          "shed_tokens": sum(sum(x) for _, x, _ in ref_steps),
          "overflow_tokens": sum(sum(o) for o, _, _ in ref_steps)})


# --------------------------------------------------------------------- serve
def _timed_decode(eng, events, logits=None):
    """Wrap the engine's decode step in CUDA events, tagged by step; with
    ``logits``, keep a copy of each step's logits (outside the events)."""
    inner = eng._decode

    def timed(*a, **kw):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = inner(*a, **kw)
        e.record()
        events.append((eng.step_count, s, e))
        if logits is not None:
            logits.append(out[0].clone())
        return out

    eng._decode = timed


def _counters_at_zero() -> bool:
    """K2's arrival counters, one per stream it ran on, are all 0."""
    from repro_torch.kernels.topk_router import arrival_counters

    torch.cuda.synchronize()
    return all(int(c.item()) == 0 for c in arrival_counters())


def _run_serve(tag, params, cfg, ecfg, e2s, requests, new_tokens,
               logits=None, phase="serve", hook=None):
    """One run of ``requests`` on a MoE config (full granite in ``serve``,
    Mixtral in ``swa``), calling ``hook(engine)`` first if given; checks
    what every run must hold and returns (engine, tokens, launch counts,
    its JSON row)."""
    from repro_torch.kernels import ops

    L = cfg.num_layers
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = _serve(params, cfg, ecfg, "cuda", e2s, requests)
    torch.cuda.synchronize()
    build_bytes = torch.cuda.max_memory_allocated() - base
    if hook is not None:
        hook(eng)
    events = []
    _timed_decode(eng, events, logits)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(len(done) == len(requests), f"{phase} {tag}: not all finished")
    check(all(len(r.generated) == new_tokens for r in done),
          f"{phase} {tag}: wrong token counts")
    calls = L * (eng.prefill_count + eng.decode_count)
    k1 = 0 if eng.config.moe_backend == "dense_ref" else calls  # the oracle
    check(counts["moe_ffn"] == k1 and counts["topk_router_stats"] == calls,
          f"{phase} {tag}: launches {counts}, expected {k1} of K1 and "
          f"{calls} of K2")
    per_layer = eng.expert_counts.sum(axis=1)
    check(bool((per_layer == ecfg.max_batch * cfg.experts_per_token).all()),
          f"{phase} {tag}: expert counts {per_layer}")
    scan = ecfg.decode_mode == "scan"
    check(eng.graph_capture_counts == {"decode": int(scan), "prefill": 0,
                                       "migrate": 0},
          f"{phase} {tag}: capture counts {eng.graph_capture_counts}")
    check(_counters_at_zero(), f"{phase} {tag}: a K2 arrival counter is not 0")
    step_ms = [s.elapsed_time(e) for _, s, e in events]
    median = statistics.median(step_ms)
    row = {
        "phase": phase, "placement": tag, "decode_mode": ecfg.decode_mode,
        "moe_backend": eng.config.moe_backend, "layers": L, "dtype": "bfloat16",
        "kv": "paged" if eng.paged else "dense",
        "requests": len(done), "new_tokens": new_tokens,
        "prefills": eng.prefill_count, "decode_steps": eng.decode_count,
        "launches": counts, "graph_capture_counts": eng.graph_capture_counts,
        "graph_pool_mib": (eng.decode_graph.pool_bytes / 2 ** 20
                           if scan else None),
        "graph_pool_bytes": eng.decode_graph.pool_bytes if scan else None,
        "decode_step_ms_median": median,
        "decode_step_ms_min": min(step_ms),
        "decode_only_tokens_per_s": ecfg.max_batch / (median / 1e3),
        "tokens_per_s": len(done) * new_tokens / wall, "wall_s": wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "build_peak_bytes_over_base": build_bytes,
    }
    return eng, {r.uid: r.generated for r in done}, counts, row


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


def _checksum(tree) -> int:
    """Sum over every leaf of its elements' bit patterns (int64), in the
    leaves' sorted order, weighted by their position: equal only for the
    same bits in the same places (up to collisions)."""
    total = 0
    for i, (_, w) in enumerate(_leaves(tree)):
        bits = w.reshape(-1).view(_BITS[w.dtype]).long()
        total += (i + 1) * int(bits.sum().item())
    return total


def _parent_draw(cfg, seed, dtype, *, experts_by_layer=False):
    """The weights as the parent commit drew them: each stacked weight
    whole in fp32 from one generator, scaled and cast, in
    ``init_params``' order (embed, attention, MoE). ``experts_by_layer``
    draws the expert stacks a layer at a time, as every rank of a mesh
    that shards the pool draws them (keeping its slots): the whole tree
    the ranks' shards are slices of."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.padded_vocab
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Ev, Fv = cfg.num_virtual_experts, cfg.expert_d_ff // cfg.expert_tp

    def normal(shape, scale):
        w = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    check(cfg.tie_embeddings, "the parent's draw is written for tied embeddings")
    embed = normal((V, D), 0.02)
    s, so = float(1.0 / np.sqrt(D)), float(1.0 / np.sqrt(H * hd))
    attn = {"wq": normal((L, D, H * hd), s), "wk": normal((L, D, KV * hd), s),
            "wv": normal((L, D, KV * hd), s), "wo": normal((L, H * hd, D), so)}
    s_out = float(1.0 / np.sqrt(cfg.expert_d_ff))
    def experts(shape, scale):
        if not experts_by_layer:
            return normal(shape, scale)
        return torch.stack([normal(shape[1:], scale) for _ in range(shape[0])])

    moe = {"router": normal((L, D, cfg.num_experts), s),
           "w_gate": experts((L, Ev, D, Fv), s),
           "w_up": experts((L, Ev, D, Fv), s),
           "w_down": experts((L, Ev, Fv, D), s_out)}
    return {"embed": embed, "final_norm": zeros(D),
            "blocks": {"ln1": zeros(L, D), "ln2": zeros(L, D), "attn": attn,
                       "moe": moe}}


def _check_granite_bits(params, cfg):
    """Drawing large stacks one layer at a time must leave granite's
    weights as the parent drew them: the checksums must be equal."""
    parent = _parent_draw(cfg, 0, torch.bfloat16)
    ours, theirs = _checksum(params), _checksum(parent)
    names = [n for n, _ in _leaves(params)]
    check(names == [n for n, _ in _leaves(parent)],
          f"granite params tree {names} differs from the parent's")
    check(ours == theirs,
          f"granite weights changed: checksum {ours} != the parent's {theirs}")
    del parent
    torch.cuda.empty_cache()
    emit({"phase": "serve", "granite_weights_checksum": ours,
          "equals_parent_draw": True})


def phase_serve(summary):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig

    start = time.perf_counter()
    cfg = get_config(ARCH)
    L = cfg.num_layers
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    _check_granite_bits(params, cfg)
    s2e, e2s = _placement(L, cfg.num_virtual_experts, seed=4)
    check(not (s2e == np.arange(cfg.num_virtual_experts)).all(), "identity placement")
    placed = _with_placement(params, s2e)
    rng = np.random.default_rng(5)
    new_tokens = 32
    requests = [(rng.integers(0, cfg.vocab_size, size=int(n)), new_tokens)
                for n in rng.integers(32, 129, size=8)]
    ecfg = EngineConfig(max_batch=8, max_len=256)
    scan = {"logits": []}
    scan["eng"], scan["tokens"], main_counts, scan["row"] = _run_serve(
        "placed", placed, cfg, ecfg, e2s, requests, new_tokens, scan["logits"])
    serve_peak = torch.cuda.max_memory_allocated()
    summary["serve_decode_step_ms_median"] = scan["row"]["decode_step_ms_median"]
    emit(scan["row"])
    _, tokens, _, row = _run_serve(
        "identity", params, cfg, ecfg, None, requests, new_tokens)
    emit(row)
    check(scan["tokens"] == tokens,
          "serve: tokens under the placement differ from identity")
    close_phase({"phase": "serve", "ok": True, "placement_invariant": True},
                start)
    phase_graph(placed, cfg, ecfg, e2s, requests, new_tokens, scan, summary)
    return main_counts, serve_peak


def phase_graph(placed, cfg, ecfg, e2s, requests, new_tokens, scan, summary):
    """The serve phase's placed run again, in ``decode_mode="python"``:
    tokens equal, logits compared bit for bit, both modes' numbers side
    by side; then three profiled decode steps of each mode."""
    start = time.perf_counter()
    py_ecfg = dataclasses.replace(ecfg, decode_mode="python")
    py_logits = []
    py_eng, py_tokens, _, py_row = _run_serve(
        "placed", placed, cfg, py_ecfg, e2s, requests, new_tokens, py_logits)
    emit(py_row)
    scan_logits, scan_row = scan["logits"], scan["row"]
    check(py_tokens == scan["tokens"],
          "graph: the captured step's tokens differ from the eager step's")
    check(len(py_logits) == len(scan_logits) == py_row["decode_steps"],
          "graph: the two runs decoded different numbers of steps")
    bit_equal = [same_bits(a, b) for a, b in zip(scan_logits, py_logits)]
    max_diff = max((a - b).abs().max().item()
                   for a, b in zip(scan_logits, py_logits))
    scan_ms = scan_row["decode_step_ms_median"]
    py_ms = py_row["decode_step_ms_median"]
    emit({"phase": "graph", "ok": True, "tokens_equal_python": True,
          "logits_bit_equal_steps": sum(bit_equal), "steps": len(bit_equal),
          "logits_max_abs_diff": max_diff,
          "decode_step_ms_median": {"scan": scan_ms, "python": py_ms},
          "decode_only_tokens_per_s": {
              "scan": scan_row["decode_only_tokens_per_s"],
              "python": py_row["decode_only_tokens_per_s"]},
          "tokens_per_s": {"scan": scan_row["tokens_per_s"],
                           "python": py_row["tokens_per_s"]},
          "speedup_step_median": py_ms / scan_ms,
          "graph_capture_counts": scan_row["graph_capture_counts"],
          "graph_pool_mib": scan_row["graph_pool_mib"]})
    scan_logits.clear()
    py_logits.clear()
    # the captured step alone, all rows idle (only the null KV block is
    # written): host time until the call returns, and until the card is done
    eng, B = scan["eng"], ecfg.max_batch
    idle = (np.zeros(B, np.int32), np.zeros((B, 1), np.int32),
            np.zeros((B, eng.decode_graph.n_max), np.int32))
    call_ms, done_ms = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._decode(eng.params, eng.caches, idle[0], idle[1], cfg,
                    eng.placements, block_tables=idle[2])
        call_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        done_ms.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "graph", "replay_call_host_ms": statistics.median(call_ms),
          "replay_done_host_ms": statistics.median(done_ms)})
    for mode, eng in (("scan", scan["eng"]), ("python", py_eng)):
        phase_profile(eng, mode, requests, summary)
    check(_counters_at_zero(), "graph: a K2 arrival counter is not 0")
    close_phase({"phase": "graph", "profiled": ["scan", "python"]}, start)


def phase_profile(eng, mode, requests, summary, steps: int = 3):
    """Where a decode step's time goes: torch.profiler over ``steps``
    decode-only engine steps at max_batch 8 (after the prefill step and
    one warm step). Device busy time is the sum of the kernels' own time
    (one stream, so they do not overlap); the rest of the host-clock
    window is the card's idle share. Launches count ``cudaLaunch*`` and
    ``cudaGraphLaunch`` calls. Beside the port kernels' device time per
    call in the step, it repeats the two that the decode step does not
    run, from the ``kernels`` phase: K1 at the prefill shape and K3. A
    trace retaken by :func:`_traced` covers the next ``steps`` steps: the
    requests hold enough new tokens for every attempt, the check below
    holds that no request finished before the kept window's end, and the
    row names the attempts and the window's steps."""
    from torch.autograd import DeviceType

    attempts = 3
    check(min(new for _, new in requests) > 2 + steps * (1 + attempts),
          f"profile {mode}: too few new tokens for {attempts} traces")
    finished = len(eng.finished)
    for prompt, new in requests:
        eng.submit(prompt, max_new_tokens=new)
    eng.step()  # admits and prefills all requests, decodes once
    eng.step()
    plain_ms = []  # the same decode-only steps without the profiler
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    def run():
        first = eng.step_count
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, (first, eng.step_count - 1)

    avgs, (wall, window), tries = _traced(run, attempts)
    check(len(eng.finished) == finished,
          f"profile {mode}: a request finished inside the profiled steps")
    dev = [e for e in avgs if e.device_type == DeviceType.CUDA]
    cpu = [e for e in avgs if e.device_type == DeviceType.CPU]
    busy_us = sum(e.self_device_time_total for e in dev)
    port = {e.key[:80]: e.self_device_time_total / e.count for e in dev
            if _is_port_kernel(e.key)}
    check(bool(port),
          f"profile {mode}: the decode steps ran none of the port's kernels")

    def top(rows, key, n=12):
        rows = sorted(rows, key=key, reverse=True)[:n]
        return [{"name": e.key[:80], "calls_per_step": e.count / steps,
                 "us_per_step": key(e) / steps} for e in rows]

    def calls(prefix):
        return sum(e.count for e in cpu if e.key.startswith(prefix)) / steps

    emit({
        "phase": "profile", "decode_mode": mode, "decode_steps": steps,
        "trace_attempts": tries, "profiled_engine_steps": window,
        "step_ms_host": wall / steps * 1e3,
        "step_ms_host_unprofiled": statistics.median(plain_ms),
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        # the profiled busy time over the unprofiled step: an estimate
        # from two windows of the same steps' work
        "device_idle_share_unprofiled_est":
            1.0 - busy_us / steps / 1e3 / statistics.median(plain_ms),
        "device_ops_per_step": sum(e.count for e in dev) / steps,
        "cuda_launches_per_step": calls("cudaLaunch"),
        "cuda_graph_launches_per_step": calls("cudaGraphLaunch"),
        "port_kernels_us_per_call": port,
        "moe_ffn_prefill_device_us": summary["moe_ffn/prefill"]["device_us"],
        "topk_router_device_us": summary["topk_router/decode"]["device_us"],
        "top_device": top(dev, lambda e: e.self_device_time_total),
        "top_host_self": top(cpu, lambda e: e.self_cpu_time_total),
    })


# -------------------------------------------------------------------- replan
# ----------------------------------------------------------------- dense_ref
DENSE_REF_REQUESTS = 8
DENSE_REF_NEW = 16


def _drop_log(steps):
    """A ``_run_serve`` hook: each decode step's (dropped, overflow)
    assignment counts summed over the layers, read after the step as the
    engine reads them."""
    def hook(eng):
        inner = eng._moe_step

        def step(moe_aux, sim_latency):
            steps.append((int(moe_aux.dropped_tokens.sum()),
                          int(moe_aux.overflow_tokens.sum())))
            return inner(moe_aux, sim_latency)

        eng._moe_step = step

    return hook


def phase_dense_ref(summary):
    """The capacity-free oracle, ``EngineConfig(moe_backend="dense_ref")``:
    card ≡ CPU at 2 layers fp32, then full granite in bf16, placed ≡
    identity in ``"scan"`` with one capture each, no drop or overflow on
    any step, K2 launched and K1 never. Returns the launch counts of the
    phase's card runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    total = collections.Counter()
    counts, _ = _card_against_cpu(
        "dense_ref", EngineConfig(max_batch=4, max_len=64,
                                  moe_backend="dense_ref"))
    total.update(counts)
    cfg = get_config(ARCH)
    L = cfg.num_layers
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    s2e, e2s = _placement(L, cfg.num_virtual_experts, seed=4)
    placed = _with_placement(params, s2e)
    rng = np.random.default_rng(6)
    requests = [(rng.integers(0, cfg.vocab_size, size=int(n)), DENSE_REF_NEW)
                for n in rng.integers(32, 65, size=DENSE_REF_REQUESTS)]
    ecfg = EngineConfig(max_batch=8, max_len=128, moe_backend="dense_ref")
    runs = {}
    for tag, p, table in (("placed", placed, e2s), ("identity", params, None)):
        steps = []
        eng, tokens, counts, row = _run_serve(
            tag, p, cfg, ecfg, table, requests, DENSE_REF_NEW,
            phase="dense_ref", hook=_drop_log(steps))
        check(eng.config.moe_backend == "dense_ref",
              f"dense_ref {tag}: the engine runs {eng.config.moe_backend}")
        check(len(steps) == eng.decode_count
              and all(d == o == 0 for d, o in steps),
              f"dense_ref {tag}: dropped/overflow by step {steps}")
        check(counts["moe_ffn"] == counts["moe_ffn_wgmma"] == 0
              and counts["topk_router"] == 0
              and counts["topk_router_stats"] > 0,
              f"dense_ref {tag}: launches {counts}")
        row["steps_dropped_overflow_zero"] = len(steps)
        emit(row)
        total.update(counts)
        runs[tag] = (tokens, row)
        del eng
        gc.collect()
    check(runs["placed"][0] == runs["identity"][0],
          "dense_ref: tokens under the placement differ from identity")
    row = runs["placed"][1]
    close_phase({"phase": "dense_ref", "ok": True, "placement_invariant": True,
                 "layers": L, "dtype": "bfloat16", "decode_mode": "scan",
                 "requests": DENSE_REF_REQUESTS, "new_tokens": DENSE_REF_NEW,
                 "decode_step_ms_median": row["decode_step_ms_median"],
                 "staged_decode_step_ms_median":
                     summary["serve_decode_step_ms_median"],
                 "peak_mem_gib": row["peak_mem_gib"],
                 "graph_pool_bytes": row["graph_pool_bytes"],
                 "launches": dict(total), "cards": _cards()}, t0)
    del params, placed
    gc.collect()
    torch.cuda.empty_cache()
    return total


def _run_launcher(policy, hooks=None):
    """One run of the port's launcher at full granite on the card; returns
    the engine, its launch counts and the host seconds of the run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher

    eng = launcher.build(launcher.parse_args(
        ["--policy", policy, "--requests", "8", "--max-new-tokens", "32"]))
    if hooks is not None:
        hooks(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(len(done) == 8 and all(len(r.generated) == 32 for r in done),
          f"replan {policy}: not all requests finished with 32 tokens")
    return eng, counts, wall


def phase_replan(serve_peak):
    from repro_torch.kernels import ops

    start = time.perf_counter()
    # the serve phase's decode timers close over their engines, so those
    # engines and their pools are freed only by the cycle collector
    gc.collect()
    events, at_swap = [], {}

    def hooks(eng):
        _timed_decode(eng, events)
        plan, migrate = eng.planner.plan, eng._migrate

        def timed_plan():
            t0 = time.perf_counter()
            out = plan()
            at_swap["planner_s"] = time.perf_counter() - t0
            return out

        def timed_migrate(src, tables, *ws):
            torch.cuda.synchronize()
            at_swap["launches"] = ops.launch_counts()
            at_swap["captures"] = dict(eng.graph_capture_counts)
            at_swap["calls"] = eng.config.num_layers * (
                eng.prefill_count + eng.decode_count)
            at_swap["run_peak"] = torch.cuda.max_memory_allocated()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = migrate(src, tables, *ws)
            e.record()
            torch.cuda.synchronize()
            at_swap["ms"] = s.elapsed_time(e)
            at_swap["extra_bytes"] = torch.cuda.max_memory_allocated() - base
            at_swap["src"] = np.asarray(src)
            return out

        eng.planner.plan, eng._migrate = timed_plan, timed_migrate

    eng, counts, wall = _run_launcher("gem", hooks)
    cfg = eng.config
    L, Ev = cfg.num_layers, cfg.num_virtual_experts
    run_peak = max(at_swap["run_peak"], torch.cuda.max_memory_allocated())
    check(eng.placement_applied, "replan: the placement was not applied")
    (rec,) = eng.migration_records
    check(rec["step"] == 16, f"replan: fired at step {rec['step']}, not 16")
    s2e = np.stack([p.slot_to_expert() for p in eng.current_placements])
    check(np.array_equal(at_swap["src"], s2e),
          "replan: the migration's row sources are not the plan")
    check(bool((s2e != np.arange(Ev)).any(axis=1).all()),
          "replan: the GEM placement is identity in some layer")
    check(np.array_equal(eng.placements.cpu().numpy(), np.argsort(s2e, axis=1)),
          "replan: the router tables are not the plan's inverse")
    calls = L * (eng.prefill_count + eng.decode_count)
    check(counts["moe_ffn"] == calls and counts["topk_router_stats"] == calls,
          f"replan: launches {counts} != {calls}")
    before = at_swap["launches"]
    check(before["moe_ffn"] == before["topk_router_stats"] == at_swap["calls"]
          and at_swap["calls"] < calls,
          f"replan: launches before the swap {before} != {at_swap['calls']}")
    # "scan" mode: one capture when the engine was built, none for the swap
    one = {"decode": 1, "prefill": 0, "migrate": 0}
    check(eng.ecfg.decode_mode == "scan"
          and at_swap["captures"] == eng.graph_capture_counts == one,
          f"replan: captures {at_swap['captures']} before the swap, "
          f"{eng.graph_capture_counts} after it; want {one}")
    check(_counters_at_zero(), "replan: a K2 arrival counter is not 0")
    moe = eng.params["blocks"]["moe"]
    layer_rows = sum(moe[n][0].numel() * moe[n].element_size()
                     for n in ("w_gate", "w_up", "w_down"))
    check(at_swap["extra_bytes"] <= layer_rows,
          f"replan: the swap took {at_swap['extra_bytes']} B beyond the "
          f"pool, more than one layer's rows ({layer_rows} B)")
    check(run_peak <= serve_peak + layer_rows,
          f"replan: peak {run_peak} B over the serve phase's {serve_peak} B")
    step_ms = {True: [], False: []}
    for step, s, e in events:
        step_ms[step >= rec["step"]].append(s.elapsed_time(e))

    # the linear run keeps the pre-swap pool (same seed-0 weights, never
    # moved): the tokens must match, and its rows, gathered by the plan,
    # must be the gem engine's rows bit for bit
    lin, lin_counts, lin_wall = _run_launcher("linear")
    check(not lin.migration_records, "replan: the linear run migrated")
    tokens = {r.uid: r.generated for r in eng.finished}
    check(tokens == {r.uid: r.generated for r in lin.finished},
          "replan: tokens under the GEM placement differ from linear")
    lin_moe = lin.params["blocks"]["moe"]
    rows = torch.as_tensor(s2e, device=lin_moe["w_gate"].device).long()
    for name in ("w_gate", "w_up", "w_down"):
        for layer in range(L):
            check(same_bits(moe[name][layer], lin_moe[name][layer][rows[layer]]),
                  f"replan: {name}[{layer}] rows differ from the plan's experts")
    # the same migration again, warm, on the linear engine's pool: it must
    # land on the same bytes
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    lin._migrate(s2e, None, lin_moe["w_gate"], lin_moe["w_up"], lin_moe["w_down"])
    e.record()
    torch.cuda.synchronize()
    warm_ms = s.elapsed_time(e)
    check(all(same_bits(moe[n], lin_moe[n]) for n in ("w_gate", "w_up", "w_down")),
          "replan: the warm migration gave other bytes")

    moved = int((s2e != np.arange(Ev)).sum())
    row_bytes = layer_rows / Ev
    emit({
        "phase": "replan", "policy": "gem", "layers": L,
        "dtype": str(moe["w_gate"].dtype),
        "requests": len(eng.finished), "new_tokens": 32,
        "prefills": eng.prefill_count, "decode_steps": eng.decode_count,
        "replan_step": rec["step"], "placement_applied": True,
        "moved_slots": moved, "moves": rec["moves"],
        "planner_host_s": at_swap["planner_s"],
        "migration_ms": at_swap["ms"], "migration_warm_ms": warm_ms,
        # each moved row read once and written once; every row of the pool
        "migration_bound_ms": 2 * moved * row_bytes / HBM_BYTES_PER_S * 1e3,
        "migration_bound_all_rows_ms":
            2 * L * layer_rows / HBM_BYTES_PER_S * 1e3,
        "migration_modeled_ms": rec["modeled_s"] * 1e3,
        "migration_extra_mib": at_swap["extra_bytes"] / 2 ** 20,
        "layer_rows_mib": layer_rows / 2 ** 20,
        "peak_mem_gib": run_peak / 2 ** 30,
        "serve_peak_mem_gib": serve_peak / 2 ** 30,
        "decode_step_ms_median_before": statistics.median(step_ms[False]),
        "decode_step_ms_median_after": statistics.median(step_ms[True]),
        "launches": counts, "launches_before_swap": before,
        "decode_mode": eng.ecfg.decode_mode,
        "graph_capture_counts": eng.graph_capture_counts,
        "graph_pool_mib": eng.decode_graph.pool_bytes / 2 ** 20,
        "wall_s": wall, "linear_wall_s": lin_wall,
        "tokens_per_s": 8 * 32 / wall, "linear_tokens_per_s": 8 * 32 / lin_wall,
        "latency_report": eng.latency_report(),
    })
    close_phase({"phase": "replan", "ok": True, "tokens_equal_linear": True,
                 "rows_equal_plan": True,
                 "linear_launches": lin_counts}, start)
    return counts


# -------------------------------------------------------------------- online
# 48 requests of ~10 new tokens at max_batch 8 run ~65 steps: the warm-up
# plan (~4,700 row moves at full granite) and the plan after the slowdown
# each drain in ~19 batches of 256, and some steps follow the last batch
ONLINE_REQUESTS = 48
ONLINE_RATE = 2000.0  # req/s of simulated time: the stream is in by step ~12
ONLINE_SLOWDOWN_STEP = 34  # after the warm-up plan has drained
# the fastest device's curve × 1.5 (2/3 of its speed): the variability
# detector (EWMA 0.2, threshold 0.25) fires on its 4th step and repairs
# the belief to ×1.3, inside the threshold, so it fires once
ONLINE_SLOWDOWN = 1.5
ONLINE_MOVES_PER_STEP = 256  # row moves a batch may make (a swap is two)


def _online_stream(vocab_size):
    """fig23's chat/summarize task profiles at full vocab, the mix shifting
    from 0.8/0.2 to 0.2/0.8 halfway through a Poisson stream."""
    from repro_torch.serving import ArrivalConfig, TaskProfile, generate_arrivals

    chat = TaskProfile("chat", prompt_buckets=(8, 16), output_mean=12.0,
                       output_bounds=(4, 24), vocab_band=(0.0, 0.5))
    summ = TaskProfile("summarize", prompt_buckets=(16, 32), output_mean=8.0,
                       output_bounds=(4, 16), vocab_band=(0.5, 1.0))
    return generate_arrivals(
        ArrivalConfig(rate=ONLINE_RATE, num_requests=ONLINE_REQUESTS,
                      process="poisson"),
        vocab_size, seed=6, mix=[(chat, 0.8), (summ, 0.2)],
        mix_shift=(0.5 * ONLINE_REQUESTS / ONLINE_RATE,
                   [(chat, 0.2), (summ, 0.8)]),
    )


def _online_engine(params, cfg, profile, *, online):
    from repro_torch.core import GEMConfig
    from repro_torch.online import DriftConfig, MigrationConfig
    from repro_torch.serving import EngineConfig, ServingEngine

    ecfg = EngineConfig(
        max_batch=8, max_len=128,
        gem=GEMConfig(trace_length=16, num_restarts=10),
        placement_policy="gem" if online else "linear",
        other_time_per_step=2e-4, online=online,
        drift=DriftConfig(min_steps=4), replan_cooldown=8,
        payback_horizon=1_000_000,  # the gate never skips a plan here
        migration=MigrationConfig(max_moves_per_step=ONLINE_MOVES_PER_STEP),
        decode_mode="scan",
    )
    return ServingEngine(params, cfg, ecfg, profile=profile, num_devices=4,
                         device="cuda")


def _row_checksums(w, layers=None):
    """(L, S, 2) int64 per-row checksums of a weight's bits: the sum, and a
    sum weighted by position, computed one layer at a time (of ``layers``
    only, when given)."""
    bits = _BITS[w.dtype]
    n = w[0, 0].numel()
    weight = (torch.arange(n, device=w.device) % 251 + 1).to(torch.int64)
    out = []
    for layer in (range(w.shape[0]) if layers is None else layers):
        x = w[layer].reshape(w.shape[1], n).view(bits).to(torch.int64)
        out.append(torch.stack([x.sum(1), (x * weight).sum(1)], dim=1))
        del x
    return torch.stack(out).cpu()


def phase_online(serve_peak, cfg=None):
    """GEM's online plane at full granite: drift-triggered replans whose
    budgeted batches land in place inside the captured decode step."""
    from repro_torch.configs import get_config
    from repro_torch.core import VariabilityProfile
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import emulated_profile
    from repro_torch.models import init_params
    from repro_torch.online import ServeScenario, serve_scenario

    start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = cfg or dataclasses.replace(get_config(ARCH), decode_capacity_factor=4.0)
    L, Ev = cfg.num_layers, cfg.num_virtual_experts
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    moe = params["blocks"]["moe"]
    names = ("w_gate", "w_up", "w_down")
    sums = {n: _row_checksums(moe[n]) for n in names}  # virtual order
    believed = emulated_profile("high", 4)
    fast = int(np.argmax(believed.relative_speed()))
    lat = believed.latencies.copy()
    lat[fast] *= ONLINE_SLOWDOWN
    slowed = VariabilityProfile(believed.token_counts, lat, believed.tile_size)
    specs = list(_online_stream(cfg.vocab_size))

    def scenario(tag):
        return ServeScenario(tag, list(specs),
                             profile_schedule={ONLINE_SLOWDOWN_STEP: slowed})

    # the linear, non-online run first: it never moves the pool
    lin = _online_engine(params, cfg, believed, online=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_scenario(lin, scenario("linear"))
    torch.cuda.synchronize()
    lin_wall = time.perf_counter() - t0
    check(not lin.migration_records, "online: the linear run migrated")
    lin_tokens = {r.uid: r.generated for r in lin.finished}
    lin_steps = lin.step_count
    del lin
    gc.collect()

    eng = _online_engine(params, cfg, believed, online=True)
    events, batches, host = [], [], {"observe": [], "attr": [], "regret": []}
    _timed_decode(eng, events)
    state = {"run_peak": 0}

    def timed_host(fn, key):
        def wrapped(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            host[key].append((eng.step_count, time.perf_counter() - t, out))
            return out
        return wrapped

    ctrl = eng.controller
    ctrl.observe_step = timed_host(ctrl.observe_step, "observe")
    eng._observe_attribution = timed_host(eng._observe_attribution, "attr")
    eng._observe_regret = timed_host(eng._observe_regret, "regret")
    migrate = eng._migrate

    def timed_migrate(src, tables, *ws):
        torch.cuda.synchronize()
        state["run_peak"] = max(state["run_peak"], torch.cuda.max_memory_allocated())
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = migrate(src, tables, *ws)
        e.record()
        torch.cuda.synchronize()
        src = np.asarray(src)
        batches.append({
            "step": eng.step_count, "ms": s.elapsed_time(e),
            "moved_slots": int((src != np.arange(src.shape[1])).sum()),
            "layers": int((src != np.arange(src.shape[1])).any(axis=1).sum()),
            "extra_bytes": torch.cuda.max_memory_allocated() - base,
        })
        return out

    eng._migrate = timed_migrate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = serve_scenario(eng, scenario("gem-online"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    run_peak = max(state["run_peak"], torch.cuda.max_memory_allocated())

    check(len(done) == ONLINE_REQUESTS, "online: not every request finished")
    calls = L * (eng.prefill_count + eng.decode_count)
    check(counts["moe_ffn"] == calls and counts["topk_router_stats"] == calls,
          f"online: launches {counts} != {calls}")
    replans = ctrl.replans
    applied = {r["reason"] for r in replans if r["applied"]}
    check({"warmup", "variability-drift"} <= applied,
          f"online: replans applied {[(r['step'], r['reason']) for r in replans]}")
    # each replan happened inside one observe_step call: its host time is
    # the planner's (the search, the diff, the gate)
    plan_s = [t for _, t, decision in host["observe"] if decision.replanned]
    recs = eng.migration_records
    steps = [r["step"] for r in recs]
    check(len(recs) >= 2 and len(set(steps)) == len(steps),
          f"online: batches at steps {steps}")
    check(len(batches) == len(recs), "online: a batch bypassed the executable")
    check(len(plan_s) == len(replans), "online: replans outside observe_step")
    check(all(0 < r["moves"] <= ONLINE_MOVES_PER_STEP for r in recs)
          and all(b["moved_slots"] <= ONLINE_MOVES_PER_STEP for b in batches),
          f"online: a batch over the budget {ONLINE_MOVES_PER_STEP}")
    one = {"decode": 1, "prefill": 0, "migrate": 0}
    check(eng.graph_capture_counts == one,
          f"online: captures {eng.graph_capture_counts}, want {one}")
    check(_counters_at_zero(), "online: a K2 arrival counter is not 0")
    # every batch has landed, and every slot holds the bytes of the expert
    # the live placement puts there
    s2e = np.stack([p.slot_to_expert() for p in eng.current_placements])
    check(not ctrl.migrating and np.array_equal(np.stack(ctrl.slot_layouts), s2e),
          "online: the stream ended before the last plan had drained")
    check(np.array_equal(eng.placements.cpu().numpy(), np.argsort(s2e, axis=1)),
          "online: the router tables are not the inverse of slot_to_expert")
    check(bool((s2e != np.arange(Ev)).any()), "online: the layout never moved")
    rows = torch.as_tensor(s2e).long()
    for n in names:
        got = _row_checksums(moe[n])
        want = torch.stack([sums[n][layer][rows[layer]] for layer in range(L)])
        check(torch.equal(got, want),
              f"online: {n} rows are not the experts the placement names")
    tokens = {r.uid: r.generated for r in done}
    check(tokens == lin_tokens, "online: tokens differ from the linear run")
    layer_rows = {n: moe[n][0].numel() * moe[n].element_size() for n in names}
    one_weight = max(layer_rows.values())
    # beside the scratch, a batch holds its (slot, source) pairs on the
    # card: 16 B a moved slot, in 512 B allocator blocks
    over = [b for b in batches if b["extra_bytes"] > one_weight
            + -(-16 * b["moved_slots"] // 512) * 512]
    extra = max(b["extra_bytes"] for b in batches)
    check(not over,
          f"online: batches {over} took more than one layer's rows of one "
          f"weight ({one_weight} B) and their index pairs beyond the pool")
    check(run_peak <= serve_peak + one_weight,
          f"online: peak {run_peak} B over the serve phase's {serve_peak} B")

    first, last = batches[0]["step"], batches[-1]["step"]
    step_ms = {"before": [], "draining": [], "after": []}
    for step, s, e in events:
        key = ("before" if step < first else "after" if step > last
               else "draining")
        step_ms[key].append(s.elapsed_time(e))
    slot_bytes = sum(layer_rows.values()) / Ev
    swap_ms = [b["ms"] for b in batches]
    bound_ms = [2 * b["moved_slots"] * slot_bytes / HBM_BYTES_PER_S * 1e3
                for b in batches]
    emit({
        "phase": "online", "layers": L, "dtype": str(moe["w_gate"].dtype),
        "decode_mode": eng.ecfg.decode_mode, "requests": len(done),
        "prefills": eng.prefill_count, "decode_steps": eng.decode_count,
        "engine_steps": eng.step_count, "linear_engine_steps": lin_steps,
        "max_moves_per_step": ONLINE_MOVES_PER_STEP,
        "slowdown_step": ONLINE_SLOWDOWN_STEP, "slowed_device": fast,
        "replans": [
            {"step": r["step"], "reason": r["reason"], "applied": r["applied"],
             "moves": r["moves"], "planner_host_s": t}
            for r, t in zip(replans, plan_s)],
        "batches": [{"step": b["step"], "moved_slots": b["moved_slots"],
                     "layers": b["layers"], "ms": b["ms"]} for b in batches],
        "swap_ms_median": statistics.median(swap_ms),
        "swap_bound_ms_median": statistics.median(bound_ms),
        "swap_ms_max": max(swap_ms), "swap_bound_ms_max": max(bound_ms),
        "swap_extra_mib_max": extra / 2 ** 20,
        "one_layer_one_weight_mib": one_weight / 2 ** 20,
        "decode_step_ms_median": {k: statistics.median(v) if v else None
                                  for k, v in step_ms.items()},
        "decode_steps_by_window": {k: len(v) for k, v in step_ms.items()},
        "host_ms_per_step_median": {
            k: statistics.median(t for _, t, _ in v) * 1e3
            for k, v in host.items()},
        "host_ms_per_step_mean": {
            k: statistics.fmean(t for _, t, _ in v) * 1e3
            for k, v in host.items()},
        "tokens_per_s": sum(len(t) for t in tokens.values()) / wall,
        "wall_s": wall, "linear_wall_s": lin_wall,
        "linear_tokens_per_s": sum(len(t) for t in lin_tokens.values()) / lin_wall,
        "peak_mem_gib": run_peak / 2 ** 30,
        "serve_peak_mem_gib": serve_peak / 2 ** 30,
        "launches": counts, "graph_capture_counts": eng.graph_capture_counts,
        "latency_report": eng.latency_report(),
    })
    close_phase({"phase": "online", "ok": True, "tokens_equal_linear": True,
                 "rows_equal_placement": True, "tables_inverse": True,
                 "batches": len(batches),
                 "replans_applied": sorted(applied)}, start)
    return counts


# ---------------------------------------------------------------- replicated
def _check_rows(tag, moe, sums, s2e, layers):
    """Each slot's rows in ``layers`` are the bytes of the expert ``s2e``
    puts there (checksums of the virtual-order pool, ``sums``)."""
    rows = torch.as_tensor(s2e).long()
    for n, want_all in sums.items():
        got = _row_checksums(moe[n], layers)
        want = torch.stack([want_all[layer][rows[layer]] for layer in layers])
        check(torch.equal(got, want),
              f"{tag}: {n} rows are not the experts the layout names")


def _live_layout(eng):
    return np.stack([rp.slot_to_expert for rp in eng.current_rplacements])


def _check_tables(tag, eng):
    P = eng.ecfg.replication.pattern_period
    want = np.stack([rp.replica_table(P) for rp in eng.current_rplacements])
    check(np.array_equal(eng.placements.cpu().numpy(), want),
          f"{tag}: the tables are not replica_table(P) of the live layouts")


def _timed_swaps(eng, swaps):
    """Time each call of the engine's migration executable (CUDA events)
    and record the moved slots, touched layers and extra memory."""
    migrate = eng._migrate

    def timed(src, tables, *ws):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = migrate(src, tables, *ws)
        e.record()
        torch.cuda.synchronize()
        moved = np.asarray(src) != np.arange(np.shape(src)[1])
        swaps.append({"step": eng.step_count, "ms": s.elapsed_time(e),
                      "moved_slots": int(moved.sum()),
                      "layers": [int(x) for x in np.nonzero(moved.any(axis=1))[0]],
                      "extra_bytes": torch.cuda.max_memory_allocated() - base,
                      "peak_before": peak})
        return out

    eng._migrate = timed


def _replicated_engine(cfg, *, online, sums, install, shed=True):
    """Seed-0 full granite with the zeroed router, built into a replicated
    shed engine; the install (the pool's expansion) is timed with CUDA
    events, the virtual-order pool is dropped, and the expanded pool's
    rows and tables are checked. ``sums`` gets the virtual-order row
    checksums on the first call."""
    from repro_torch.serving import engine as engine_module

    params = _shed_params(cfg, "cuda", torch.bfloat16)
    moe = params["blocks"]["moe"]
    names = ("w_gate", "w_up", "w_down")
    if not sums:
        sums.update({n: _row_checksums(moe[n]) for n in names})
    pool80 = sum(moe[n].numel() * moe[n].element_size() for n in names)
    apply_placement = engine_module.apply_placement

    def timed_install(moe, s2e):
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = apply_placement(moe, s2e)
        e.record()
        torch.cuda.synchronize()
        install.append(s.elapsed_time(e))
        return out

    engine_module.apply_placement = timed_install
    try:
        eng = _shed_engine(params, cfg, "cuda", "scan", online=online,
                           shed=shed)
    finally:
        engine_module.apply_placement = apply_placement
    del params, moe  # the virtual-order pool goes: the engine holds its own
    gc.collect()
    torch.cuda.empty_cache()
    tag = "replicated " + ("online" if online else "one-shot")
    moe = eng.params["blocks"]["moe"]
    S = int(moe["w_gate"].shape[1])
    L, Ev = cfg.num_layers, cfg.num_virtual_experts
    check(S == Ev + SHED_DEVICES * SHED_REPLICA_SLOTS,
          f"{tag}: {S} slots a layer, not {Ev + SHED_DEVICES}")
    extra = sum(moe[n].numel() * moe[n].element_size() for n in names) - pool80
    check(extra == SHED_DEVICES * SHED_REPLICA_SLOTS * L * 3 * cfg.d_model
          * (cfg.expert_d_ff // cfg.expert_tp) * 2,
          f"{tag}: the pool grew by {extra} B")
    _check_rows(f"{tag} install", moe, sums, _live_layout(eng), range(L))
    _check_tables(f"{tag} install", eng)
    return eng, extra, pool80 / (L * Ev)


def phase_replicated(serve_ms, serve_peak):
    """The replicated pool and the shed pass at full granite inside the
    captured decode step: the shed scenario online (replica batches, shed
    enables flipping), then a one-shot replicated GEM run (one retarget)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.replication import ReplicatedPlacement

    start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(ARCH), decode_capacity_factor=SHED_DECODE_CF)
    L, Ev = cfg.num_layers, cfg.num_virtual_experts
    S = Ev + SHED_DEVICES * SHED_REPLICA_SLOTS
    sums, install = {}, []
    eng, extra, slot_bytes = _replicated_engine(cfg, online=True, sums=sums,
                                                install=install)

    # ---- the online run: replica batches and shed enables in the step
    events, swaps, shed_steps, shed_host, enables = [], [], [], [], []
    _timed_decode(eng, events)
    _timed_swaps(eng, swaps)
    _record_shed(eng, shed_steps, shed_host)
    moe = eng.params["blocks"]["moe"]
    online_step, step = eng._online_step, eng.step
    checked = {"batches": 0}

    def checked_online_step(counts_virt, cost_mx):
        n = len(swaps)
        out = online_step(counts_virt, cost_mx)
        if len(swaps) > n:  # a batch landed: its layers' rows, the tables
            tag = f"replicated batch at step {swaps[-1]['step']}"
            _check_rows(tag, moe, sums, _live_layout(eng), swaps[-1]["layers"])
            _check_tables(tag, eng)
            checked["batches"] += 1
        return out

    def step_with_enables():
        enables.append(eng.shed_enables.tolist())
        return step()

    eng._online_step, eng.step = checked_online_step, step_with_enables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _drive_shed(eng, cfg.vocab_size)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = max([torch.cuda.max_memory_allocated()]
               + [b["peak_before"] for b in swaps])
    calls = L * (eng.prefill_count + eng.decode_count)
    check(counts["moe_ffn"] == calls and counts["topk_router_stats"] == calls,
          f"replicated: launches {counts} != {calls}")
    one = {"decode": 1, "prefill": 0, "migrate": 0}
    check(eng.graph_capture_counts == one,
          f"replicated: captures {eng.graph_capture_counts}, want {one}")
    check(_counters_at_zero(), "replicated: a K2 arrival counter is not 0")
    check(bool(swaps) and checked["batches"] == len(swaps)
          == len(eng.migration_records),
          f"replicated: {len(swaps)} swaps, {checked['batches']} checked, "
          f"{len(eng.migration_records)} records")
    check(len({tuple(x) for x in enables}) > 1,
          "replicated: the shed enables never flipped")
    _check_shed_counts("replicated", shed_steps)
    _check_rows("replicated end", moe, sums, _live_layout(eng), range(L))
    _check_tables("replicated end", eng)
    step_ms = [s.elapsed_time(e) for _, s, e in events]
    bound_ms = [2 * b["moved_slots"] * slot_bytes / HBM_BYTES_PER_S * 1e3
                for b in swaps]
    shed_by_step = [sum(x) for _, x, _ in shed_steps]
    replay = _profile_replay(eng)
    emit({
        "phase": "replicated", "run": "online", "layers": L,
        "dtype": str(moe["w_gate"].dtype), "decode_mode": eng.ecfg.decode_mode,
        "slots": S, "pool_extra_mb": extra / 1e6, "pool_extra_mib": extra / 2 ** 20,
        "install_ms": install[0],
        "install_bound_ms": 2 * L * S * slot_bytes / HBM_BYTES_PER_S * 1e3,
        "requests": len(eng.finished), "prefills": eng.prefill_count,
        "decode_steps": eng.decode_count,
        "replans": [(r["step"], r["reason"], r["moves"])
                    for r in eng.controller.replans],
        "batches": [{"step": b["step"], "moved_slots": b["moved_slots"],
                     "layers": len(b["layers"]), "ms": b["ms"]} for b in swaps],
        "swap_ms_median": statistics.median(b["ms"] for b in swaps),
        "swap_bound_ms_median": statistics.median(bound_ms),
        "swap_extra_mib_max": max(b["extra_bytes"] for b in swaps) / 2 ** 20,
        "shed_steps": sum(1 for x in shed_by_step if x > 0),
        "shed_tokens_by_step": shed_by_step,
        "overflow_tokens": sum(sum(o) for o, _, _ in shed_steps),
        "shed_tokens": sum(shed_by_step),
        "dropped_tokens": sum(sum(d) for _, _, d in shed_steps),
        "shed_enable_sets": len({tuple(x) for x in enables}),
        "shed_step_host_ms_median": statistics.median(shed_host) * 1e3,
        "shed_step_host_ms_mean": statistics.fmean(shed_host) * 1e3,
        "decode_step_ms_median": statistics.median(step_ms),
        "serve_decode_step_ms_median_80_slots": serve_ms,
        "replay_profile": replay,
        "wall_s": wall, "peak_mem_gib": peak / 2 ** 30,
        "serve_peak_mem_gib": serve_peak / 2 ** 30,
        "launches": counts, "graph_capture_counts": eng.graph_capture_counts,
        "graph_pool_mib": eng.decode_graph.pool_bytes / 2 ** 20,
        "latency_report": eng.latency_report(),
    })
    main_counts = counts
    del eng, moe, online_step, step, checked_online_step, step_with_enables
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the one-shot run, shed off (its captured step holds no shed
    # operation): GEM's replicated plan lands as one retarget
    eng, _, _ = _replicated_engine(cfg, online=False, shed=False, sums=sums,
                                   install=install)
    events, swaps = [], []
    _timed_decode(eng, events)
    _timed_swaps(eng, swaps)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _drive_shed(eng, cfg.vocab_size, requests=8, new=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    moe = eng.params["blocks"]["moe"]
    check(eng.placement_applied and len(swaps) == 1
          and len(eng.migration_records) == 1,
          f"replicated one-shot: {len(swaps)} retargets")
    (rec,), (swap,) = eng.migration_records, swaps
    linear = ReplicatedPlacement.linear(Ev, SHED_DEVICES,
                                        SHED_REPLICA_SLOTS).slot_to_expert
    check(bool((_live_layout(eng) != linear).any()),
          "replicated one-shot: the retarget left the linear layout")
    _check_rows("replicated retarget", moe, sums, _live_layout(eng), range(L))
    _check_tables("replicated retarget", eng)
    calls = L * (eng.prefill_count + eng.decode_count)
    check(counts["moe_ffn"] == calls and counts["topk_router_stats"] == calls,
          f"replicated one-shot: launches {counts} != {calls}")
    check(eng.graph_capture_counts == one,
          f"replicated one-shot: captures {eng.graph_capture_counts}")
    check(_counters_at_zero(), "replicated one-shot: a K2 arrival counter is not 0")
    check(eng.shed_enables is None and eng.decode_graph.shed_enables is None,
          "replicated one-shot: the shed plane is on")
    emit({
        "phase": "replicated", "run": "one-shot", "replan_step": rec["step"],
        "moves": rec["moves"], "moved_slots": swap["moved_slots"],
        "retarget_ms": swap["ms"],
        "retarget_bound_ms": 2 * swap["moved_slots"] * slot_bytes
        / HBM_BYTES_PER_S * 1e3,
        "retarget_extra_mib": swap["extra_bytes"] / 2 ** 20,
        "install_ms": install[1],
        "decode_steps": eng.decode_count, "prefills": eng.prefill_count,
        "decode_step_ms_median": statistics.median(
            s.elapsed_time(e) for _, s, e in events),
        "shed": False, "replay_profile": _profile_replay(eng),
        "wall_s": wall, "launches": counts,
        "graph_capture_counts": eng.graph_capture_counts,
    })
    close_phase({"phase": "replicated", "ok": True, "slots": S,
                 "rows_equal_layout": True, "tables_equal_replica_tables": True,
                 "batches_checked": checked["batches"],
                 "retargets_checked": 1}, start)
    del eng, moe
    gc.collect()
    torch.cuda.empty_cache()
    return main_counts


# ----------------------------------------------------------------------- swa
def _swa_config(num_layers=SWA_LAYERS):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(MIXTRAL), num_layers=num_layers)
    check(cfg.sliding_window == 4096, "mixtral's published window is 4096")
    return cfg


def _place_in_place(moe, s2e):
    """Permute the stacked expert weights into placement order in place,
    one layer of one weight at a time (a second copy of Mixtral's experts
    would not fit beside the first)."""
    for name in ("w_gate", "w_up", "w_down"):
        w = moe[name]
        for layer in range(w.shape[0]):
            idx = torch.as_tensor(s2e[layer], device=w.device).long()
            w[layer].copy_(w[layer].index_select(0, idx))


def _timed_prefills(eng, seconds):
    """Host seconds of each prefill and its install (synchronised)."""
    inner = eng._write_slot

    def timed(slot, req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(slot, req)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)

    eng._write_slot = timed


def _swa_requests(cfg):
    """8 prompts of 4,064–4,090 tokens (both ends present), 48 new tokens
    each: every row's ring of 4,096 entries wraps during decode."""
    rng = np.random.default_rng(6)
    lo, hi = SWA_PROMPTS
    lengths = [lo, hi, *rng.integers(lo, hi + 1, size=SWA_BATCH - 2)]
    requests = [(rng.integers(0, cfg.vocab_size, size=int(n)), SWA_NEW)
                for n in lengths]
    ring = min(cfg.sliding_window, SWA_MAX_LEN)
    check(all(len(p) <= ring < len(p) + SWA_NEW for p, _ in requests),
          "swa: a prompt does not fit the ring, or a row's ring would not wrap")
    return requests, ring


def phase_swa():
    """Mixtral-8x7B at full width with its 4,096-token window, 16 of 32
    layers, bf16, on the dense KV ring: identity and placed runs in
    ``"scan"``, the placed run again in ``"python"``."""
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig

    start = time.perf_counter()
    cfg = _swa_config()
    L, Ev = cfg.num_layers, cfg.num_virtual_experts
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = {name: w.numel() * w.element_size()
                   for name, w in _leaves(params)}
    emit({"phase": "swa", "config": MIXTRAL, "layers": L,
          "layers_published": 32,
          "cut": "depth 16 of 32: 32 x 2.82 GB of bf16 expert weights do "
                 "not fit 80 GB", "sliding_window": cfg.sliding_window,
          "d_model": cfg.d_model, "expert_d_ff": cfg.expert_d_ff,
          "param_gib": sum(param_bytes.values()) / 2 ** 30, "init_s": init_s,
          "init_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    requests, ring = _swa_requests(cfg)

    def run(tag, e2s, mode, profile=False):
        prefill_s = []
        ecfg = EngineConfig(max_batch=SWA_BATCH, max_len=SWA_MAX_LEN,
                            decode_mode=mode)
        eng, tokens, counts, row = _run_serve(
            tag, params, cfg, ecfg, e2s, requests, SWA_NEW, phase="swa",
            hook=lambda e: _timed_prefills(e, prefill_s))
        check(not eng.paged, "swa: the window must select the dense ring")
        # each ~4k-token prefill (C ~ 1,270) takes K1's wgmma path, each
        # decode step (C = 4) its mma.sync path
        check(counts["moe_ffn_wgmma"] == cfg.num_layers * row["prefills"],
              f"swa {tag}: {counts['moe_ffn_wgmma']} wgmma launches for "
              f"{row['prefills']} prefills of {cfg.num_layers} layers")
        cache_bytes = sum(t.numel() * t.element_size()
                          for _, t in _leaves(eng.caches))
        # the engine's build holds the ring, the graph's pool and the idle
        # warm-up's intermediates (a layer's fp32 ring), never a second ring
        check(row["build_peak_bytes_over_base"] < 1.5 * cache_bytes,
              f"swa {tag}: the build peaked "
              f"{row['build_peak_bytes_over_base']} B over a "
              f"{cache_bytes} B ring")
        row.update(prefill_s=prefill_s, prefill_s_total=sum(prefill_s),
                   prompt_lens=[len(p) for p, _ in requests], ring=ring,
                   cache_gib=cache_bytes / 2 ** 30)
        if profile:
            row["replay_profile"] = _profile_replay(eng, top=12)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return tokens, counts, row, cache_bytes

    identity, _, row, cache_bytes = run("identity", None, "scan")
    emit(row)
    s2e, e2s = _placement(L, Ev, seed=7)
    check(not (s2e == np.arange(Ev)).all(), "swa: identity placement")
    _place_in_place(params["blocks"]["moe"], s2e)
    placed, counts, row, _ = run("placed", e2s, "scan", profile=True)
    # every byte a decode step must read: the weights but the embedding
    # table (a lookup of 8 rows; every expert slot gets rows), and the whole
    # ring of every layer
    step_bytes = (sum(param_bytes.values()) - param_bytes["embed"]
                  + cache_bytes)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    row.update(decode_step_bound_ms=bound_ms, decode_step_bytes=step_bytes,
               bound_share=bound_ms / row["decode_step_ms_median"])
    emit(row)
    check(placed == identity,
          "swa: tokens under the placement differ from identity")
    python, _, py_row, _ = run("placed", e2s, "python")
    emit(py_row)
    check(python == placed, "swa: the eager step's tokens differ from scan's")
    close_phase({"phase": "swa", "ok": True, "placement_invariant": True,
                 "tokens_equal_python": True, "ring_wrapped": True,
                 "decode_step_ms_median": {
                     "scan": row["decode_step_ms_median"],
                     "python": py_row["decode_step_ms_median"]},
                 "decode_step_bound_ms": bound_ms,
                 "decode_only_tokens_per_s": row["decode_only_tokens_per_s"],
                 "graph_pool_bytes": row["graph_pool_bytes"],
                 "prefill_s_total": row["prefill_s_total"],
                 "peak_mem_gib": row["peak_mem_gib"]}, start)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_parity_swa():
    """Mixtral at full width, 2 layers, fp32, window 4,096: one request of
    4,088 prompt tokens and 16 new tokens (the ring wraps at the ninth
    step) on the card and on the CPU, under a placement: equal greedy
    tokens."""
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig

    cfg = _swa_config(num_layers=2)
    params = init_params(cfg, seed=1, device="cuda", dtype=torch.float32)
    s2e, e2s = _placement(cfg.num_layers, cfg.num_virtual_experts, seed=8)
    _place_in_place(params["blocks"]["moe"], s2e)
    rng = np.random.default_rng(9)
    requests = [(rng.integers(0, cfg.vocab_size, size=4088), 16)]
    ecfg = EngineConfig(max_batch=1, max_len=SWA_MAX_LEN)
    torch.set_num_threads(8)
    tokens = {}
    for device in ("cuda", "cpu"):
        p = params if device == "cuda" else _to(params, "cpu")
        eng = _serve(p, cfg, ecfg, device, e2s, requests)
        check(not eng.paged, "parity swa: not the dense ring")
        t0 = time.perf_counter()
        done = eng.run()
        if device == "cuda":
            torch.cuda.synchronize()
        tokens[device] = {r.uid: r.generated for r in done}
        check(len(done) == 1 and len(done[0].generated) == 16,
              f"parity swa {device}: the request did not finish")
        emit({"phase": "parity", "engine": "swa", "device": device,
              "decode_mode": eng.ecfg.decode_mode,
              "seconds": round(time.perf_counter() - t0, 3)})
        del eng, p, done
        gc.collect()
    check(tokens["cuda"] == tokens["cpu"],
          f"parity swa: GPU tokens {tokens['cuda']} != CPU {tokens['cpu']}")
    emit({"phase": "parity", "engine": "swa", "ok": True, "layers": 2,
          "dtype": "float32", "sliding_window": cfg.sliding_window,
          "prompt": 4088, "new_tokens": 16, "ring_wraps_at_step": 9,
          "tokens": tokens["cuda"]})
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ families
def _family_run(cfg, params, mode, device, requests, max_batch, max_len):
    """Serve ``requests`` on a config without MoE layers; returns (tokens,
    decode-step ms list, launches, captures, paged, graph pool bytes,
    SSM state and conv-buffer bytes)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, ServingEngine

    ecfg = EngineConfig(max_batch=max_batch, max_len=max_len, decode_mode=mode)
    eng = ServingEngine(params, cfg, ecfg, device=device)
    check(eng.placements is None and eng.planner is None,
          f"{cfg.name}: a config without MoE layers got a control plane")
    events = []
    if device == "cuda":
        _timed_decode(eng, events)
    for prompt, new in requests:
        eng.submit(prompt, max_new_tokens=new)
    ops.reset_launch_counts()
    eng.run()
    if device == "cuda":
        torch.cuda.synchronize()
    check(len(eng.finished) == len(requests),
          f"{cfg.name} {mode}: not all finished")
    ssm_bytes = sum(t.numel() * t.element_size()
                    for n, t in _leaves(eng.caches) if n.startswith("ssm"))
    out = ({r.uid: r.generated for r in eng.finished},
           [s.elapsed_time(e) for _, s, e in events], ops.launch_counts(),
           eng.graph_capture_counts, eng.paged,
           eng.decode_graph.pool_bytes if eng.decode_graph else None,
           ssm_bytes)
    del eng
    return out


def phase_families():
    """The eight configs without MoE layers: at full width (whole or cut
    depth), bf16, ``"scan"`` against ``"python"``; then at 2 layers (zamba2:
    7, one stage of 6 mamba blocks and the shared block, then one tail
    block), fp32, the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    start = time.perf_counter()
    torch.set_num_threads(8)
    medians = {}
    launches = collections.Counter()  # the full-width card runs' counts
    for name, depth in FAMILIES.items():
        cfg = get_config(name)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        check(not cfg.is_moe, f"{name}: expected a config without MoE layers")
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        rng = np.random.default_rng(10)
        requests = [(rng.integers(0, cfg.vocab_size, size=int(n)), 16)
                    for n in rng.integers(16, 65, size=4)]
        scan = _family_run(cfg, params, "scan", "cuda", requests, 4, 128)
        python = _family_run(cfg, params, "python", "cuda", requests, 4, 128)
        check(scan[0] == python[0], f"families {name}: scan tokens != python's")
        check(scan[3] == {"decode": 1, "prefill": 0, "migrate": 0}
              and python[3]["decode"] == 0,
              f"families {name}: captures {scan[3]} / {python[3]}")
        launches.update(scan[2])
        launches.update(python[2])
        check(not any(scan[2].values()) and not any(python[2].values()),
              f"families {name}: a port kernel launched without MoE layers")
        medians[name] = {"scan": statistics.median(scan[1]),
                         "python": statistics.median(python[1])}
        # a decode step reads every weight once (the embedding table only
        # where it doubles as the LM head) and reads and writes the SSM
        # state and conv buffers; the KV read of these short rows is left
        # out
        weight_bytes = sum(w.numel() * w.element_size()
                           for n, w in _leaves(params)
                           if n != "embed" or cfg.tie_embeddings)
        bound_ms = (weight_bytes + 2 * scan[6]) / HBM_BYTES_PER_S * 1e3
        row = {"phase": "families", "config": name, "family": cfg.family,
               "layers": cfg.num_layers,
               "layers_published": get_config(name).num_layers,
               "d_model": cfg.d_model, "dtype": "bfloat16",
               "kv": "paged" if scan[4] else "dense",
               "requests": len(requests), "new_tokens": 16,
               "tokens_equal_python": True, "graph_capture_counts": scan[3],
               "graph_pool_bytes": scan[5], "launches": scan[2],
               "port_kernels": "none: no MoE layer",
               "decode_step_ms_median": medians[name],
               "decode_step_bound_ms": bound_ms,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del params, scan, python
        gc.collect()
        torch.cuda.empty_cache()

        small = dataclasses.replace(
            get_config(name),
            num_layers=(cfg.attn_every + 1) if cfg.is_hybrid else 2)
        params = init_params(small, seed=1, device="cuda", dtype=torch.float32)
        rng = np.random.default_rng(11)
        requests = [(rng.integers(0, small.vocab_size, size=int(n)), 6)
                    for n in rng.integers(12, 25, size=2)]
        t0 = time.perf_counter()
        card = _family_run(small, params, "scan", "cuda", requests, 2, 64)[0]
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = _family_run(small, _to(params, "cpu"), "python", "cpu",
                          requests, 2, 64)[0]
        cpu_s = time.perf_counter() - t0
        check(card == cpu, f"families {name}: card tokens {card} != CPU {cpu}")
        row.update(parity_layers=small.num_layers, parity_dtype="float32",
                   parity_tokens_equal=True, parity_card_s=card_s,
                   parity_cpu_s=cpu_s)
        emit(row)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    close_phase({"phase": "families", "ok": True, "configs": list(FAMILIES),
                 "decode_step_ms_median": medians}, start)
    return launches


# --------------------------------------------------------------------- train
def _train_grads(params, batch, cfg, e2s, device):
    """The loss, expert counts and gradients (leaf name → tensor on the
    CPU) of one train step's loss on ``device``, remat off."""
    from repro_torch.models import loss_fn

    params = _to(params, device)
    names = [n for n, _ in _leaves(params)]
    flat = dict(_leaves(params))
    for t in flat.values():
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    tables = None if e2s is None else torch.as_tensor(e2s, device=device)
    loss, aux = loss_fn(params, tb, cfg, tables, remat=False)
    grads = torch.autograd.grad(loss, [flat[n] for n in names])
    return (loss.item(), aux["expert_counts"].cpu(),
            {n: g.detach().cpu() for n, g in zip(names, grads)})


def _check_grads(tag, got, want, tol):
    """Each leaf within ``tol`` of that leaf's max |g|; returns the worst
    share."""
    worst = 0.0
    for n, w in want.items():
        scale = w.abs().max().item()
        err = (got[n] - w).abs().max().item()
        check(err <= tol * max(scale, 1e-30),
              f"train {tag}: {n} gradient off by {err} (max |g| {scale})")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def phase_train_parity():
    """Full granite width at 2 layers, fp32 (TF32 off), capacity factor 2.0,
    under a placement: one step's loss, expert counts and gradients on the
    card (K1/K2 and their autograd Functions) against the CPU's (the plain
    versions) from the same weights and batch; then the placed run against
    an identity run on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import placement
    from repro_torch.models import init_params
    from repro_torch.training import DataConfig, SyntheticTokenStream

    torch.set_num_threads(8)
    cfg = dataclasses.replace(get_config(ARCH), num_layers=2,
                              capacity_factor=2.0)
    s2e, e2s = placement(2, cfg.num_virtual_experts, TRAIN_PLACEMENT_SEED)
    base = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    placed = _with_placement(base, s2e)
    batch = next(SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)))
    t0 = time.perf_counter()
    card = _train_grads(placed, batch, cfg, e2s, "cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = _train_grads(placed, batch, cfg, e2s, "cpu")
    cpu_s = time.perf_counter() - t0
    check(torch.equal(card[1], cpu[1]), "train parity: expert counts differ")
    rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    check(rel <= 1e-4, f"train parity: loss {card[0]} vs CPU {cpu[0]}")
    worst = _check_grads("parity", card[2], cpu[2], 1e-3)
    # placement invariance: identity weights and tables on the card; the
    # expert gradients, taken back to virtual order, are the same
    ident = _train_grads(base, batch, cfg, None, "cuda")
    check(torch.equal(ident[1], card[1]),
          "train placement: expert counts differ from the identity run")
    rel_placed = abs(ident[0] - card[0]) / abs(ident[0])
    check(rel_placed <= 1e-4,
          f"train placement: loss {card[0]} vs identity {ident[0]}")
    back = dict(card[2])
    order = torch.as_tensor(e2s).long()
    for n in ("blocks.moe.w_gate", "blocks.moe.w_up", "blocks.moe.w_down"):
        back[n] = torch.take_along_dim(card[2][n], order[:, :, None, None], 1)
    worst_placed = _check_grads("placement", back, ident[2], 1e-3)
    emit({"phase": "train", "check": "card_vs_cpu", "layers": 2,
          "d_model": cfg.d_model, "dtype": "float32", "tokens": TRAIN_BATCH * TRAIN_SEQ,
          "loss_card": card[0], "loss_cpu": cpu[0], "loss_rel_diff": rel,
          "expert_counts_equal": True, "grad_worst_share_of_max": worst,
          "placed_vs_identity_loss_rel_diff": rel_placed,
          "placed_vs_identity_grad_worst_share_of_max": worst_placed,
          "card_s": card_s, "cpu_s": cpu_s})


def phase_train_resume():
    """The launcher at ``--smoke`` on the card with a checkpoint directory:
    20 steps straight against 10 steps, a kill after the step-10
    checkpoint and a restart that runs the other 10. The gather's and the
    embedding's backwards add with atomics, so the losses agree to 1e-4
    relative, not bit for bit."""
    import tempfile

    from repro_torch.launch import train as launch_train

    class Killed(Exception):
        pass

    def kill_at_10(step, metrics):
        if step == 10:
            raise Killed

    argv = ["--smoke", "--steps", "20", "--placement-seed",
            str(TRAIN_PLACEMENT_SEED)]
    straight = launch_train.run(launch_train.parse_args(argv))
    with tempfile.TemporaryDirectory() as d:
        args = launch_train.parse_args(argv + ["--ckpt-dir", d])
        try:
            launch_train.run(args, on_step=kill_at_10)
            check(False, "train resume: the kill did not happen")
        except Killed:
            pass
        resumed = launch_train.run(args)
    check([h["step"] for h in resumed] == list(range(10, 20)),
          "train resume: did not restart at step 10")
    rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
              for a, b in zip(resumed, straight[10:]))
    check(rel <= 1e-4, f"train resume: losses differ by {rel} relative")
    emit({"phase": "train", "check": "resume", "config": "smoke",
          "steps": 20, "restart_at": 10, "loss_max_rel_diff": rel,
          "losses_straight": [h["loss"] for h in straight]})


def _model_tflop_per_s(cfg, tokens: int, step_ms: float) -> float:
    """6 · ``active_param_count()`` · tokens over a train step's time."""
    return 6 * cfg.active_param_count() * tokens / (step_ms / 1e3) / 1e12


def phase_train():
    """Full granite-moe-3b-a800m through the port's training launcher (bf16
    parameters, fp32 moments, seed-0 weights, a seeded placement, 4 × 128
    tokens a step, capacity factor 2.0: C = 205), 20 AdamW steps; then
    the card against the CPU and the resume. Returns the launch counts of
    the full-width run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.dispatch import slot_capacity

    start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(ARCH)
    L, k = cfg.num_layers, cfg.experts_per_token
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_end, marks = [], []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the last step runs under torch.profiler (it is left out of the times)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_step(step, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        step_end.append(ev)
        if step in (TRAIN_STEPS - 2, TRAIN_STEPS - 1):
            torch.cuda.synchronize()
            (prof.start if step == TRAIN_STEPS - 2 else prof.stop)()

    args = launch_train.parse_args([
        "--arch", ARCH, "--steps", str(TRAIN_STEPS), "--seq-len",
        str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--placement-seed",
        str(TRAIN_PLACEMENT_SEED)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    history = launch_train.run(args, on_step=on_step, mark=mark)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in history]
    check(len(history) == TRAIN_STEPS, "train: not every step ran")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in history), "train: a loss or grad norm is not finite")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    for h in history:
        per_layer = h["expert_counts"].sum(axis=1)
        check(h["expert_counts"].shape == (L, cfg.num_experts)
              and bool((per_layer == tokens * k).all()),
              f"train: step {h['step']} expert counts {per_layer}")
    want = L * TRAIN_STEPS  # one forward a layer a step, remat off
    check(counts["moe_ffn"] == want and counts["topk_router_stats"] == want
          and counts["topk_router"] == 0,
          f"train: launches {counts}, expected {want} of K1 and K2, 0 of K3")
    # C = 205: every K1 forward takes the wgmma path
    check(counts["moe_ffn_wgmma"] == want,
          f"train: {counts['moe_ffn_wgmma']} of {want} K1 launches took the "
          "wgmma path")
    # step time: CUDA events at each step's end; the parts from the marks
    # the step records after queueing its forward, backward and update
    timed = range(TRAIN_TIMED_FROM, TRAIN_STEPS - 1)
    steps = [step_end[i - 1].elapsed_time(step_end[i]) for i in timed]
    by_step = [dict() for _ in range(TRAIN_STEPS)]
    i = 0
    for name, ev in marks:
        by_step[i][name] = ev
        if name == "update":
            i += 1
    parts = {"forward": [], "backward": [], "update": []}
    for i in timed:
        ev = by_step[i]
        total = step_end[i - 1].elapsed_time(step_end[i])
        parts["forward"].append(step_end[i - 1].elapsed_time(ev["forward"]) / total)
        parts["backward"].append(ev["forward"].elapsed_time(ev["backward"]) / total)
        parts["update"].append(ev["backward"].elapsed_time(ev["update"]) / total)
    step_ms = statistics.median(steps)
    # the profiled step: device time by kernel, busy against its wall
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:TRAIN_TOP]
    profile_row = {
        "step": TRAIN_STEPS - 1,
        "wall_ms": step_end[-2].elapsed_time(step_end[-1]),
        "device_busy_ms": busy_us / 1e3,
        "device_ops": sum(e.count for e in dev),
        "port_kernels_ms": {
            name: sum(e.self_device_time_total for e in dev if name in e.key) / 1e3
            for name in PORT_KERNELS},
        "top": [{"name": e.key[:90], "calls": e.count,
                 "ms": e.self_device_time_total / 1e3} for e in top]}
    emit({"phase": "train", "config": ARCH, "layers": L, "dtype": "bfloat16",
          "moments": "float32", "steps": TRAIN_STEPS,
          "batch": [TRAIN_BATCH, TRAIN_SEQ],
          "capacity": slot_capacity(tokens, dataclasses.replace(
              cfg, capacity_factor=2.0), capacity_factor=2.0,
              num_slots=cfg.num_virtual_experts, replicated=False),
          "placement_seed": TRAIN_PLACEMENT_SEED, "losses": losses,
          "grad_norms": [h["grad_norm"] for h in history],
          "moe_dropped": [h["moe_dropped"] for h in history],
          "launches": counts, "expert_counts_sum_ok": True,
          "step_ms_median": step_ms, "step_ms": steps,
          "step_ms_timed_from": TRAIN_TIMED_FROM,
          "tokens_per_s": tokens / (step_ms / 1e3),
          # the model's FLOPs a trained token, 6 · N_active: what a user's
          # tokens cost, whatever the port runs to get them
          "active_params": cfg.active_param_count(),
          "model_tflop_per_s": _model_tflop_per_s(cfg, tokens, step_ms),
          "cards": _cards(),
          "share_median": {n: statistics.median(v) for n, v in parts.items()},
          "peak_mem_gib": peak / 2 ** 30, "wall_s": wall,
          "profile": profile_row})
    check(busy_us > 0, "train: the profiled step holds no device time")
    del history
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_parity()
    phase_train_resume()
    close_phase({"phase": "train", "ok": True, "loss_first": losses[0],
                 "loss_last": losses[-1], "step_ms_median": step_ms}, start)
    return counts, step_ms


# -------------------------------------------------------------------- dryrun
# the ``dryrun`` phase: the sweep of every (arch × shape) cell on meta runs
# in worker processes that never touch the card; granite's cells at the
# ``train`` phase's shape and at an 8-row dense decode step are then held
# against the card
DRYRUN_WORKERS = 7
DRYRUN_DECODE_LEN = 4096  # the dense cache's positions a row
DRYRUN_PEAK_TOL = 0.01
_SLOW_FIRST = ("mamba2", "zamba2", "internvl2", "qwen3", "mixtral")
# the sweep's four slowest cells (the SSD scan traced over 4k and 32k
# tokens: 52–122 host seconds each on an H100 machine's host, against at
# most 15 for every other cell) are left to the CPU's
# ``python -m repro_torch.launch.dryrun --all``, to keep the script in its
# time
DRYRUN_HOST_ONLY = (("mamba2-1.3b", "train_4k"), ("mamba2-1.3b", "prefill_32k"),
                    ("zamba2-1.2b", "train_4k"), ("zamba2-1.2b", "prefill_32k"))
# the sweep runs each cell on one card and on rank 0 of JAX's 16×16 mesh
# (2×16×16 is the CPU's: ``python -m repro_torch.launch.dryrun --all
# --mesh 2x16x16``)
DRYRUN_MESHES = ("1xgpu", "16x16")


def _dry_worker_init(src: str) -> None:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # shapes only: no CUDA context
    if src not in sys.path:
        sys.path.insert(0, src)


def _dry_cell(arch: str, shape: str, hbm, mesh: str = "1xgpu") -> dict:
    from repro_torch.launch import dryrun

    return dryrun.run_cell(arch, shape, hbm=hbm, mesh=mesh)


def _dry_sweep(src: Path, hbm) -> tuple[dict, float]:
    """``--all`` on meta but :data:`DRYRUN_HOST_ONLY`, on one card and on
    rank 0 of the 16×16 production mesh (:data:`DRYRUN_MESHES`), the
    cells spread over worker processes (spawned: the parent holds a CUDA
    context); returns the cells by key and the sweep's host seconds."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.configs import ARCHS, SHAPES

    cells = sorted(((a, s) for a in ARCHS for s in SHAPES
                    if (a, s) not in DRYRUN_HOST_ONLY),
                   key=lambda c: (not c[0].startswith(_SLOW_FIRST),
                                  c[1] not in ("train_4k", "prefill_32k")))
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=DRYRUN_WORKERS,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_dry_worker_init, initargs=(str(src),)) as pool:
        futures = {f"{a}|{s}|{m}": pool.submit(_dry_cell, a, s, hbm, m)
                   for m in DRYRUN_MESHES for a, s in cells}
        out = {k: f.result() for k, f in futures.items()}
    return out, time.perf_counter() - t0


def _outside_bytes() -> int:
    """What the card holds before a cell's inputs are made (what earlier
    phases left allocated: cuBLAS workspaces, cached tables, the kernels'
    counters): subtracted from ``max_memory_allocated``, so that the
    measured peak is the cell's own, inputs included, as the dry run
    counts it."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _outside_owners(top: int = 8) -> dict:
    """The CUDA storages that Python objects still reach (``gc``), grouped
    by their tensors' (shape, dtype), largest first: who holds what
    :func:`_outside_bytes` finds before the phase (allocations made in C++
    alone, such as a CUDA graph's pool or cuBLAS's workspace, show only
    in the difference)."""
    import warnings

    seen, groups = set(), collections.Counter()
    with warnings.catch_warnings():  # deprecated aliases warn on isinstance
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            try:
                if not (isinstance(obj, torch.Tensor) and obj.is_cuda):
                    continue
                st = obj.untyped_storage()
            except Exception:  # noqa: BLE001 — a lazy proxy object
                continue
            if st.data_ptr() in seen:
                continue
            seen.add(st.data_ptr())
            groups[f"{tuple(obj.shape)} {obj.dtype}"] += st.nbytes()
    return {"reached_bytes": sum(groups.values()),
            "largest": groups.most_common(top)}


def _tree_nbytes(tree) -> int:
    return sum(t.nelement() * t.element_size() for _, t in _leaves(tree))


def _dry_train_card(cfg, shape, placement) -> dict:
    """One eager train step of ``cfg`` at ``shape`` on the card (remat off,
    AdamW's defaults, the state and batch made first) under ``placement``
    (slot_to_expert, expert_to_slot): the bytes of what the card holds and
    the step's peak (see :func:`_outside_bytes`); the gradients' bytes are
    those of one autograd pass on the card after the step."""
    from repro_torch.models import apply_placement, init_params, loss_fn
    from repro_torch.training import (
        AdamWConfig, init_train_state, make_train_step)

    outside = _outside_bytes()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    s2e, e2s = placement
    params["blocks"]["moe"] = apply_placement(params["blocks"]["moe"], s2e)
    placements = torch.from_numpy(e2s).cuda()
    state = init_train_state(params, AdamWConfig())
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S = shape.global_batch, shape.seq_len
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    held = {"params": _tree_nbytes(state["params"]),
            "moments": _tree_nbytes({"mu": state["opt"]["mu"],
                                     "nu": state["opt"]["nu"]})}
    step = make_train_step(cfg, AdamWConfig(), remat=False)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    _, metrics = step(state, batch, placements)
    e.record()
    torch.cuda.synchronize()
    held.update(peak=torch.cuda.max_memory_allocated() - outside,
                outside=outside, before_step=base - outside,
                step_ms=s.elapsed_time(e), loss=float(metrics["loss"]))
    loss, _ = loss_fn(state["params"], batch, cfg, placements, remat=False)
    grads = torch.autograd.grad(loss,
                                [w for _, w in _leaves(state["params"])])
    held["grads"] = sum(g.nelement() * g.element_size() for g in grads)
    return held


def _dry_decode_card(cfg, shape) -> dict:
    """One eager dense decode step of ``cfg`` at ``shape`` on the card
    (identity placement): the bytes it holds and the step's peak."""
    from repro_torch.models import decode_step, init_decode_cache, init_params
    from repro_torch.models.moe import identity_placement

    outside = _outside_bytes()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    caches = init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                               device="cuda")
    placements = identity_placement(cfg, cfg.num_layers, device="cuda")
    tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32,
                         device="cuda")
    cur_len = torch.tensor(shape.seq_len // 2, dtype=torch.int32,
                           device="cuda")
    held = {"params": _tree_nbytes(params), "caches": _tree_nbytes(caches)}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.no_grad():
        s.record()
        logits, _, _ = decode_step(params, caches, cur_len, tokens, cfg,
                                   placements)
        e.record()
        torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()), "dryrun: decode logits not finite")
    held.update(peak=torch.cuda.max_memory_allocated() - outside,
                outside=outside, before_step=base - outside,
                step_ms=s.elapsed_time(e))
    return held


# the mesh dry run (``dryrun``'s first part): each gloo run of the ``mesh``
# and ``mesh_train`` phases at its own config, shape and policy, on a
# metadata mesh (``launch/meta_mesh.py``: rank 0 of a grid of ranks that
# do not exist), predicting what a rank holds and the collectives its
# decode step runs. Decode cells: the engines' 8 rows of 128 positions
MESH_DECODE_SHAPE = ("mesh_decode", 128, 8, "decode")
# train cells: the ``mesh_train`` batches
MESH_TRAIN_SHAPE = ("mesh_train", 128, 4, "train")


def _ssm_config(arch, layers):
    """``arch`` (mamba2 or zamba2) at full width, ``layers`` deep."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), num_layers=layers)


def _mesh_prediction_cells() -> dict:
    """tag → (arch, config, ShapeSpec, (data, model), dtype, the policy
    of a mesh): the ``mesh`` and ``mesh_train`` phases' gloo runs."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import policy_for
    from repro_torch.sharding import ShardingPolicy

    decode, train = ShapeSpec(*MESH_DECODE_SHAPE), ShapeSpec(*MESH_TRAIN_SHAPE)

    def plain(mesh):
        return ShardingPolicy(mesh=mesh)

    def fsdp_serve(mesh):
        return policy_for(mesh, step_kind="decode", config=_mesh_config())

    def fsdp_train(mesh):
        return policy_for(mesh, step_kind="train")

    bf16, fp32 = torch.bfloat16, torch.float32
    cells = {
        "granite_1x4": (ARCH, _mesh_config(MESH_PINNED_LAYERS), decode,
                        (1, MESH_MODEL), bf16, plain),
        "granite_2x2": (ARCH, _mesh_config(MESH_PINNED_LAYERS), decode,
                        (2, 2), bf16, plain),
        "granite_fsdp_4x1": (ARCH, _mesh_config(MESH_FSDP_LAYERS), decode,
                             MESH_FSDP_SHAPE, bf16, fsdp_serve),
        "granite_train_fsdp_2x2": (ARCH, _mt_config(MESH_TRAIN_LAYERS),
                                   train, (2, 2), bf16, fsdp_train),
        "mamba2_train_1x4": (MAMBA2, _ssm_config(MAMBA2, MESH_SSM_TRAIN_LAYERS),
                             train, (1, MESH_MODEL), fp32, plain),
        "mamba2_train_fsdp_2x2": (MAMBA2,
                                  _ssm_config(MAMBA2, MESH_SSM_TRAIN_LAYERS),
                                  train, (2, 2), fp32, fsdp_train),
    }
    for tag, arch, layers, shape, dtype in MESH_SSM_RUNS:
        cells[f"{tag}"] = (arch, _ssm_config(arch, layers), decode, shape,
                           getattr(torch, dtype), plain)
    return cells


def mesh_predictions(tags=None) -> dict:
    """The mesh dry run of every :func:`_mesh_prediction_cells` cell, or of
    those in ``tags`` (on meta, in this process): by tag, the bytes a rank
    holds (parameters, moments, caches) and its step's collectives by
    kind, with the cell's host seconds."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.meta_mesh import MetaMesh

    out = {}
    for tag, (arch, cfg, shape, (data, model), dtype, make) in (
            _mesh_prediction_cells().items()):
        if tags is not None and tag not in tags:
            continue
        meta = MetaMesh({"data": data, "model": model})
        cell = run_cell(arch, shape, config=cfg, remat=False, mesh=meta,
                        policy=make(meta), dtype=dtype)
        check(cell["status"] == "ok", f"dryrun mesh {tag}: {cell}")
        mem = cell["memory"]
        out[tag] = {"shape": [data, model], "layers": cfg.num_layers,
                    "dtype": str(dtype).replace("torch.", ""),
                    "params_bytes": mem["params_bytes"],
                    "moments_bytes": mem["moments_bytes"],
                    "caches_bytes": mem["caches_bytes"],
                    "collectives": cell["collectives"],
                    "policy": cell["policy"], "host_s": cell["host_s"]}
    return out


def _check_granite_predictions(pred) -> None:
    """The granite cells' predictions against the bytes and collective
    counts the ``mesh`` and ``mesh_train`` phases have always held."""
    for tag, shape, layers in (("granite_1x4", (1, MESH_MODEL),
                                MESH_PINNED_LAYERS),
                               ("granite_2x2", (2, 2), MESH_PINNED_LAYERS),
                               ("granite_fsdp_4x1", MESH_FSDP_SHAPE,
                                MESH_FSDP_LAYERS)):
        want = (sum(MESH_FSDP_PARAM_BYTES.values()) if "fsdp" in tag
                else sum(MESH_PARAM_BYTES[shape].values()))
        per_layer, per_step = MESH_COLLECTIVES[shape]
        got = pred[tag]
        check(got["params_bytes"] == want,
              f"dryrun mesh {tag}: {got['params_bytes']} parameter bytes "
              f"predicted, the ranks hold {want}")
        check(got["collectives"]["total_count"] == per_layer * layers
              + per_step,
              f"dryrun mesh {tag}: {got['collectives']['counts']} a step, "
              f"not {per_layer} a layer and {per_step}")
    got = pred["granite_train_fsdp_2x2"]
    check((got["params_bytes"], got["moments_bytes"]) == MESH_TRAIN_FSDP_BYTES,
          f"dryrun mesh granite_train_fsdp_2x2: {got}")


def phase_dryrun(src: Path, train_step_ms: float):
    """The meta-device dry run: ``--all`` (every cell ``ok`` or ``skipped``),
    then granite's train cell at the ``train`` phase's shape (4 × 128,
    remat off, capacity factor 2.0) and a dense decode cell of 8 rows,
    each against one eager step on the card: parameter, gradient, moment
    and cache bytes equal (the gradients' from one more autograd pass),
    the peak within ±1 %. First the mesh dry run of the ``mesh`` and
    ``mesh_train`` phases' gloo runs (:func:`mesh_predictions`), granite's
    held to the bytes and collectives those phases hold. Returns the
    launch counts of the card steps and the mesh predictions."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    outside = _outside_bytes()
    emit({"phase": "dryrun", "held_before_phase_bytes": outside,
          "held_by_python": _outside_owners()})
    pred = mesh_predictions()
    _check_granite_predictions(pred)
    emit({"phase": "dryrun", "mesh_predictions": pred,
          "seconds": time.perf_counter() - t0})
    props = torch.cuda.get_device_properties(0)
    hbm = (int(props.total_memory), f"cuda:0 total_memory ({props.name})")
    cells, sweep_s = _dry_sweep(src, hbm)
    for key, cell in cells.items():
        print(dryrun.cell_line(key, cell), flush=True)
    status = collections.Counter(c["status"] for c in cells.values())
    check(status["error"] == 0,
          f"dryrun: cells in error: "
          f"{[k for k, c in cells.items() if c['status'] == 'error']}")
    n = len(DRYRUN_MESHES)
    check(status == {"ok": n * (33 - len(DRYRUN_HOST_ONLY)), "skipped": n * 7},
          f"dryrun: statuses {status}")
    fits = sorted(k for k, c in cells.items()
                  if c["status"] == "ok" and c["fits_hbm"])
    emit({"phase": "dryrun", "sweep": "all", "device": "meta",
          "cells": len(cells), "statuses": dict(status),
          "sweep_host_s": sweep_s, "workers": DRYRUN_WORKERS,
          "left_to_the_cpu_sweep": ["|".join(c) for c in DRYRUN_HOST_ONLY],
          "cell_host_s_max": max(c.get("host_s", 0.0) for c in cells.values()),
          "fits_hbm": fits, "hbm_bytes": hbm[0]})

    base = get_config(ARCH)
    train_cfg = dataclasses.replace(base, capacity_factor=2.0)
    train_shape = ShapeSpec("train_card", TRAIN_SEQ, TRAIN_BATCH, "train")
    decode_shape = ShapeSpec("decode_card", DRYRUN_DECODE_LEN, 8, "decode")
    rows = {}
    ops.reset_launch_counts()
    for tag, cfg, shape in (("train", train_cfg, train_shape),
                            ("decode", base, decode_shape)):
        cell = dryrun.run_cell(ARCH, shape, config=cfg, remat=False, hbm=hbm)
        check(cell["status"] == "ok", f"dryrun {tag}: {cell}")
        mem = cell["memory"]
        if tag == "train":
            card = _dry_train_card(cfg, shape, launch_train.placement(
                cfg.num_layers, cfg.num_virtual_experts,
                TRAIN_PLACEMENT_SEED))
            pairs = {"params": mem["params_bytes"], "grads": mem["grads_bytes"],
                     "moments": mem["moments_bytes"]}
        else:
            card = _dry_decode_card(cfg, shape)
            pairs = {"params": mem["params_bytes"],
                     "caches": mem["caches_bytes"]}
        for name, predicted in pairs.items():
            check(predicted == card[name],
                  f"dryrun {tag}: {name} {predicted} B predicted, "
                  f"{card[name]} B on the card")
        err = mem["peak_bytes"] / card["peak"] - 1.0
        check(abs(err) <= DRYRUN_PEAK_TOL,
              f"dryrun {tag}: peak {mem['peak_bytes']} B predicted, "
              f"{card['peak']} B measured ({err:+.3%})")
        rows[tag] = {"shape": dataclasses.asdict(shape),
                     "predicted": mem, "card": card, "peak_rel_err": err,
                     "flops": cell["cost"]["flops"],
                     "bytes": cell["cost"]["bytes"],
                     "ops": cell["cost"]["ops"], "host_s": cell["host_s"]}
        gc.collect()
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    # the train step's forward, the gradient pass's forward, a decode step
    calls = base.num_layers * 3
    check(counts["moe_ffn"] == calls and counts["topk_router_stats"] == calls,
          f"dryrun: launches {counts}, expected {calls} of K1 and K2")
    flops = rows["train"]["flops"]
    emit({"phase": "dryrun", "config": ARCH, "cells": rows,
          "train_flops": flops, "train_step_ms_median": train_step_ms,
          "train_tflop_per_s": flops / (train_step_ms / 1e3) / 1e12,
          "model_tflop_per_s": _model_tflop_per_s(
              train_cfg, TRAIN_BATCH * TRAIN_SEQ, train_step_ms),
          "cards": _cards(), "launches": counts})
    # what the card still holds, then without cuBLAS's workspaces (one for
    # each stream cuBLAS has run on, kept until cleared)
    held = _outside_bytes()
    torch._C._cuda_clearCublasWorkspaces()
    emit({"phase": "dryrun", "held_after_phase_bytes": held,
          "held_without_cublas_workspaces_bytes": _outside_bytes()})
    close_phase({"phase": "dryrun", "ok": True, "bytes_equal": True,
                 "peak_within": DRYRUN_PEAK_TOL}, t0)
    return counts, pred


# ------------------------------------------------------------------ examples
def _run_example(name: str, argv: list[str]):
    """``examples/<name>`` in this process on the card (runpy), its
    standard output captured and echoed; returns (its globals, its
    lines)."""
    import io
    import runpy

    path = ROOT / "examples" / name
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [str(path), *argv]
    try:
        with contextlib.redirect_stdout(buf):
            out = runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = old
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  {name}: {line}", flush=True)
    return out, lines


def phase_examples():
    """``torch_quickstart.py`` and ``torch_serve_moe.py --requests 4`` on the
    card: the data plane's Δ under the GEM placement is 0, every request
    is served, and K1/K2 launched."""
    import tempfile

    from repro_torch.kernels import ops

    start = time.perf_counter()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        cwd = Path.cwd()
        os.chdir(d)  # the quickstart writes its Chrome trace here
        try:
            qs, qs_lines = _run_example("torch_quickstart.py", [])
        finally:
            os.chdir(cwd)
    qs_s = time.perf_counter() - t0
    check(qs["device"].type == "cuda", "examples: the quickstart left the card")
    check(qs["delta"] == 0.0,
          f"examples: data plane Δ {qs['delta']} under the GEM placement")
    check(len(qs["done"]) == 8 and all(len(r.generated) > 0 for r in qs["done"]),
          "examples: the quickstart did not serve every request")
    qs_counts = ops.launch_counts()
    t0 = time.perf_counter()
    _, sv_lines = _run_example("torch_serve_moe.py", ["--requests", "4"])
    sv_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(any(x.startswith("served 4 requests in ") for x in sv_lines),
          "examples: torch_serve_moe.py did not serve 4 requests")
    check(qs_counts["moe_ffn"] > 0 and qs_counts["topk_router_stats"] > 0,
          f"examples: the quickstart launched {qs_counts}")
    check(counts["moe_ffn"] > qs_counts["moe_ffn"]
          and counts["topk_router_stats"] > qs_counts["topk_router_stats"],
          f"examples: torch_serve_moe.py launched nothing: {counts}")
    check(_counters_at_zero(), "examples: a K2 arrival counter is not 0")
    emit({"phase": "examples", "quickstart": qs_lines[-4:],
          "quickstart_s": qs_s, "quickstart_launches": qs_counts,
          "serve_moe": sv_lines[:3], "serve_moe_s": sv_s,
          "launches": counts, "data_plane_delta": qs["delta"]})
    close_phase({"phase": "examples", "ok": True}, start)
    return counts


# ---------------------------------------------------------------- collective
COLLECTIVE_LAYERS = 4


def _collective_engine(cfg, via):
    """The port's launcher's one-shot GEM engine (seed-0 weights, the
    emulated 4-device fleet at high variability, 8 requests of 32 new
    tokens) with ``migration_via=via``."""
    from repro_torch.core import GEMConfig
    from repro_torch.launch import serve as launcher
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine

    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    eng = ServingEngine(
        params, cfg,
        EngineConfig(max_batch=8, max_len=128,
                     gem=GEMConfig(trace_length=16, num_restarts=10),
                     placement_policy="gem", other_time_per_step=2e-4,
                     migration_via=via),
        profile=launcher.emulated_profile("high", 4), num_devices=4,
        device="cuda",
    )
    rng = np.random.default_rng(0)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, size=int(rng.integers(8, 32))),
                   max_new_tokens=32)
    return eng


def phase_collective():
    """The one-shot replan scenario at full width, 4 layers, under
    ``migration_via="collective"`` and ``"host"``: equal tokens, equal rows
    after the swap, equal migration records saying ``"via": "host"``, and
    K1/K2 launched on every MoE layer call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(ARCH), num_layers=COLLECTIVE_LAYERS,
                              decode_capacity_factor=4.0)
    runs, counts = {}, {}
    for via in ("collective", "host"):
        eng = _collective_engine(cfg, via)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[via] = ops.launch_counts()
        calls = cfg.num_layers * (eng.prefill_count + eng.decode_count)
        check(len(done) == 8 and all(len(r.generated) == 32 for r in done),
              f"collective {via}: not every request finished")
        check(counts[via]["moe_ffn"] == calls
              and counts[via]["topk_router_stats"] == calls,
              f"collective {via}: launches {counts[via]} != {calls}")
        check(eng.placement_applied and len(eng.migration_records) == 1,
              f"collective {via}: records {eng.migration_records}")
        runs[via] = (eng, {r.uid: r.generated for r in done}, wall)
    (coll, coll_tok, coll_s), (host, host_tok, host_s) = (
        runs["collective"], runs["host"])
    check(coll_tok == host_tok, "collective: tokens differ from host")
    check(coll.migration_records == host.migration_records,
          "collective: migration records differ from host")
    check(all(r["via"] == "host" for r in coll.migration_records),
          f"collective: records {coll.migration_records}")
    for name in ("w_gate", "w_up", "w_down"):
        check(same_bits(coll.params["blocks"]["moe"][name],
                        host.params["blocks"]["moe"][name]),
              f"collective: {name} rows differ after the swap")
    check(torch.equal(coll.placements, host.placements),
          "collective: router tables differ")
    s2e = np.stack([p.slot_to_expert() for p in coll.current_placements])
    check(bool((s2e != np.arange(cfg.num_virtual_experts)).any()),
          "collective: the placement is identity")
    check(coll.graph_capture_counts == {"decode": 1, "prefill": 0,
                                        "migrate": 0},
          f"collective: captures {coll.graph_capture_counts}")
    emit({"phase": "collective", "config": ARCH, "layers": cfg.num_layers,
          "records": coll.migration_records, "wall_s": coll_s,
          "host_wall_s": host_s, "launches": counts["collective"],
          "host_launches": counts["host"]})
    close_phase({"phase": "collective", "ok": True, "tokens_equal": True,
                 "rows_equal": True, "records_equal": True}, start)
    return counts["collective"]


# --------------------------------------------------------------------- mesh
# The data plane across ranks under JAX's layout: full granite, bf16,
# served by 4 ranks that share this one card over gloo (NCCL puts no two
# ranks on one GPU), the collectives staged through the host; GEM's
# one-shot replan at step 16 moves rows between ranks. Its times are those
# of 4 processes sharing one card, not of a multi-card fleet.
MESH_MODEL = 4
MESH_REQUESTS, MESH_NEW = 8, 32
# the gloo worlds of ranks this run started, by phase (the ``timing`` line)
GLOO_WORLDS = collections.Counter()
MESH_TIMEOUT_S = 600.0
_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")
# a rank's logits against one process's (fp32 logits of a bf16 model) on
# the same inputs: the row-parallel ``wo`` sums fp32 partials and rounds
# once, the softmax over the sharded cache combines fp32 partials, and the
# projections and the logits are column blocks of one process's products,
# so a layer's output parts from one process's only where an fp32 sum
# lands on the other side of a bf16 rounding boundary; the logits (|logit|
# up to ~4, a bf16 ulp 2^-6 there) move by a few ulps. A wrong layout moves
# them by O(1). bf16 router logits tie, and those few ulps break some ties
# the other way, which sends a token to another expert (a change of O(1)
# to its rows): so the bf16 runs in "python" take one process's router
# logits at every MoE layer (K2 still runs, on them) and one process's
# tokens at every step, and hold their own logits within the tolerance at
# every prefill and decode step.
MESH_LOGITS_TOL = 0.25
# an fp32 run (4 layers, (1, 4)) takes the ties away: no bf16 rounding of
# router logits or products, summation orders part the logits by ~1e-6
# relative, so routing, tables, rows and tokens must equal one process's
# and the logits lie within 1e-3. 4 layers (it was 8) for the script's
# time: its checks hold no byte constant of the depth
MESH_FP32_LAYERS = 4
MESH_FP32_LOGITS_TOL = 1e-3
# the pinned bf16 runs at (1, 4) and (2, 2): granite at full width, 8 of
# its 32 layers (16 until the SSM runs joined the phase: the script's
# time)
MESH_PINNED_LAYERS = 8
# bytes a rank holds at each shape (granite at full width, 8 layers), by
# param_specs: the non-expert leaves (embedding by vocabulary, projections
# over model, norms and router whole) and the expert slots
MESH_PARAM_BYTES = {(1, 4): {"non_expert": 64_048_128,
                             "expert": 377_487_360},
                    (2, 2): {"non_expert": 127_060_992,
                             "expert": 754_974_720}}
MESH_ONE_PROCESS_BYTES = {"non_expert": 253_086_720, "expert": 1_509_949_440}
# the FSDP serve: policy_for(mesh, step_kind="decode", config=<full
# granite>) at (4, 1) (6.14 GB of bf16 parameters a model-axis shard, past
# 6 GB: ZeRO-3 over data, the activations replicated, the KV cache's rows
# over data), served at 2 layers in bf16 (8 until the SSM runs joined the
# phase, 4 until the script's time was cut: its gloo steps stage every
# layer's weights through the host, 2.7 s a step at 4 layers); a rank
# holds a quarter of the projections', the vocabulary's and the expert
# stacks' bytes, the norms and the router whole. Granite's layers are all
# alike, so no code path goes with the depth
MESH_FSDP_LAYERS = 2
MESH_FSDP_SHAPE = (4, 1)
# the FSDP serve runs one device's arithmetic on every row: each layer's
# weights gathered whole (the same values), the batch one dispatch group
# as one process dispatches it, each row's attention over its own cache
# rows: it is held bit for bit to one process, unpinned (logits |Δ| 0;
# every H100 run, over gloo and NCCL, read 0), tokens, routed
# counts, tables and rows equal
MESH_FSDP_LOGITS_TOL = 0.0
MESH_FSDP_PARAM_BYTES = {"non_expert": 44_399_616, "expert": 94_371_840}
# collectives a rank runs a decode step, by layer and once a step: (1, 4)
# the q/k/v gather, the softmax partials' gather, the ``wo`` sum and K1's
# gather a layer, the embedding's sum and the logits' gather a step; (2,
# 2) also K2's statistics and the dispatch counts over data a layer and
# the logits over data a step; FSDP (4, 1) the seven projections' and
# experts' gathers over data, the attention outputs' gather over the
# cache rows and K1's (1-wide) gather a layer, the embedding's gather a
# step
MESH_COLLECTIVES = {(1, 4): (4, 2), (2, 2): (6, 3), (4, 1): (9, 1)}
# the runs the mesh dry run predicts (``dryrun``'s first part)
_GRANITE_PREDICTION = {"1x4": "granite_1x4", "2x2": "granite_2x2",
                       "4x1_fsdp": "granite_fsdp_4x1"}


def _gloo_world(phase: str, store: Path):
    """The ``MESH_MODEL`` gloo ranks that share this card for every gloo
    run of ``phase`` (:class:`~repro_torch.launch.mesh.World`, not yet
    started: each run a fresh mesh of its shape over the same
    processes); the caller starts it and closes it in a ``finally``."""
    from repro_torch.launch.mesh import World

    GLOO_WORLDS[phase] += 1
    return World(MESH_MODEL, backend="gloo", device="cuda",
                 store_dir=store / "world")


def _mesh_engine(params, cfg, policy, nd, mode, device=None,
                 kv_mode="auto"):
    """The ``replan`` scenario's one-shot GEM engine (the emulated fleet
    at high variability over ``nd`` devices, the replan at step 16) with
    ``migration_via="collective"``, and its 8 requests."""
    from repro_torch.core import GEMConfig
    from repro_torch.launch.serve import emulated_profile
    from repro_torch.serving import EngineConfig, ServingEngine

    eng = ServingEngine(
        params, cfg,
        EngineConfig(max_batch=8, max_len=128,
                     gem=GEMConfig(trace_length=16, num_restarts=10),
                     placement_policy="gem", other_time_per_step=2e-4,
                     migration_via="collective", decode_mode=mode,
                     kv_mode=kv_mode),
        policy=policy, profile=emulated_profile("high", nd), num_devices=nd,
        device=device,
    )
    rng = np.random.default_rng(0)
    for _ in range(MESH_REQUESTS):
        eng.submit(rng.integers(0, cfg.vocab_size,
                                size=int(rng.integers(8, 32))),
                   max_new_tokens=MESH_NEW)
    return eng


def _mesh_drive(eng, logits=None, counts=None, force=None):
    """Run the engine with its decode steps timed on the host clock (each
    step synchronised), each step's logits and (L, E) expert counts kept
    on the host when asked. ``force``, one process's logits of every
    step: the engine samples its tokens from those instead of its own.
    Returns (step ms, wall s)."""
    inner, step_ms = eng._decode, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if logits is not None:
            logits.append(out[0].float().cpu())
        if counts is not None:
            counts.append(out[2].expert_counts.cpu().numpy())
        if force is not None:
            out = (force[len(step_ms) - 1].to(out[0].device), *out[1:])
        return out

    eng._decode = timed
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(done) == MESH_REQUESTS
          and all(len(r.generated) == MESH_NEW for r in done),
          "mesh: not every request finished")
    return step_ms, wall


def _param_bytes(params) -> dict:
    moe = params["blocks"]["moe"]
    expert = sum(moe[n].nelement() * moe[n].element_size()
                 for n in _EXPERT_WEIGHTS)
    return {"non_expert": _tree_nbytes(params) - expert, "expert": expert}


class _MeshAt:
    """A stand-in for rank ``rank`` of a (data, model) mesh: the extents
    and positions the port's specs read."""

    def __init__(self, shape, rank):
        self.shape = {"data": shape[0], "model": shape[1]}
        self.axis_names = ("data", "model")
        self.coords = {"data": rank // shape[1], "model": rank % shape[1]}

    def size(self, axis):
        axes = (axis,) if isinstance(axis, str) else axis
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axis):
        axes = (axis,) if isinstance(axis, str) else axis
        return int(np.ravel_multi_index([self.coords[a] for a in axes],
                                        [self.shape[a] for a in axes]))


def _specs_by_name(cfg, shape, fsdp: bool = False) -> dict:
    """``param_specs`` of the config's tree at ``shape`` (with ``fsdp``,
    the ZeRO-3 layout's), by the dotted leaf name :func:`_leaves` gives
    (without a prefix)."""
    from repro_torch.sharding import ShardingPolicy, param_specs

    specs = param_specs(_meta_params(cfg),
                        ShardingPolicy(mesh=_MeshAt(shape, 0), fsdp=fsdp),
                        cfg)
    return dict(_leaves(specs))


def _rank_numels(cfg, shape, fsdp: bool = False) -> dict:
    """The elements of each leaf (by its dotted name) that a rank holds at
    ``shape`` by ``param_specs``: the global leaf's over the extents its
    spec names."""
    specs = _specs_by_name(cfg, shape, fsdp)
    mesh = _MeshAt(shape, 0)
    out = {}
    for name, t in _leaves(_meta_params(cfg)):
        n = t.numel()
        for axes in specs[name] or ():
            if axes is not None:
                n //= mesh.size(axes)
        out[name] = n
    return out


def _spec_of(specs: dict, name: str):
    """A state leaf's parameter spec (``params.``, ``opt.mu.``,
    ``opt.nu.`` name their parameter's); None for a whole leaf."""
    for prefix in ("params.", "opt.mu.", "opt.nu.", "ef_residual."):
        if name.startswith(prefix):
            name = name[len(prefix):]
            break
    spec = specs.get(name)
    return spec if spec and any(a is not None for a in spec) else None


def _rank_block(t, spec, shape, rank):
    """The rank's block of a whole tensor by its spec (a contiguous copy)."""
    from repro_torch.sharding import take_shard

    if spec is None:
        return t
    return take_shard(t, spec, _MeshAt(shape, rank)).contiguous()


def _rank_param_bytes(cfg, shape, fsdp: bool = False, itemsize: int = 2):
    """:func:`_param_bytes` of a rank's leaves at ``shape``, by the specs."""
    out = {"non_expert": 0, "expert": 0}
    for name, n in _rank_numels(cfg, shape, fsdp).items():
        out["expert" if _moe_leaf(name) else "non_expert"] += n * itemsize
    return out


def _shard_mismatches(params, cfg, shape, fsdp: bool = False) -> list:
    """The leaves whose bytes on this rank are not their shard's by
    ``param_specs`` (the global leaf's bytes over its sharded extents)."""
    want = _rank_numels(cfg, shape, fsdp)
    return [(name, t.numel(), want[name]) for name, t in _leaves(params)
            if t.numel() != want[name]]


def _cache_bytes(caches) -> int:
    return sum(t.nelement() * t.element_size() for _, t in _leaves(caches))


def _logits_against(logits, ref) -> dict:
    """A rank's logits (one (B, V) tensor a step) against one process's on
    the same inputs: the largest |Δ| at each step, and each (step, row)
    whose arg max differs, with one process's top-1 margin there (the gap
    between its two largest logits) and that row's largest |Δ|."""
    if len(logits) != len(ref):
        return {"steps_compared": 0, "logits_abs_diff_per_step": [],
                "logits_max_abs_diff": None, "argmax_partings": []}
    deltas, partings = [], []
    for step, (a, b) in enumerate(zip(logits, ref)):
        d = (a - b).abs()
        deltas.append(float(d.max()))
        for row in (a.argmax(-1) != b.argmax(-1)).nonzero()[:, 0].tolist():
            top = b[row].topk(2).values
            partings.append({"step": step, "row": row,
                             "one_process_top1_margin":
                                 float(top[0] - top[1]),
                             "abs_diff": float(d[row].max())})
    return {"steps_compared": len(deltas),
            "logits_abs_diff_per_step": deltas,
            "logits_max_abs_diff": max(deltas, default=None),
            "argmax_partings": partings}


def _pin_calls(record, force=None, data_index: int = 0, *,
               router: bool = True):
    """Wrap the engine's ``prefill`` and (with ``router``; not under a
    captured step) the MoE layers' K2 entry
    (``dispatch.topk_router_sharded``). Each prefill's last-position
    logits and each router call's logits are kept, on the host once the
    wrapping is taken off, in ``record["prefill"]`` and
    ``record["router"]``. With ``force`` (one process's record of the same
    scenario) the router runs on one process's logits of the same call
    (its ``data_index`` group where one process dispatched the batch in
    groups) and the engine takes one process's prefill logits;
    ``record["router_abs_diff"]`` keeps each call's largest |Δ| between
    the rank's own router logits and those. The router's are kept on the
    card until then, so that no call waits for the card. Returns a
    function that takes the wrapping off."""
    import repro_torch.models.dispatch as dispatch
    import repro_torch.serving.engine as engine

    inner, pre = dispatch.topk_router_sharded, engine.prefill
    record.update(router=[], prefill=[], router_abs_diff=[])
    on_card = []

    def routed(logits, k, **kw):
        mine = logits.detach().float()
        record["router"].append(mine.clone())
        if force is None:
            return inner(logits, k, **kw)
        if not on_card:
            on_card.extend(t.to(logits.device) for t in force["router"])
        want = on_card[len(record["router"]) - 1]
        if want.shape != mine.shape and mine.shape[0] == 1:
            want = want[data_index:data_index + 1]
        if want.shape != mine.shape:
            raise ValueError(f"router call {len(record['router'])}: "
                             f"{tuple(mine.shape)} against one process's "
                             f"{tuple(want.shape)}")
        record["router_abs_diff"].append((mine - want).abs().max())
        return inner(want.to(logits.dtype), k, **kw)

    def prefilled(*a, **kw):
        logits, caches = pre(*a, **kw)
        record["prefill"].append(logits.float().cpu())
        if force is not None:
            logits = force["prefill"][len(record["prefill"]) - 1].to(
                logits.device)
        return logits, caches

    engine.prefill = prefilled
    if router:
        dispatch.topk_router_sharded = routed

    def undo():
        dispatch.topk_router_sharded, engine.prefill = inner, pre
        record["router"] = [t.cpu() for t in record["router"]]
        record["router_abs_diff"] = [float(t)
                                     for t in record["router_abs_diff"]]

    return undo


def _mesh_rank(mesh, sc):
    """One rank of a ``mesh`` run: builds its shard of full granite (the
    same seed-0 draws as one process, expert stacks a layer at a time),
    checks the gloo + ``"scan"`` guard when asked, serves the scenario and
    returns what the parent checks: tokens, tables, records, launches and
    K1's shapes, its rows' checksums, staged bytes, step times, and its
    logits at every step and prefill against the one-process run's. With
    ``sc["force"]`` it runs on one process's router logits and tokens
    (:func:`_pin_calls`)."""
    import repro_torch.kernels.sharded as sharded
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import policy_for
    from repro_torch.launch.meta_mesh import record_collectives
    from repro_torch.models import init_params
    from repro_torch.sharding import ShardingPolicy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _mesh_config(sc.get("layers"))
    # the FSDP serve takes the production decode policy of full granite
    policy = (policy_for(mesh, step_kind="decode", config=_mesh_config())
              if sc.get("fsdp") else ShardingPolicy(mesh=mesh))
    params = init_params(cfg, seed=0, device=mesh.device,
                         dtype=getattr(torch, sc.get("dtype", "bfloat16")),
                         policy=policy)
    shape = (mesh.size("data"), mesh.size("model"))
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "backend": mesh.backend, "param_bytes": _param_bytes(params),
           "policy": {"fsdp": policy.fsdp,
                      "batch_axes": list(policy.batch_axes),
                      "cache_batch_axes": (None if policy.cache_batch_axes
                                           is None else
                                           list(policy.cache_batch_axes))},
           "shard_mismatches": _shard_mismatches(params, cfg, shape,
                                                 policy.fsdp)}
    if sc["guard"]:
        try:
            _mesh_engine(params, cfg, policy, sc["nd"], "scan")
            out["guard"] = "no error"
        except ValueError as e:
            out["guard"] = str(e)
        gc.collect()
        torch.cuda.empty_cache()
    shapes = set()
    inner = sharded.moe_ffn

    def recorded(x, wg, wu, wd):
        shapes.add((tuple(x.shape), tuple(wg.shape)))
        return inner(x, wg, wu, wd)

    sharded.moe_ffn = recorded
    ref = torch.load(sc["reference"]) if sc.get("reference") else None
    pinned = {}
    undo = _pin_calls(pinned, ref if sc.get("force") else None,
                      mesh.index("data"), router=sc["mode"] == "python")
    eng = _mesh_engine(params, cfg, policy, sc["nd"], sc["mode"])
    # each top-level collective of a decode step, by JAX's kind names
    log = record_collectives(mesh)
    log.on = False
    log.reset()
    decode = eng._decode

    def counted_step(*a, **kw):
        log.on = True
        try:
            return decode(*a, **kw)
        finally:
            log.on = False

    eng._decode = counted_step
    ops.reset_launch_counts()
    mesh.staged_bytes = 0
    logits, counts_trace = [], []
    step_ms, wall = _mesh_drive(eng, logits, counts_trace,
                                ref["logits"] if sc.get("force") else None)
    sharded.moe_ffn = inner
    undo()
    if ref is not None:
        out.update(_logits_against(logits, ref["logits"]))
        out["prefill"] = _logits_against(pinned["prefill"], ref["prefill"])
        out["router_logits_max_abs_diff"] = max(
            pinned["router_abs_diff"], default=None)
    if sc.get("profile") and eng.decode_graph is not None:
        out["profile"] = _profile_captured(eng)
    staged = mesh.staged_bytes
    moe = eng.params["blocks"]["moe"]
    out.update(
        staged_bytes=staged,
        rows={n: _whole_rows(moe[n], n, policy, cfg)
              for n in _EXPERT_WEIGHTS},
        tokens={r.uid: list(r.generated) for r in eng.finished},
        tables=eng.placements.cpu().numpy(),
        s2e=np.stack([p.slot_to_expert() for p in eng.current_placements]),
        records=eng.migration_records,
        launches=ops.launch_counts(),
        calls=cfg.num_layers * (eng.prefill_count + eng.decode_count),
        prefills=eng.prefill_count, decode_steps=eng.decode_count,
        k1_shapes=sorted(shapes),
        sent_rows=eng._migrate.sent_rows,
        received_rows=eng._migrate.received_rows,
        step_ms=step_ms, wall_s=wall,
        captures=eng.graph_capture_counts,
        counters_at_zero=_counters_at_zero(),
        cache_bytes=_cache_bytes(eng.caches),
        expert_counts=counts_trace,
        collectives=log.stats()["counts"],
        collective_bytes=log.stats()["bytes"],
        # a captured step's replays call no Python: counted in "python"
        collectives_per_step=(None if eng.decode_graph is not None else
                              log.stats()["total_count"]
                              / max(eng.decode_count, 1)),
    )
    return out


def _whole_rows(w, name, policy, cfg):
    """Per-row checksums (:func:`_row_checksums`) of an expert stack's
    rows on this rank; under FSDP each layer's block of ``d_model`` is
    gathered whole over ``data`` first, so that the rows compare with one
    process's."""
    from repro_torch.sharding import fsdp_dim, fsdp_gather_axis

    axis = fsdp_gather_axis(policy)
    if axis is None:
        return _row_checksums(w).numpy()
    dim = fsdp_dim(("blocks", "moe", name), w.dim(),
                   tied=cfg.tie_embeddings) - 1
    out = []
    for layer in range(w.shape[0]):
        whole = torch.cat(list(policy.mesh.all_gather(w[layer], axis)
                               .unbind(0)), dim=dim)
        out.append(_row_checksums(whole[None])[0])
        del whole
    return torch.stack(out).numpy()


def _profile_captured(eng, replays: int = 3) -> dict:
    """torch.profiler over ``replays`` replays of the engine's captured
    decode step (the last step's inputs): the device time a replay of the
    port kernels, the NCCL collectives, the cuBLAS/CUTLASS products and
    the rest, and the ten longest kernels."""
    graph = eng.decode_graph._graph

    def run():
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()

    run()
    # one trace on every rank alike: a retaken trace on one rank would
    # replay NCCL collectives the others never join
    avgs, _, tries = _traced(run, attempts=1)
    return {"replays": replays, "trace_attempts": tries,
            **_device_split(avgs, replays)}


def _device_split(avgs, n: int) -> dict:
    """A trace's device time a run (of ``n`` runs) by kind: the port
    kernels, the NCCL collectives, the cuBLAS/CUTLASS products and the
    rest; the ten longest kernels with their calls a run. Annotations on
    the device's timeline (NCCL's ``nccl:_all_gather_base`` spans its own
    kernel) are not kernels and are left out."""
    from torch.autograd import DeviceType

    dev = [e for e in avgs if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.key.startswith("nccl:")]

    def kind(name):
        low = name.lower()
        if _is_port_kernel(name):
            return "port_kernels"
        if "nccl" in low:
            return "collectives"
        if any(k in low for k in ("gemm", "cutlass", "xmma", "sm90", "matmul")):
            return "products"
        return "other"

    by, calls = collections.Counter(), collections.Counter()
    for e in dev:
        by[kind(e.key)] += e.self_device_time_total / n / 1e3
        calls[kind(e.key)] += e.count / n
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    return {"device_ms_per_step": dict(by),
            "kernels_per_step": dict(calls),
            "busy_ms_per_step": sum(by.values()),
            "top": [{"name": e.key[:80],
                     "ms_per_step": e.self_device_time_total / n / 1e3,
                     "calls_per_step": e.count / n} for e in top[:10]]}


def _mesh_config(layers=None):
    """Granite at ``layers`` deep (None: its whole depth)."""
    from repro_torch.configs import get_config

    cfg = get_config(ARCH)
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)


def _grouped_policy(groups: int):
    """The one-process reference of a (d, m) run's dispatch: a policy
    without a mesh whose data-axis size is d, so that one device
    dispatches the batch in d groups, each with its own capacity."""
    from repro_torch.sharding import ShardingPolicy

    class Grouped(ShardingPolicy):
        @property
        def data_axis_size(self) -> int:
            return groups

    return Grouped(mesh=None)


def _mesh_reference(cfg, nd, groups, store: Path, dtype=torch.bfloat16):
    """The scenario in one process on the card (``"python"``, the dense
    cache the mesh run keeps): tokens, each step's logits, each prefill's
    and each router call's logits (saved for the ranks) and expert counts,
    each slot's row checksums before the run (virtual order) and after the
    swap, and the tables after it."""
    params = _parent_draw(cfg, 0, dtype, experts_by_layer=True)
    eng = _mesh_engine(params, cfg, _grouped_policy(groups), nd, "python",
                       device="cuda", kv_mode="dense")
    moe = eng.params["blocks"]["moe"]
    init_rows = {n: _row_checksums(moe[n]).numpy() for n in _EXPERT_WEIGHTS}
    logits, counts, pinned = [], [], {}
    undo = _pin_calls(pinned)
    step_ms, wall = _mesh_drive(eng, logits, counts)
    undo()
    path = store / f"reference_{groups}_{cfg.num_layers}_{dtype}.pt"
    torch.save({"logits": logits, "prefill": pinned["prefill"],
                "router": pinned["router"],
                "expert_counts": [torch.from_numpy(c) for c in counts]}, path)
    moe = eng.params["blocks"]["moe"]
    ref = {"tokens": {r.uid: list(r.generated) for r in eng.finished},
           "tables": eng.placements.cpu().numpy(),
           "rows": {n: _row_checksums(moe[n]).numpy() for n in _EXPERT_WEIGHTS},
           "init_rows": init_rows, "expert_counts": counts,
           "dtype": str(dtype).replace("torch.", ""),
           "layers": cfg.num_layers,
           "step_ms": step_ms, "wall_s": wall, "path": str(path),
           "param_bytes": _param_bytes(params),
           "cache_bytes": _cache_bytes(eng.caches)}
    del eng, params, moe, logits
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def _check_mesh_run(tag, res, ref, shape, row_bytes, *, mode,
                    param_bytes=None, tol=None):
    """What every rank of a mesh run must hold against the one-process
    reference and the other ranks, by ``mode``:

    * ``"exact"`` (fp32, or the FSDP serve's one-device arithmetic: no
      ties part): tokens, every step's routed counts, tables and rows
      equal one process's, the logits of every decode step and prefill
      within ``tol`` (default ``MESH_FP32_LOGITS_TOL``);
    * ``"pinned"`` (bf16, on one process's router logits and tokens):
      routed counts, tables and rows equal one process's, the logits of
      every decode step and prefill within ``MESH_LOGITS_TOL`` (none may go
      uncompared), and the rank's own arg max may differ from one
      process's token only where one process's top-1 margin lies within
      that row's |Δ|;
    * ``"free"`` (bf16 in ``"scan"``, whose captured step cannot be
      pinned): tokens and logits are printed, not held; the tables and rows
      are held to the rank's own plan (the "exact" run holds this path to
      one process).

    Every mode holds the tables and rows to the rank's own plan, the
    bytes, the cache, the collectives and the launches. ``param_bytes``:
    the bytes a rank must hold, where given. On a 1-wide model axis (the
    FSDP serve at (4, 1)) the pool is not sharded over ranks: the replan's
    swap is each rank's own, recorded as a host gather, and no row
    crosses; the rows are held whole (gathered over ``data``)."""
    from repro_torch.kernels.collective import stats_for_dense_sources

    if mode not in ("exact", "pinned", "free"):
        raise ValueError(f"mode {mode!r}")
    data, model = shape
    first = res[0]
    per = first["rows"]["w_gate"].shape[1]  # the slots a rank stores
    layers, per_step = MESH_COLLECTIVES[shape]
    if tol is None:
        tol = MESH_FP32_LOGITS_TOL if mode == "exact" else MESH_LOGITS_TOL
    for r in res:
        if mode != "free":
            steps, pre = r["steps_compared"], r["prefill"]["steps_compared"]
            worst = max(r["logits_max_abs_diff"] or 0.0,
                        r["prefill"]["logits_max_abs_diff"] or 0.0)
            check(steps == len(ref["expert_counts"]) > 0
                  and pre == r["prefills"] > 0,
                  f"mesh {tag}: rank {r['rank']} compared {steps} decode "
                  f"steps and {pre} prefills with one process's")
            check(worst <= tol,
                  f"mesh {tag}: rank {r['rank']}'s logits part from one "
                  f"process's by {worst} > {tol} on the same inputs")
            check(r["tokens"] == ref["tokens"] and _same_counts(r, ref),
                  f"mesh {tag}: rank {r['rank']}'s tokens or routed counts "
                  f"({_moved_assignments(r, ref)} moved) part from one "
                  "process's")
            partings = r["argmax_partings"] + r["prefill"]["argmax_partings"]
            check(mode == "pinned" or not partings,
                  f"mesh {tag}: rank {r['rank']}'s arg max parts: {partings}")
            # a near-tie of one process's two best logits, inside the
            # rank's deviation on that row, may fall the other way
            check(all(p["one_process_top1_margin"] <= p["abs_diff"]
                      for p in partings),
                  f"mesh {tag}: rank {r['rank']}'s arg max parts where one "
                  f"process's top-1 margin exceeds the deviation: {partings}")
        check((param_bytes is None or r["param_bytes"] == param_bytes)
              and not r["shard_mismatches"],
              f"mesh {tag}: rank {r['rank']} holds {r['param_bytes']} "
              f"({r['shard_mismatches']}), not {param_bytes}")
        check(r["cache_bytes"] * data * model == ref["cache_bytes"],
              f"mesh {tag}: rank {r['rank']}'s cache {r['cache_bytes']} B is "
              f"not 1/{data * model} of one process's {ref['cache_bytes']}")
        L = r["calls"] // (r["prefills"] + r["decode_steps"])
        check(r["collectives_per_step"] in (None, layers * L + per_step),
              f"mesh {tag}: rank {r['rank']} runs {r['collectives']} "
              f"collectives ({r['collectives_per_step']} a step), not "
              f"{layers} a layer and {per_step}")
        # GEM plans from the routed counts; where a rank's counts are one
        # process's, so must its plan be (in "free", a tie of bf16 router
        # logits broken the other way gives the rank a plan of its own,
        # held to its rows)
        same_counts = _same_counts(r, ref)
        s2e = r["s2e"]
        check(np.array_equal(r["tables"], first["tables"])
              and np.array_equal(r["tables"], np.argsort(s2e, axis=1))
              and (not same_counts
                   or np.array_equal(r["tables"], ref["tables"])),
              f"mesh {tag}: rank {r['rank']}'s tables differ (counts equal "
              f"one process's: {same_counts})")
        mr = r["rank"] % model
        layer = np.arange(s2e.shape[0])[:, None]
        for n in _EXPERT_WEIGHTS:
            # slot s holds virtual expert s2e[l, s]: its rows of the draw
            want = ref["init_rows"][n][layer, s2e]
            check(np.array_equal(r["rows"][n],
                                 want[:, mr * per:(mr + 1) * per])
                  and (not same_counts or np.array_equal(
                      r["rows"][n],
                      ref["rows"][n][:, mr * per:(mr + 1) * per])),
                  f"mesh {tag}: rank {r['rank']}'s {n} rows differ from "
                  "the draw's rows of the experts its plan puts there")
        check(r["launches"]["moe_ffn"] == r["calls"]
              and r["launches"]["topk_router_stats"] == r["calls"]
              and r["launches"]["topk_router"] == 0,
              f"mesh {tag}: rank {r['rank']} launches {r['launches']} != "
              f"{r['calls']}")
        # K1 is called once a dispatch group on the rank's slots
        check(r["k1_shapes"] and all(x[0] == per and w[0] == per
                                     for x, w in r["k1_shapes"]),
              f"mesh {tag}: K1 shapes {r['k1_shapes']}")
        check(r["counters_at_zero"], f"mesh {tag}: a K2 counter is not 0")
        check(len(r["records"]) == 1 and r["records"][0]["step"] == 16
              and r["records"][0]["via"] == ("collective" if model > 1
                                             else "host"),
              f"mesh {tag}: records {r['records']}")
    check(bool((first["s2e"] != np.arange(first["s2e"].shape[1])).any()),
          f"mesh {tag}: the placement is identity")
    if model == 1:
        check(all(r["sent_rows"] == r["received_rows"] == 0 for r in res),
              f"mesh {tag}: rows crossed ranks on a 1-wide model axis")
        return 0
    want = stats_for_dense_sources(first["s2e"], model, row_bytes)
    cross = sum(st.cross_rows for _, st in want)
    rec = first["records"][0]
    check(rec["cross_rows"] == cross
          and rec["payload_bytes"] == cross * row_bytes
          and rec["payload_bytes"] == sum(st.payload_bytes for _, st in want),
          f"mesh {tag}: measured {rec} != stats_for_dense_sources {cross}")
    check(sum(r["sent_rows"] for r in res) == data * cross
          and sum(r["received_rows"] for r in res) == data * cross,
          f"mesh {tag}: the exchange shipped "
          f"{sum(r['sent_rows'] for r in res)} rows, not {data} x {cross}")
    return cross


def _same_counts(r, ref) -> bool:
    return len(r["expert_counts"]) == len(ref["expert_counts"]) and all(
        np.array_equal(a, b)
        for a, b in zip(r["expert_counts"], ref["expert_counts"]))


def _moved_assignments(r, ref) -> int:
    """How many routed assignments a rank's run sent to another expert
    than one process's, over its decode steps (half the |Δ| of counts)."""
    return int(sum(np.abs(a.astype(np.int64) - b).sum()
                   for a, b in zip(r["expert_counts"], ref["expert_counts"]))
               // 2)


def _nccl_scan(store: Path, row_bytes, cards):
    """The scenario over NCCL, a card a rank, in ``"scan"``, against one
    process: at (1, 4) under ``ShardingPolicy(mesh)`` and at (4, 1) under
    the FSDP serve's ``policy_for`` decode policy of full granite (the
    weights over data, the activations replicated, the KV cache's rows
    over data). Each in bf16 at full granite (rank 0's captured step
    profiled: the collectives against K1/K2 and the rest) and at
    ``MESH_FP32_LAYERS`` layers in fp32 (``"exact"``). The (1, 4) bf16
    run is ``"free"`` (a captured step cannot be pinned to one process's
    routing); the FSDP bf16 run is one device's arithmetic and is held
    bit for bit (``"exact"`` at ``MESH_FSDP_LOGITS_TOL``). Returns (the
    runs' record, their launches)."""
    from repro_torch.launch.mesh import spawn

    # both shapes dispatch the batch as one group, as these do
    refs = {"bfloat16": _mesh_reference(_mesh_config(), MESH_MODEL, 1, store),
            "float32": _mesh_reference(_mesh_config(MESH_FP32_LAYERS),
                                       MESH_MODEL, 1, store, torch.float32)}
    launches = collections.Counter()
    out = {}
    for tag, shape, dtype in (
            ("1x4_bf16", (1, MESH_MODEL), "bfloat16"),
            ("1x4_fp32", (1, MESH_MODEL), "float32"),
            ("fsdp_bf16", MESH_FSDP_SHAPE, "bfloat16"),
            ("fsdp_fp32", MESH_FSDP_SHAPE, "float32")):
        r0 = refs[dtype]
        fp32 = dtype == "float32"
        fsdp = tag.startswith("fsdp")
        mode = "exact" if fp32 or fsdp else "free"
        tol = MESH_FSDP_LOGITS_TOL if fsdp and not fp32 else None
        sc = {"nd": MESH_MODEL, "mode": "scan", "guard": False,
              "fsdp": fsdp, "reference": r0["path"], "dtype": dtype}
        if fp32:
            sc["layers"] = MESH_FP32_LAYERS
        else:
            sc["profile"] = True
        res = spawn(_mesh_rank, *shape, backend="nccl", device="cuda",
                    store_dir=store / f"nccl_{tag}", args=(sc,),
                    timeout=MESH_TIMEOUT_S)
        emit({"phase": "mesh", "run": f"nccl_scan_{tag}",
              "per_rank": [_mesh_rank_summary(r) for r in res]})
        _check_mesh_run(f"nccl_scan_{tag}", res, r0, shape,
                        row_bytes * (2 if fp32 else 1), mode=mode, tol=tol,
                        param_bytes=(None if fp32 else _rank_param_bytes(
                            _mesh_config(), shape, fsdp)))
        check(all(r["captures"] == {"decode": 1, "prefill": 0, "migrate": 0}
                  for r in res),
              f"mesh nccl scan {tag}: captures {[r['captures'] for r in res]}")
        for r in res:
            launches.update(r["launches"])
        out[tag] = {
            "shape": list(shape), "policy": res[0]["policy"],
            "ranks": len(res), "cards": cards, "dtype": r0["dtype"],
            "layers": r0["layers"], "devices": [r["device"] for r in res],
            "mode": mode, "logits_tol": tol,
            "captures_per_rank": 1, "tokens_equal_one_process": all(
                r["tokens"] == r0["tokens"] for r in res),
            "logits_max_abs_diff": [r["logits_max_abs_diff"] for r in res],
            "argmax_partings": [len(r["argmax_partings"]) for r in res],
            "counts_equal_one_process": [_same_counts(r, r0) for r in res],
            "param_bytes_per_rank": res[0]["param_bytes"],
            "cache_bytes_per_rank": res[0]["cache_bytes"],
            "collectives_per_step": res[0]["collectives_per_step"],
            "staged_bytes_per_rank": [r["staged_bytes"] for r in res],
            "launches_per_rank": [r["launches"] for r in res],
            "decode_step_ms_median_per_rank": [
                statistics.median(r["step_ms"]) for r in res],
            "one_process_decode_step_ms_median":
                statistics.median(r0["step_ms"]),
            "wall_s_per_rank": [r["wall_s"] for r in res]}
        if not fp32:
            check("profile" in res[0]
                  and res[0]["profile"]["device_ms_per_step"].get(
                      "port_kernels", 0) > 0,
                  f"mesh nccl scan {tag}: the captured step's trace holds "
                  "no port kernel")
            out[tag]["rank0_captured_step_profile"] = res[0]["profile"]
        del res
        gc.collect()
    return out, launches


def _mesh_rank_summary(r) -> dict:
    """What a run prints of each rank."""
    out = {k: r.get(k) for k in (
        "rank", "param_bytes", "cache_bytes", "collectives",
        "collectives_per_step", "logits_max_abs_diff", "steps_compared",
        "router_logits_max_abs_diff", "argmax_partings", "staged_bytes")}
    pre = r.get("prefill") or {}
    out["prefill"] = {k: pre.get(k) for k in (
        "steps_compared", "logits_max_abs_diff", "argmax_partings")}
    return out


def phase_mesh(kernel_summary, pred):
    """The expert-parallel data plane across ranks: (1, 4) and (2, 2)
    meshes of one world of gloo ranks on this card in ``"python"``
    against one-process runs, the gloo + ``"scan"`` guard, then the SSM
    and hybrid families (:data:`MESH_SSM_RUNS`), each held to the mesh dry
    run's ``pred`` (:func:`mesh_predictions`), and NCCL ``"scan"`` where 4
    cards exist."""
    import tempfile

    from repro_torch.configs import get_config

    start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(ARCH)
    F = cfg.expert_d_ff // cfg.expert_tp
    row_bytes = 3 * cfg.d_model * F * 2  # one slot's three bf16 rows
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    # every time below stands beside the cards it was taken on
    cards = _cards()
    launches = collections.Counter()
    runs = {}
    world = _gloo_world("mesh", store)
    try:
        # the ranks start while one process runs the first reference
        world.start()
        for tag, shape, nd, dtype in (
                ("1x4", (1, MESH_MODEL), MESH_MODEL, "bfloat16"),
                ("2x2", (2, 2), 2, "bfloat16"),
                ("1x4_fp32", (1, MESH_MODEL), MESH_MODEL, "float32"),
                ("2x2_fp32", (2, 2), 2, "float32"),
                ("4x1_fsdp", MESH_FSDP_SHAPE, MESH_MODEL, "bfloat16")):
            data, model = shape
            fp32 = dtype == "float32"
            fsdp = tag.endswith("fsdp")
            # the FSDP serve is held to one process unpinned, bit for bit
            mode = "exact" if fp32 or fsdp else "pinned"
            tol = MESH_FSDP_LOGITS_TOL if fsdp else None
            layers = (MESH_FP32_LAYERS if fp32 else MESH_FSDP_LAYERS if fsdp
                      else MESH_PINNED_LAYERS)
            run_cfg = _mesh_config(layers)
            # the FSDP serve's activations are replicated: one process
            # dispatches the batch as one group, as every rank does
            groups = 1 if fsdp else data
            t0 = time.perf_counter()
            ref = _mesh_reference(run_cfg, nd, groups, store,
                                  getattr(torch, dtype))
            ref_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = world.run(_mesh_rank, data, model,
                            args=({"nd": nd, "mode": "python",
                                   "guard": tag == "1x4",
                                   "reference": ref["path"],
                                   "force": mode == "pinned",
                                   "fsdp": fsdp, "layers": layers,
                                   "dtype": dtype},),
                            timeout=MESH_TIMEOUT_S)
            run_s = time.perf_counter() - t0
            emit({"phase": "mesh", "run": tag, "mode": mode,
                  "per_rank": [_mesh_rank_summary(r) for r in res],
                  "one_process_param_bytes": ref["param_bytes"],
                  "one_process_cache_bytes": ref["cache_bytes"]})
            cross = _check_mesh_run(
                tag, res, ref, shape,
                row_bytes * (2 if fp32 else 1), mode=mode, tol=tol,
                param_bytes=(None if fp32 else MESH_FSDP_PARAM_BYTES if fsdp
                             else MESH_PARAM_BYTES[shape]))
            Ev = cfg.num_virtual_experts
            for r in res:
                launches.update(r["launches"])
            want = pred.get(_GRANITE_PREDICTION.get(tag))
            check(want is None or all(
                sum(r["param_bytes"].values()) == want["params_bytes"]
                and r["cache_bytes"] == want["caches_bytes"]
                and r["collectives_per_step"]
                == want["collectives"]["total_count"]
                and all(v / r["decode_steps"] == want["collectives"]["counts"][k]
                        for k, v in r["collectives"].items())
                for r in res),
                  f"mesh {tag}: the ranks hold or run other than the mesh "
                  f"dry run predicts: {want}")
            check(fp32 or fsdp
                  or ref["param_bytes"] == MESH_ONE_PROCESS_BYTES,
                  f"mesh {tag}: one process holds {ref['param_bytes']}")
            check(not fsdp or all(
                r["policy"] == {"fsdp": True, "batch_axes": [],
                                "cache_batch_axes": ["data"]} for r in res),
                  f"mesh {tag}: policy_for gave {res[0]['policy']}")
            check(all(x[2] == cfg.d_model and w == (Ev // model, cfg.d_model, F)
                      for r in res for x, w in r["k1_shapes"]),
                  f"mesh {tag}: K1 shapes {res[0]['k1_shapes']}")
            if tag == "1x4":
                check(all("gloo" in r["guard"] for r in res),
                      f"mesh {tag}: gloo + scan did not raise: "
                      f"{[r['guard'] for r in res]}")
            steps = [statistics.median(r["step_ms"]) for r in res]
            runs[tag] = {
                "shape": list(shape), "layers": run_cfg.num_layers,
                "dtype": dtype, "placement_devices": nd, "cards": cards,
                "ranks": len(res), "decode_mode": "python",
                "backend": "gloo", "transport": "4 processes sharing one "
                "card, collectives staged through pinned host buffers",
                "mode": mode,
                "tokens_equal_one_process": all(
                    r["tokens"] == ref["tokens"] for r in res),
                "logits_max_abs_diff": [r["logits_max_abs_diff"] for r in res],
                "prefill_logits_max_abs_diff": [
                    r["prefill"]["logits_max_abs_diff"] for r in res],
                "router_logits_max_abs_diff": [
                    r["router_logits_max_abs_diff"] for r in res],
                "argmax_partings": [len(r["argmax_partings"])
                                    + len(r["prefill"]["argmax_partings"])
                                    for r in res],
                "logits_tol": (tol if tol is not None else
                               MESH_FP32_LOGITS_TOL if fp32
                               else MESH_LOGITS_TOL),
                "param_bytes_per_rank": res[0]["param_bytes"],
                "param_bytes_total_per_rank": sum(
                    res[0]["param_bytes"].values()),
                "cache_bytes_per_rank": res[0]["cache_bytes"],
                "one_process_cache_bytes": ref["cache_bytes"],
                "collectives_per_step": res[0]["collectives_per_step"],
                "collectives_per_step_by_kind": {
                    k: v / res[0]["decode_steps"]
                    for k, v in res[0]["collectives"].items()},
                "tables_equal_all_ranks": True, "rows_equal": True,
                "counts_equal_one_process": [_same_counts(r, ref)
                                             for r in res],
                "tables_equal_one_process": [
                    bool(np.array_equal(r["tables"], ref["tables"]))
                    for r in res],
                "assignments_routed_elsewhere": [
                    _moved_assignments(r, ref) for r in res],
                "record": res[0]["records"][0], "cross_rows": cross,
                "sent_rows": [r["sent_rows"] for r in res],
                "staged_bytes": [r["staged_bytes"] for r in res],
                "launches_per_rank": [r["launches"] for r in res],
                "calls_per_rank": res[0]["calls"],
                "prefills": res[0]["prefills"],
                "decode_steps": res[0]["decode_steps"],
                "k1_shapes": [[list(x), list(w)] for x, w in res[0]["k1_shapes"]],
                "decode_step_ms_median_per_rank": steps,
                "wall_s_per_rank": [r["wall_s"] for r in res],
                "run_s": run_s,
                "one_process_decode_step_ms_median":
                    statistics.median(ref["step_ms"]),
                "one_process_wall_s": ref["wall_s"], "one_process_s": ref_s,
                "policy": res[0]["policy"],
                "one_process_param_bytes": ref["param_bytes"],
            }
            if tag == "1x4":
                runs[tag]["gloo_scan_guard"] = res[0]["guard"]
            emit({"phase": "mesh", "run": tag, **runs[tag]})
            del res
            gc.collect()
        runs["ssm"] = _mesh_ssm(world, store, cards, pred)
        world.close()
        n_cards = torch.cuda.device_count()
        if n_cards >= MESH_MODEL:
            runs["nccl_scan"], counts = _nccl_scan(store, row_bytes, cards)
            launches.update(counts)
            runs["nccl_scan_ssm"] = _nccl_ssm_scan(store, cards)
        else:
            runs["nccl_scan"] = runs["nccl_scan_ssm"] = \
                f"not run: {n_cards} card(s)"
        emit({"phase": "mesh", "nccl_scan": runs["nccl_scan"],
              "nccl_scan_ssm": runs["nccl_scan_ssm"]})
    finally:
        import shutil

        world.close()
        shutil.rmtree(store, ignore_errors=True)
    row = kernel_summary["moe_ffn/decode_rank"]
    close_phase({"phase": "mesh", "ok": True,
                 "k1_per_rank_decode": {k: row[k] for k in (
                     "shape", "ms", "device_us", "plain_ms", "library_ms",
                     "bound_ms", "bound_by", "bound_share")}}, start)
    return dict(launches)


# --------------------------------------------------------------- mesh_train
# Training under the mesh: granite at full width, 4 of 32 layers (8 until
# the script's time was cut; 4 ranks share the card: ~120 M parameters a
# rank at every shape),
# bf16 parameters and fp32 moments, seed-0 weights drawn whole (as one
# process draws them) and placed by the ``train`` phase's seed, the
# ``train`` phase's batches (4 × 128 tokens, C = 205) and optimizer (the
# launcher's: learning rate 1e-3, 10 warm-up steps, a cosine to 20), 5
# steps, remat off; each mesh against one process on the card at the same
# depth, draws and batches (dispatched in 2 groups for (2, 2)).
MESH_TRAIN_LAYERS = 4
MESH_TRAIN_STEPS = 5
MESH_TRAIN_TIMEOUT_S = 900.0
# gates, bf16 parameters. The first step starts from the same weights:
# its loss within 1e-3 relative of one process's, its grad norm within
# 1e-2, its expert counts and dropped share equal, and each gradient leaf
# (the rank's rows, after the reduction over ranks) within 2e-2 of the
# leaf's max |g| (the single-card train tests' bf16 tolerance). The
# second step, after one update (Adam's first is ±lr a weight, its sign
# the gradient's), within 1e-3 and 5e-2. From there the ranks sum in
# other orders than one process (which repeats itself bit for bit on the
# card: the dispatch gather's backward sums in fp32), and
# an update of lr ≈ 1e-4 is about one bf16 step of a weight, so a
# gradient near 0 that takes the other sign parts the runs; they part
# faster as the loss climbs. So the later steps' losses are held within
# 10 % and their grad norms within 30 % (sound mesh runs part from one
# process by up to about a tenth in the norm by step 5 on an H100; a norm
# that missed a sum over ranks would be off by a factor), their counts
# printed; what must hold exactly is
# that the ranks stay replicas: the same metrics on every rank, every
# whole leaf (parameters and moments) bit-equal on every rank and every
# expert shard on the ranks that hold it. Each expert leaf's update over
# the run on the rank's rows, p_5 − p_0, must point as one process's
# does: cosine ≥ 0.9 (sound runs read about 0.97–0.98 on an H100; ranks
# whose replicas parted read 0.84–0.86). Each rank's expert rows after
# the last step must lie within MESH_TRAIN_PARAM_TOL of one process's, as
# max |Δ| over the leaf's max |w|. The bound is Adam's: a step moves a
# weight by lr·m̂/√v̂, and |m̂/√v̂| ≤ 1.003 over the first 5 steps (β 0.9,
# 0.95), so two runs whose updates of a weight disagree part by at most
# 2·Σ lr = 3.0e-3 (lr 1e-4 … 5e-4 in the warm-up) and by a bf16 step or
# two of the weight (2^-10 near its max); the expert leaves' max |w| is
# about 0.15 (N(0, 1/1536) over ~10^8 draws a rank), so 0.020 + 0.013.
# Sound runs read 0.0149–0.0171 on an H100; a row in another slot's
# place reads O(1), a block left without its update about 0.01 and a
# cosine near 0.
MESH_TRAIN_LOSS_RTOL = (1e-3, 1e-3, 0.1)
MESH_TRAIN_NORM_RTOL = (1e-2, 5e-2, 0.3)
MESH_TRAIN_GRAD_TOL = 2e-2
MESH_TRAIN_UPDATE_COS = 0.9
MESH_TRAIN_PARAM_TOL = 0.033
# (bf16 parameter, fp32 moment) bytes a rank holds under FSDP at (2, 2)
# and (4, 1), 4 layers: a quarter of the projections', the vocabulary's
# and the expert stacks' 956,694,528 B, and the router and the norms
# (519,168 B) whole; and at full depth (32 layers, the NCCL run)
MESH_TRAIN_FSDP_BYTES = (239_692_800, 958_771_200)
MESH_TRAIN_FSDP_FULL_BYTES = (1_652_591_616, 6_610_366_464)
# the ``kernels`` phase's rows at the shapes a rank launches: K1 and K2
# at (1, 4) (all 512 tokens, 20 slots) and at (2, 2) (256 tokens, 40)
MESH_TRAIN_KERNEL_ROWS = ("moe_ffn/train_rank", "moe_ffn/train_rank_2x2",
                          "moe_ffn/train_rank_4x1",
                          "topk_router_stats/train",
                          "topk_router_stats/train_rank_2x2",
                          "topk_router_stats/train_rank_4x1")


def _mt_build(cfg, device, policy):
    """The train state of this process's leaves: the seed-0 draw whole,
    placed, and (under a mesh) only the rank's shard of every leaf kept
    (``param_specs``: its expert slots, its blocks of the projections and
    the vocabulary); the train step (remat off), the (L, E_v) tables and
    the batch stream."""
    from repro_torch.launch.train import placement
    from repro_torch.models import apply_placement, init_params
    from repro_torch.sharding import param_specs, take_shard
    from repro_torch.training import (
        AdamWConfig,
        DataConfig,
        SyntheticTokenStream,
        init_train_state,
        make_train_step,
    )

    params = init_params(cfg, seed=0, device=device, dtype=torch.bfloat16)
    s2e, e2s = placement(cfg.num_layers, cfg.num_virtual_experts,
                         TRAIN_PLACEMENT_SEED)
    moe = apply_placement(params["blocks"]["moe"],
                          torch.as_tensor(s2e, device=device))
    params["blocks"]["moe"] = moe
    if policy is not None and policy.mesh is not None:
        specs = param_specs(params, policy, cfg)

        def keep(tree, spec):
            if isinstance(tree, dict):
                return {k: keep(v, spec[k]) for k, v in tree.items()}
            return take_shard(tree, spec, policy.mesh).contiguous()

        params = keep(params, specs)
    gc.collect()
    torch.cuda.empty_cache()
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=10,
                      total_steps=TRAIN_STEPS)
    state = init_train_state(params, opt)
    step = make_train_step(cfg, opt, policy=policy, remat=False)
    data = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    return state, step, torch.as_tensor(e2s, device=device), data


def _mt_run(state, step, tables, data, device, on_grads,
            steps: int = MESH_TRAIN_STEPS):
    """``steps`` steps, each synchronised and timed on the host clock;
    ``on_grads(grads)`` sees the first step's gradients as the update
    gets them (the reduced ones under a mesh). Returns the per-step
    metrics on the host (a MoE config's dropped share and expert counts
    too) and the step times (ms)."""
    import repro_torch.training.train_step as train_step_module

    inner = train_step_module.adamw_update
    seen = []

    def update(params, grads, opt_state, cfg, **kw):
        if not seen:
            seen.append(True)
            on_grads(grads)
        return inner(params, grads, opt_state, cfg, **kw)

    train_step_module.adamw_update = update
    history, step_ms = [], []
    try:
        for _ in range(steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(data).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, tables)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            h = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
            if "moe_dropped" in m:
                h.update(dropped=float(m["moe_dropped"]),
                         expert_counts=m["expert_counts"].cpu().numpy())
            history.append(h)
    finally:
        train_step_module.adamw_update = inner
    return history, step_ms


def _moe_leaf(path: str) -> bool:
    from repro_torch.sharding import is_expert_leaf

    return is_expert_leaf(path.split("."))


def _mt_reference(cfg, groups, store: Path, tensors: bool):
    """One process on the card: the steps, and (``tensors``) the first
    step's gradients and the expert leaves after the last step saved
    under ``store`` for the ranks to hold their rows against."""
    from repro_torch.kernels import ops

    policy = _grouped_policy(groups) if groups > 1 else None
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step, tables, data = _mt_build(cfg, dev, policy)
    grads_path = store / f"train_grads_{groups}.pt"
    final_path = store / f"train_final_{groups}.pt"

    def save_grads(grads):
        if tensors:
            torch.save({n: g.detach().cpu() for n, g in _leaves(grads)},
                       grads_path)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    history, step_ms = _mt_run(state, step, tables, data, dev, save_grads)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if tensors:
        torch.save({n: w.detach().cpu() for n, w in
                    _leaves(state["params"]) if _moe_leaf(n)}, final_path)
    out = {"history": history, "step_ms": step_ms, "wall_s": wall,
           "launches": launches, "grads": str(grads_path),
           "final": str(final_path),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _worst_share(got, ref_path, block, device,
                 scale=None) -> tuple[float, str]:
    """The largest max |Δ| / max |ref| over ``got``'s leaves against the
    saved one-process tensors (``block(name, t)``: the rank's block of
    one; ``scale(name, t)``, default ``block``: the part of it whose max
    |ref| is the scale), and its leaf."""
    ref = torch.load(ref_path, mmap=True, map_location="cpu")
    worst, at = 0.0, ""
    for name, g in got:
        want = block(name, ref[name]).to(device, torch.float32)
        top = (scale or block)(name, ref[name]).float().abs().max()
        share = ((g.detach().float() - want).abs().max()
                 / top.to(device).clamp(min=1e-30)).item()
        if share > worst:
            worst, at = share, name
        del want
    return worst, at


def _update_cosine(moved, start, ref_path, block) -> tuple[float, str]:
    """The least cosine, over the expert leaves, between this rank's
    update of its rows over the run and one process's update of them
    (``block(name, t)``: the rank's block of one process's leaf)."""
    ref = torch.load(ref_path, mmap=True, map_location="cpu")
    worst, at = 1.0, ""
    for name, w in moved:
        p0 = start[name].float()
        want = block(name, ref[name]).to(w.device).float() - p0
        got = w.detach().float() - p0
        cos = (torch.sum(got * want) / (got.norm() * want.norm()).clamp(
            min=1e-30)).item()
        if cos < worst:
            worst, at = cos, name
        del p0, want, got
    return worst, at


def _shard_sums(state) -> dict:
    """Checksums of a state's leaves: per (layer, slot) rows for the
    expert stacks of the parameters and moments, one a leaf otherwise."""
    out = {}
    for name, t in _leaves(state):
        if _moe_leaf(name):
            out[name] = _row_checksums(t).numpy()
        else:
            out[name] = _checksum({"x": t.reshape(-1)})
    return out


def _mt_rank(mesh, sc):
    """One rank of a ``mesh_train`` run: its leaves of the placed seed-0
    draw, 5 steps through the port's train step under the mesh, and what
    the parent checks (metrics, bytes, launches, K1's shapes, staged
    bytes, the first step's gradient and the last step's expert rows
    against the one-process run's, and after a save from the mesh the
    checksums of its shards)."""
    import repro_torch.kernels.sharded as sharded
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import policy_for
    from repro_torch.sharding import ShardingPolicy, local_expert_slots
    from repro_torch.training import train_state_specs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _mt_config(sc["layers"])
    # the production policy (ZeRO-3 over data) where asked
    policy = (policy_for(mesh, step_kind="train") if sc.get("fsdp")
              else ShardingPolicy(mesh=mesh))
    dev = mesh.device
    state, step, tables, data = _mt_build(cfg, dev, policy)
    Ev = cfg.num_virtual_experts
    rows = local_expert_slots(policy, Ev)
    lo, hi = (rows.start, rows.stop) if rows is not None else (0, Ev)
    shape = (mesh.size("data"), mesh.size("model"))
    specs = _specs_by_name(cfg, shape, policy.fsdp)

    def block(name, t):
        return _rank_block(t, _spec_of(specs, name), shape, mesh.rank)

    def scale(name, t):
        # a ZeRO block is held to its leaf's scale as the rank held the
        # leaf before FSDP: whole over data
        spec = _spec_of(specs, name)
        if spec is not None:
            spec = tuple(None if a == "data" else a for a in spec)
        return _rank_block(t, spec, shape, mesh.rank)
    opt = state["opt"]
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend,
           "fsdp": policy.fsdp,
           "param_bytes": _tree_nbytes(state["params"]),
           "moment_bytes": _tree_nbytes(opt["mu"]) + _tree_nbytes(opt["nu"]),
           "slots": [lo, hi]}
    if sc.get("restore"):
        # another mesh's save, restored onto this rank's blocks
        t0 = time.perf_counter()
        restored, _, at = CheckpointManager(sc["restore"]).restore_sharded(
            state, train_state_specs(state, policy, cfg, num_slots=Ev),
            mesh=mesh)
        out.update(restored_step=at, restored_sums=_shard_sums(restored),
                   restore_sharded_s=time.perf_counter() - t0)
        del restored
        gc.collect()
        torch.cuda.empty_cache()
    shapes = set()
    inner = sharded.moe_ffn

    def recorded(x, wg, wu, wd):
        shapes.add((tuple(x.shape), tuple(wg.shape)))
        return inner(x, wg, wu, wd)

    def check_grads(grads):
        if sc["tensors"]:
            out["grad_share"] = _worst_share(_leaves(grads), sc["grads"],
                                             block, dev, scale)

    start = {n: w.detach().clone() for n, w in _leaves(state["params"])
             if _moe_leaf(n)} if sc["tensors"] else None

    sharded.moe_ffn = recorded
    ops.reset_launch_counts()
    mesh.staged_bytes = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        history, step_ms = _mt_run(state, step, tables, data, dev,
                                   check_grads)
    finally:
        sharded.moe_ffn = inner
    out.update(history=history, step_ms=step_ms,
               wall_s=time.perf_counter() - t0,
               launches=ops.launch_counts(), k1_shapes=sorted(shapes),
               staged_bytes=mesh.staged_bytes,
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    moved = [(n, w) for n, w in _leaves(state["params"]) if _moe_leaf(n)]
    if sc["tensors"]:
        out["param_share"] = _worst_share(moved, sc["final"], block, dev,
                                          scale)
        out["update_cos"] = _update_cosine(moved, start, sc["final"], block)
        del start
    out["sums"] = {n: _checksum({"x": t.reshape(-1)})
                   for n, t in _leaves(state) if n != "opt.step"}
    if sc.get("save"):
        t0 = time.perf_counter()
        CheckpointManager(sc["save"]).save(
            MESH_TRAIN_STEPS, state, mesh=mesh,
            shardings=train_state_specs(state, policy, cfg, num_slots=Ev))
        out["save_s"] = time.perf_counter() - t0
        out["shard_sums"] = _shard_sums(state)
    if sc.get("profile"):
        # one more step, traced on every rank alike (its collectives
        # pair across the ranks), after everything above has been read
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(data).items()}

        def one_step():
            step(state, batch, tables)
            torch.cuda.synchronize()

        avgs, _, tries = _traced(one_step, attempts=1)
        out["profile"] = {"trace_attempts": tries, **_device_split(avgs, 1)}
    return out


def _mt_config(layers):
    """Granite at capacity factor 2.0 (the launcher's), ``layers`` deep
    (None: its whole depth)."""
    from repro_torch.configs import get_config

    cfg = get_config(ARCH)
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                               capacity_factor=2.0)


def _check_mt_run(tag, res, ref, shape, cfg, fsdp: bool = False):
    """What every rank of a ``mesh_train`` run must hold against its
    one-process reference (its expert rows after the last step within
    ``MESH_TRAIN_PARAM_TOL`` of the reference's where the ranks measured
    them).
    With ``fsdp`` the ranks hold ZeRO-3 blocks: a leaf stored over
    ``data`` is every rank's own, no replica of another's."""
    from repro_torch.models.dispatch import slot_capacity

    data, model = shape
    L, Ev = cfg.num_layers, cfg.num_virtual_experts
    F = cfg.expert_d_ff // cfg.expert_tp
    specs = _specs_by_name(cfg, shape, fsdp)
    # a rank's parameters: each leaf over its sharded extents
    n_params = sum(_rank_numels(cfg, shape, fsdp).values())
    per = Ev // model
    C = slot_capacity(TRAIN_BATCH * TRAIN_SEQ // data, cfg,
                      capacity_factor=2.0, num_slots=Ev, replicated=False)
    for r in res:
        hist = r["history"]
        check(len(hist) == MESH_TRAIN_STEPS,
              f"mesh_train {tag}: rank {r['rank']} ran {len(hist)} steps")
        for i, (h, w) in enumerate(zip(hist, ref["history"])):
            j = min(i, 2)
            check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                  and abs(h["loss"] - w["loss"])
                  <= MESH_TRAIN_LOSS_RTOL[j] * abs(w["loss"]),
                  f"mesh_train {tag}: rank {r['rank']} step {i} loss "
                  f"{h['loss']} vs one process {w['loss']}")
            check(MESH_TRAIN_NORM_RTOL[j] is None
                  or abs(h["grad_norm"] - w["grad_norm"])
                  <= MESH_TRAIN_NORM_RTOL[j] * abs(w["grad_norm"]),
                  f"mesh_train {tag}: rank {r['rank']} step {i} grad norm "
                  f"{h['grad_norm']} vs one process {w['grad_norm']}")
            check(i > 0 or (np.array_equal(h["expert_counts"],
                                           w["expert_counts"])
                            and h["dropped"] == w["dropped"]),
                  f"mesh_train {tag}: rank {r['rank']} step 0 expert counts "
                  f"or dropped share {h['dropped']} differ from one "
                  f"process's ({w['dropped']})")
        # every rank reports the same global metrics
        check([(h["loss"], h["grad_norm"]) for h in hist]
              == [(h["loss"], h["grad_norm"]) for h in res[0]["history"]],
              f"mesh_train {tag}: ranks report different metrics")
        if "grad_share" in r:
            check(r["grad_share"][0] <= MESH_TRAIN_GRAD_TOL,
                  f"mesh_train {tag}: rank {r['rank']} gradient "
                  f"{r['grad_share']} off the one-process rows")
            check(r["update_cos"][0] >= MESH_TRAIN_UPDATE_COS,
                  f"mesh_train {tag}: rank {r['rank']} expert update "
                  f"{r['update_cos']} does not follow one process's")
            check(r["param_share"][0] <= MESH_TRAIN_PARAM_TOL,
                  f"mesh_train {tag}: rank {r['rank']} expert rows after "
                  f"the last step {r['param_share']} off one process's "
                  f"(limit {MESH_TRAIN_PARAM_TOL})")
        check(r["fsdp"] == fsdp,
              f"mesh_train {tag}: rank {r['rank']} fsdp={r['fsdp']}")
        # the ranks are replicas: whole leaves on all, shards on the ranks
        # of the same model position (a ZeRO block is the rank's alone)
        for name, v in r["sums"].items():
            spec = _spec_of(specs, name)
            if data > 1 and spec and "data" in spec:
                continue
            twin = next(q for q in res
                        if q["rank"] % model == r["rank"] % model)
            first = twin if spec else res[0]
            check(v == first["sums"][name],
                  f"mesh_train {tag}: rank {r['rank']}'s {name} differs "
                  f"from rank {first['rank']}'s")
        check(r["param_bytes"] == 2 * n_params
              and r["moment_bytes"] == 2 * 4 * n_params,
              f"mesh_train {tag}: rank {r['rank']} holds {r['param_bytes']} "
              f"parameter and {r['moment_bytes']} moment bytes, not those "
              f"of {n_params} parameters")
        want = L * MESH_TRAIN_STEPS
        check(r["launches"]["moe_ffn"] == want
              and r["launches"]["topk_router_stats"] == want
              and r["launches"]["topk_router"] == 0,
              f"mesh_train {tag}: rank {r['rank']} launches {r['launches']}"
              f" != {want} of K1 and K2")
        check(r["k1_shapes"] == [((per, C, cfg.d_model),
                                  (per, cfg.d_model, F))],
              f"mesh_train {tag}: K1 shapes {r['k1_shapes']}")


def _restored_state(root):
    """One process's restore of a ``mesh_train`` save (the CPU, global
    shapes, JAX's dtypes), on the card, with its checks and load time."""
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(root))
    check(mgr.committed_steps() == [MESH_TRAIN_STEPS],
          f"mesh_train save: steps {mgr.committed_steps()}")
    manifest = json.loads((Path(root) / f"step_{MESH_TRAIN_STEPS:08d}"
                           / "manifest.json").read_text())
    dtypes = {k: v["dtype"] for k, v in manifest["paths"].items()}
    check(all(v == ("bfloat16" if k.startswith("params/") else
                    "int32" if k == "opt/step" else "float32")
              for k, v in dtypes.items()),
          f"mesh_train save: dtypes {dtypes}")
    # a skeleton without tensors: every leaf comes back on the CPU
    skeleton = {}
    for k in dtypes:
        node = skeleton
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = True
    t0 = time.perf_counter()
    state, _, step = mgr.restore(skeleton)
    load_s = time.perf_counter() - t0
    check(step == MESH_TRAIN_STEPS and int(state["opt"]["step"]) == step,
          f"mesh_train save: step {step}")
    return _to(state, "cuda"), len(dtypes), load_s


def _check_blocks(tag, state, ranks_sums, cfg, shape, fsdp):
    """Each rank's checksums (``ranks_sums``: (rank, its
    :func:`_shard_sums`)) against its block of the whole ``state`` by the
    specs at ``shape``: per row for the expert stacks, one a leaf
    otherwise."""
    specs = _specs_by_name(cfg, shape, fsdp)
    whole = dict(_leaves(state))
    for rank, sums in ranks_sums:
        for k, v in sums.items():
            spec = _spec_of(specs, k)
            t = whole[k] if spec is None else _rank_block(whole[k], spec,
                                                          shape, rank)
            want = (_row_checksums(t).numpy() if isinstance(v, np.ndarray)
                    else _checksum({"x": t.reshape(-1)}))
            check(np.array_equal(v, want),
                  f"mesh_train {tag}: rank {rank}'s {k} differs from its "
                  "block of the restored leaf")


def _check_mesh_save(root, res, cfg, shape, fsdp, restored=None):
    """The save from ``shape`` restores on one process, each of its
    ranks' shards has the checksums of its block of the restored leaves,
    and (``restored``: (the other shape, its ranks' results)) so do the
    blocks that ``restore_sharded`` gave the ranks of another mesh."""
    state, leaves, load_s = _restored_state(root)
    _check_blocks("save", state, [(r["rank"], r["shard_sums"]) for r in res],
                  cfg, shape, fsdp)
    out = {"leaves": leaves, "bytes": _tree_nbytes(state),
           "restore_s": load_s}
    if restored is not None:
        other, ranks = restored
        check(all(r["restored_step"] == MESH_TRAIN_STEPS for r in ranks),
              "mesh_train restore_sharded: step")
        _check_blocks(f"restore_sharded {other}", state,
                      [(r["rank"], r["restored_sums"]) for r in ranks], cfg,
                      other, fsdp)
        out["restore_sharded"] = {
            "shape": list(other), "equal": True,
            "s_per_rank": [r["restore_sharded_s"] for r in ranks]}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _nccl_train(store: Path, cards):
    """Full granite (32 layers) trained over NCCL, a card a rank, against
    one process on the first card (dispatching in as many groups as the
    mesh's data axis): at (1, 4) under ``ShardingPolicy(mesh)`` and at
    (2, 2) under FSDP (``policy_for(mesh, step_kind="train")``), each
    rank's first step traced. Returns (the runs' record, their
    launches)."""
    from repro_torch.launch.mesh import spawn

    full = _mt_config(None)
    launches = collections.Counter()
    out = {}
    for shape, fsdp in (((1, MESH_MODEL), False), ((2, 2), True)):
        data, model = shape
        tag = f"{data}x{model}" + ("_fsdp" if fsdp else "")
        ref = _mt_reference(full, data, store, tensors=False)
        res = spawn(_mt_rank, data, model, backend="nccl", device="cuda",
                    store_dir=store / f"nccl_train_{tag}",
                    args=({"layers": full.num_layers, "tensors": False,
                           "profile": True, "fsdp": fsdp},),
                    timeout=MESH_TRAIN_TIMEOUT_S)
        out[tag] = {
            "layers": full.num_layers, "shape": list(shape),
            "policy": ("policy_for(mesh, step_kind='train'): fsdp" if fsdp
                       else "ShardingPolicy(mesh)"),
            "ranks": len(res), "cards": cards,
            "param_bytes_per_rank": [r["param_bytes"] for r in res],
            "moment_bytes_per_rank": [r["moment_bytes"] for r in res],
            "devices": [r["device"] for r in res],
            "losses": [h["loss"] for h in res[0]["history"]],
            "one_process_losses": [h["loss"] for h in ref["history"]],
            "grad_norms": [h["grad_norm"] for h in res[0]["history"]],
            "one_process_grad_norms": [h["grad_norm"]
                                       for h in ref["history"]],
            "launches_per_rank": [r["launches"] for r in res],
            "staged_bytes_per_rank": [r["staged_bytes"] for r in res],
            "peak_bytes_per_rank": [r["peak_bytes"] for r in res],
            "step_ms_median_per_rank": [
                statistics.median(r["step_ms"][1:]) for r in res],
            "one_process_step_ms_median": statistics.median(
                ref["step_ms"][1:]),
            "one_process_peak_bytes": ref["peak_bytes"],
            "rank0_step_profile": res[0].get("profile")}
        emit({"phase": "mesh_train", "nccl_train": tag, **out[tag]})
        _check_mt_run(f"nccl {tag}", res, ref, shape, full, fsdp=fsdp)
        check(not fsdp or all((r["param_bytes"], r["moment_bytes"])
                              == MESH_TRAIN_FSDP_FULL_BYTES for r in res),
              f"mesh_train nccl {tag}: a rank holds "
              f"{[(r['param_bytes'], r['moment_bytes']) for r in res]} B, "
              f"not {MESH_TRAIN_FSDP_FULL_BYTES}")
        for r in res:
            launches.update(r["launches"])
        del res
        gc.collect()
    return out, launches


def phase_mesh_train(kernel_summary, pred):
    """Training under the mesh: one world of gloo ranks on this card
    against one-process runs (``MESH_TRAIN_LAYERS``) at (1, 4) and under
    FSDP at (2, 2) and (4, 1), the (2, 2) save restored on one process
    and at (4, 1); with 4 cards, full granite trained over NCCL at (1, 4)
    and under FSDP at (2, 2), a card a rank, against one process."""
    import tempfile

    start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cards = _cards()
    cfg = _mt_config(MESH_TRAIN_LAYERS)
    L = cfg.num_layers
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_train_"))
    launches = collections.Counter()
    runs = {}
    saved = None
    world = _gloo_world("mesh_train", store)
    try:
        world.start()
        # (1, 4) without FSDP (a 1-wide data axis); (2, 2) and (4, 1) under
        # the production policy, policy_for(mesh, step_kind="train"):
        # ZeRO-3 over data. The (2, 2) run saves; the (4, 1) run restores
        # that save onto its own blocks before it trains
        for shape, fsdp in (((1, MESH_MODEL), False), ((2, 2), True),
                            ((4, 1), True)):
            data, model = shape
            tag = f"{data}x{model}"
            t0 = time.perf_counter()
            ref = _mt_reference(cfg, data, store, tensors=True)
            ref_s = time.perf_counter() - t0
            save = store / "ckpt" if shape == (2, 2) else None
            restore = saved is not None and shape == (4, 1)
            t0 = time.perf_counter()
            res = world.run(
                _mt_rank, data, model,
                args=({"layers": L, "tensors": True, "fsdp": fsdp,
                       "grads": ref["grads"], "final": ref["final"],
                       "save": None if save is None else str(save),
                       "restore": (str(store / "ckpt") if restore
                                   else None)},),
                timeout=MESH_TRAIN_TIMEOUT_S)
            run_s = time.perf_counter() - t0
            for r in res:
                launches.update(r["launches"])
            runs[tag] = {
                "shape": list(shape), "layers": L, "cards": cards,
                "policy": ("policy_for(mesh, step_kind='train'): fsdp"
                           if fsdp else "ShardingPolicy(mesh)"),
                "ranks": len(res), "backend": "gloo",
                "transport": "4 processes sharing one card, collectives "
                "staged through pinned host buffers",
                "steps": MESH_TRAIN_STEPS, "tokens_per_step":
                    TRAIN_BATCH * TRAIN_SEQ,
                "losses": [h["loss"] for h in res[0]["history"]],
                "one_process_losses": [h["loss"] for h in ref["history"]],
                "loss_bit_equal": [h["loss"] == w["loss"] for h, w in
                                   zip(res[0]["history"], ref["history"])],
                "grad_norms": [h["grad_norm"] for h in res[0]["history"]],
                "one_process_grad_norms": [h["grad_norm"]
                                           for h in ref["history"]],
                "dropped": [h["dropped"] for h in res[0]["history"]],
                "one_process_dropped": [h["dropped"] for h in ref["history"]],
                # the most assignments a layer routed elsewhere than one
                # process, each step
                "counts_moved_max": [
                    int(np.abs(h["expert_counts"].astype(np.int64)
                               - w["expert_counts"]).sum(axis=1).max())
                    for h, w in zip(res[0]["history"], ref["history"])],
                "grad_share_per_rank": [r["grad_share"] for r in res],
                "param_share_per_rank": [r["param_share"] for r in res],
                "param_share_limit": MESH_TRAIN_PARAM_TOL,
                "update_cos_per_rank": [r["update_cos"] for r in res],
                "param_bytes_per_rank": res[0]["param_bytes"],
                "moment_bytes_per_rank": res[0]["moment_bytes"],
                "k1_shape_per_rank": [list(x) for x in res[0]["k1_shapes"][0]],
                "launches_per_rank": [r["launches"] for r in res],
                "staged_bytes_per_rank": [r["staged_bytes"] for r in res],
                "peak_bytes_per_rank": [r["peak_bytes"] for r in res],
                # step 1 holds the gradient check: steps 2..5 are timed
                "step_ms_median_per_rank": [
                    statistics.median(r["step_ms"][1:]) for r in res],
                "one_process_step_ms_median":
                    statistics.median(ref["step_ms"][1:]),
                "one_process_peak_bytes": ref["peak_bytes"],
                "wall_s_per_rank": [r["wall_s"] for r in res],
                "run_s": run_s, "one_process_s": ref_s,
            }
            emit({"phase": "mesh_train", "run": tag, **runs[tag]})
            _check_mt_run(tag, res, ref, shape, cfg, fsdp)
            if fsdp:
                check(all((r["param_bytes"], r["moment_bytes"])
                          == MESH_TRAIN_FSDP_BYTES for r in res),
                      f"mesh_train {tag}: a rank holds "
                      f"{[(r['param_bytes'], r['moment_bytes']) for r in res]}"
                      f" B, not {MESH_TRAIN_FSDP_BYTES}")
            emit({"phase": "mesh_train", "run": tag, "checks": "passed",
                  "replicas_bit_equal": True})
            if save is not None:
                saved = (tag, res)
            if restore:
                t0 = time.perf_counter()
                save_tag, save_res = saved
                check_ = _check_mesh_save(store / "ckpt", save_res, cfg,
                                          (2, 2), True, restored=(shape, res))
                check_.update(restored_equal=True,
                              check_s=time.perf_counter() - t0,
                              save_s_per_rank=[r["save_s"] for r in save_res])
                runs[save_tag]["save"] = check_
                emit({"phase": "mesh_train", "run": save_tag,
                      "save": check_})
                saved = None
            del res
            gc.collect()
        runs["ssm"] = _mesh_train_ssm(world, store, cards, pred)
        world.close()
        n_cards = torch.cuda.device_count()
        if n_cards >= MESH_MODEL:
            runs["nccl_train"], counts = _nccl_train(store, cards)
            launches.update(counts)
        else:
            runs["nccl_train"] = f"not run: {n_cards} card(s)"
            emit({"phase": "mesh_train", "nccl_train": runs["nccl_train"]})
    finally:
        import shutil

        world.close()
        shutil.rmtree(store, ignore_errors=True)
    close_phase({"phase": "mesh_train", "ok": True,
                 "kernels_per_rank": {key: {k: row[k] for k in (
                     "shape", "ms", "device_us", "plain_ms", "library_ms",
                     "bound_ms", "bound_by", "bound_share")}
                     for key, row in ((key, kernel_summary[key])
                                      for key in MESH_TRAIN_KERNEL_ROWS)}},
                start)
    return dict(launches)


# ------------------------------------------------------------ mesh: SSM
# The SSM and hybrid families under JAX's layout: mamba2-1.3b at
# full width (d_model 2048, 64 SSD heads of 64, state 128), 8 of its 48
# layers, and zamba2-1.2b at full width, 7 of its 38 layers (one stage of
# 6 mamba blocks and the shared attention + MLP block, then one tail
# block), served by the 4 gloo ranks on this card: each rank its heads of
# every SSD block (z/x/dt columns, its conv_x channels, its rows of
# out_proj; the B/C projections whole), its shard of the tied vocabulary
# and of the shared block, its heads of the SSM state and its rows over
# ``data``. The engine's dense cache (the families' only one), the linear
# placement (no MoE layer), the ``mesh`` scenario's 8 requests of 32 new
# tokens; the runs of one mesh shape share its 4 ranks. Each run is held
# to one process and to its witness (:class:`_MeshSums`: one process doing
# the mesh's sums, its rows and head blocks one after another). At full
# width the SSD block's per-head RMS norm scales heads whose output nearly
# cancels up to unit size, and with them any change in the order of a sum:
# the witness parts from one process by what the ranks do (H100: 0.0054 /
# 0.0618 / 0.0103 / 0.0122 in fp32, mamba2 then zamba2 at (1, 4) and
# (2, 2); 2.09 in bf16, 46 arg max partings inside |Δ|), while the ranks
# stay within 2.5e-4 of it in fp32 and equal it in bf16. fp32 runs as
# they come: tokens equal one process's and the witness's, logits within
# ``MESH_FP32_LOGITS_TOL`` of the witness's and ``MESH_SSM_FP32_LOGITS_TOL``
# of one process's (the readings' largest, 0.0618 at mamba2 (2, 2), ×2).
# mamba2 in bf16 at (1, 4) pinned to one process's tokens: logits within
# ``MESH_LOGITS_TOL`` of the witness's (one process's |Δ| printed), an arg
# max parting from one process's only where its top-1 margin lies within
# that row's |Δ|. A wrong layout (a mutation check: ``out_proj``'s
# partials left unsummed) reads 6.72 in fp32 and 6.84 in bf16 against the
# witness, 6.72 / 6.80 against one process, and parts the tokens.
MAMBA2, ZAMBA2 = "mamba2-1.3b", "zamba2-1.2b"
MESH_SSM_FP32_LOGITS_TOL = 0.125
# (tag, arch, layers, mesh shape, dtype)
MESH_SSM_RUNS = (("mamba2_1x4_fp32", MAMBA2, 8, (1, MESH_MODEL), "float32"),
                 ("mamba2_2x2_fp32", MAMBA2, 8, (2, 2), "float32"),
                 ("zamba2_1x4_fp32", ZAMBA2, 7, (1, MESH_MODEL), "float32"),
                 ("zamba2_2x2_fp32", ZAMBA2, 7, (2, 2), "float32"),
                 ("mamba2_1x4_bf16", MAMBA2, 8, (1, MESH_MODEL), "bfloat16"))
# mamba2 over NCCL on four cards, "scan": its whole depth in bf16, and 8
# layers in fp32 held to one process
MESH_SSM_NCCL_LAYERS = (48, 8)
# mesh_train: mamba2 at full width, 4 layers, 3 steps of the ``train``
# phase's batches, at (1, 4) and under FSDP at (2, 2), in fp32 (in bf16
# the layout's rounding orders, each rank's partial rounded to bf16 before
# the sums, part the step-1 gradients further still). Step 1's loss within
# ``MESH_TRAIN_LOSS_RTOL[0]``; each gradient leaf, the rank's block after
# the reduction over ranks, at cosine ≥ ``MESH_SSM_TRAIN_GRAD_COS`` with
# one process's block and within ``MESH_SSM_TRAIN_GRAD_TOL`` of the leaf's
# max |g|. Granite's ``MESH_TRAIN_GRAD_TOL`` (2e-2) is under what the
# ranks read on the H100 (the per-head norm above): cosines ≥ 0.99958,
# shares ≤ 0.058; a gradient short of its sum over ranks (a mutation
# check: the B/C cotangents unsummed) reads cosines 0.10 / 0.12 and
# shares 1.00 / 1.10 at (1, 4) / (2, 2).
MESH_SSM_TRAIN_LAYERS = 4
MESH_SSM_TRAIN_STEPS = 3
MESH_SSM_TRAIN_GRAD_COS = 0.999
MESH_SSM_TRAIN_GRAD_TOL = 0.1


def _ssm_engine(params, cfg, policy, mode, device=None):
    """The dense engine of an SSM or hybrid config (linear placement, 8
    slots of 128 positions) with the ``mesh`` scenario's 8 requests."""
    from repro_torch.serving import EngineConfig, ServingEngine

    eng = ServingEngine(
        params, cfg,
        EngineConfig(max_batch=8, max_len=128, placement_policy="linear",
                     other_time_per_step=2e-4, decode_mode=mode,
                     kv_mode="dense"),
        policy=policy, device=device)
    rng = np.random.default_rng(0)
    for _ in range(MESH_REQUESTS):
        eng.submit(rng.integers(0, cfg.vocab_size,
                                size=int(rng.integers(8, 32))),
                   max_new_tokens=MESH_NEW)
    return eng


# the leaves of one SSD layer a rank of the model axis holds a block of,
# and the dim it is cut on (JAX's specs, ``repro/models/ssm.py:63-80``):
# the rest (B/C projections and convolutions) are whole on every rank
_SSD_HEAD_DIMS = {"wz": 1, "wx": 1, "wdt": 1, "dt_bias": 0, "A_log": 0,
                  "D": 0, "conv_x_w": 1, "conv_x_b": 0, "gate_norm": 0,
                  "out_proj": 0}


def _head_block(p, m: int, model: int) -> dict:
    """One SSD layer's leaves ``p`` as rank ``m`` of ``model`` holds them."""
    return {k: t if k not in _SSD_HEAD_DIMS
            else t.chunk(model, _SSD_HEAD_DIMS[k])[m].contiguous()
            for k, t in p.items()}


def _sum_in_order(parts, dtype):
    """``Mesh.all_reduce``'s sum of ``parts``: fp32, in rank order, cast
    once to ``dtype``."""
    out = parts[0].to(torch.float32, copy=True)
    for q in parts[1:]:
        out.add_(q)
    return out.to(dtype)


# the batch dim of each dense cache tree of the SSM and hybrid families
# (``models/model.py::init_decode_cache``)
_CACHE_ROW_DIM = {"ssm": 1, "ssm_staged": 2, "attn": 1, "ssm_tail": 1}


class _MeshSums:
    """The witness of an SSM mesh run: one process that does the
    arithmetic of a (``data``, ``model``) mesh's ranks. A decode step runs
    as ``data`` steps, one a block of rows (each a data rank's rows and
    its rows of the caches), the logits concatenated. Each SSD block runs
    as ``model`` head blocks one after another (each a rank's slice of the
    weights, of the state and of ``conv_x``'s buffer; B/C whole), and
    ``out_proj``'s fp32 partials are summed in rank order and cast once;
    where the model axis divides a prefill's S, B and C are projected on
    its S/``model`` row blocks by ``[wb | wc]``, as ``rows_linear``
    projects them. The rest of each row block's step (norms, vocabulary,
    zamba2's shared attention and MLP) runs as one process runs it. Used
    as a context manager around one process's engine, from its build on."""

    def __init__(self, data: int, model: int):
        self.data, self.model = data, model

    def __enter__(self):
        import repro_torch.models.model as mm
        import repro_torch.models.ssm as ssm
        import repro_torch.serving.engine as engine

        self._mods = (mm, ssm, engine)
        self._saved = (mm.ssm_train, mm.ssm_decode, ssm._project,
                       ssm._out_proj, engine.decode_step)
        train, decode, project, _, step = self._saved
        model, data, bc = self.model, self.data, []

        def projected(x, p):
            z, xs, Bp, Cp, dt = project(x, p)
            return (z, xs, *bc, dt) if bc else (z, xs, Bp, Cp, dt)

        def partial(y, p, policy, *, scatter=False):
            return torch.matmul(y.float(), p["out_proj"].float())

        def blocked_train(x, p, config, *, return_cache=False, policy=None,
                          seq_sharded=False):
            if model > 1 and x.shape[1] % model == 0:
                wbc = torch.cat([p["wb"], p["wc"]], dim=-1)
                rows = torch.cat([torch.matmul(b, wbc)
                                  for b in x.chunk(model, 1)], 1)
                bc[:] = rows.split(p["wb"].shape[-1], dim=-1)
            outs = [train(x, _head_block(p, m, model), config,
                          return_cache=return_cache) for m in range(model)]
            bc.clear()
            cache = None
            if return_cache:
                cs = [c for _, c in outs]
                cache = {"state": torch.cat([c["state"] for c in cs], 1),
                         "conv_x": torch.cat([c["conv_x"] for c in cs], -1),
                         "conv_b": cs[0]["conv_b"], "conv_c": cs[0]["conv_c"]}
            return _sum_in_order([o for o, _ in outs], x.dtype), cache

        def blocked_decode(x, p, cache, config, policy=None, *, rows=None):
            nh, di = cache["state"].shape[1], cache["conv_x"].shape[-1]
            bufs = {k: cache[k] for k in ("conv_b", "conv_c")}
            parts = []
            for m in range(model):
                hs = slice(m * nh // model, (m + 1) * nh // model)
                cs = slice(m * di // model, (m + 1) * di // model)
                c = {"state": cache["state"][:, hs],
                     "conv_x": cache["conv_x"][:, :, cs],
                     **{k: b.clone() for k, b in bufs.items()}}
                parts.append(decode(x, _head_block(p, m, model), c, config))
            for k, b in bufs.items():
                b.copy_(c[k])
            return _sum_in_order(parts, x.dtype)

        def rowed_step(params, caches, cur_len, tokens, config, *a, **kw):
            per, logits = tokens.shape[0] // data, []
            for r in range(data):
                mine = {k: None if sub is None else
                        {n: t.narrow(_CACHE_ROW_DIM[k], r * per, per)
                         for n, t in sub.items()}
                        for k, sub in caches.items()}
                logits.append(step(params, mine, cur_len,
                                   tokens[r * per:(r + 1) * per], config,
                                   *a, **kw)[0])
            return torch.cat(logits, 0), caches, None

        mm.ssm_train, mm.ssm_decode = blocked_train, blocked_decode
        ssm._project, ssm._out_proj = projected, partial
        if data > 1:
            engine.decode_step = rowed_step
        return self

    def __exit__(self, *exc):
        mm, ssm, engine = self._mods
        (mm.ssm_train, mm.ssm_decode, ssm._project, ssm._out_proj,
         engine.decode_step) = self._saved
        return False


def _ssm_reference(arch, layers, dtype: str, store: Path, *, sums=None,
                   force=None):
    """The scenario in one process on the card (``"python"``): tokens,
    each step's and each prefill's logits (saved for the ranks), the
    parameter and cache bytes. ``sums`` ((data, model)): the witness of a
    mesh of that shape (:class:`_MeshSums`); ``force``: a saved run's
    path, whose tokens and prefill logits the engine takes
    (:func:`_pin_calls`)."""
    from repro_torch.models import init_params

    cfg = _ssm_config(arch, layers)
    params = init_params(cfg, seed=0, device="cuda",
                         dtype=getattr(torch, dtype))
    pin = None if force is None else torch.load(force)
    logits, pinned = [], {}
    with _MeshSums(*sums) if sums else contextlib.nullcontext():
        eng = _ssm_engine(params, cfg, None, "python", device="cuda")
        undo = _pin_calls(pinned, pin, router=False)
        step_ms, wall = _mesh_drive(eng, logits, None,
                                    None if pin is None else pin["logits"])
        undo()
    tag = "one" if sums is None else "x".join(map(str, sums))
    path = store / f"ssm_{arch}_{layers}_{dtype}_{tag}.pt"
    torch.save({"logits": logits, "prefill": pinned["prefill"]}, path)
    ref = {"tokens": {r.uid: list(r.generated) for r in eng.finished},
           "path": str(path), "step_ms": step_ms, "wall_s": wall,
           "param_bytes": _tree_nbytes(params),
           "cache_bytes": _cache_bytes(eng.caches)}
    del eng, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def _mesh_ssm_rank(mesh, scs):
    """:func:`_mesh_ssm_run` of each scenario of ``scs`` on this rank, in
    turn."""
    return [_mesh_ssm_run(mesh, sc) for sc in scs]


def _mesh_ssm_run(mesh, sc):
    """One rank of an SSM mesh run: its shard of the seed-0 draw (as one
    process draws it), the scenario served in ``sc["mode"]``, on one
    process's tokens with ``sc["force"]``; returns what the parent checks
    (tokens, logits against one process's, bytes, collectives a decode
    step by kind, captures, times)."""
    from repro_torch.launch.meta_mesh import record_collectives
    from repro_torch.models import init_params
    from repro_torch.sharding import ShardingPolicy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _ssm_config(sc["arch"], sc["layers"])
    policy = ShardingPolicy(mesh=mesh)
    params = init_params(cfg, seed=0, device=mesh.device,
                         dtype=getattr(torch, sc["dtype"]), policy=policy)
    shape = (mesh.size("data"), mesh.size("model"))
    ref = torch.load(sc["reference"])
    pinned = {}
    undo = _pin_calls(pinned, ref if sc["force"] else None,
                      mesh.index("data"), router=False)
    eng = _ssm_engine(params, cfg, policy, sc["mode"])
    log = record_collectives(mesh)
    log.on = False
    log.reset()
    decode = eng._decode

    def counted_step(*a, **kw):
        log.on = True
        try:
            return decode(*a, **kw)
        finally:
            log.on = False

    eng._decode = counted_step
    mesh.staged_bytes = 0
    logits = []
    step_ms, wall = _mesh_drive(eng, logits, None,
                                ref["logits"] if sc["force"] else None)
    undo()
    stats, n = log.stats(), max(eng.decode_count, 1)
    finite = all(bool(torch.isfinite(t[:, :cfg.vocab_size]).all())
                 for t in logits + pinned["prefill"])
    # a captured step's replays call no Python: counted in "python"
    eager = eng.decode_graph is None
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "logits_finite": finite, "param_bytes": _tree_nbytes(params),
           "cache_bytes": _cache_bytes(eng.caches),
           "shard_mismatches": _shard_mismatches(params, cfg, shape),
           "tokens": {r.uid: list(r.generated) for r in eng.finished},
           "prefills": eng.prefill_count, "decode_steps": eng.decode_count,
           "step_ms": step_ms, "wall_s": wall,
           "staged_bytes": mesh.staged_bytes,
           "captures": eng.graph_capture_counts,
           "collectives_per_step": ({k: v / n for k, v in
                                     stats["counts"].items()}
                                    if eager else None),
           "collective_bytes_per_step": ({k: v / n for k, v in
                                          stats["bytes"].items()}
                                         if eager else None)}
    out.update(_logits_against(logits, ref["logits"]))
    out["prefill"] = _logits_against(pinned["prefill"], ref["prefill"])
    if sc.get("witness"):
        wit = torch.load(sc["witness"])
        out["witness"] = _logits_against(logits, wit["logits"])
        out["witness"]["prefill"] = _logits_against(pinned["prefill"],
                                                    wit["prefill"])
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _witness_against(wit, ref) -> dict:
    """A witness run (:class:`_MeshSums`) against one process's run of the
    same draw: the largest |Δ| of its decode and prefill logits, its arg
    max partings, and whether its tokens are one process's."""
    w, r = torch.load(wit["path"]), torch.load(ref["path"])
    dec = _logits_against(w["logits"], r["logits"])
    pre = _logits_against(w["prefill"], r["prefill"])
    return {"logits_max_abs_diff": dec["logits_max_abs_diff"],
            "prefill_logits_max_abs_diff": pre["logits_max_abs_diff"],
            "argmax_partings": len(dec["argmax_partings"])
            + len(pre["argmax_partings"]),
            "tokens_equal": wit["tokens"] == ref["tokens"]}


def _check_ssm_run(tag, res, ref, pred, mode, tol, wit=None,
                   wtol=None) -> None:
    """An SSM run's ranks against one process, the witness of its mesh
    (``wit``, :class:`_MeshSums`; None where there is none) and the mesh
    dry run's prediction (``pred``, None where there is none):
    ``"exact"`` (fp32, unpinned) tokens equal one process's and the
    witness's, logits within ``tol`` of one process's and ``wtol`` of the
    witness's; ``"pinned"`` (bf16, one process's tokens) logits within
    ``wtol`` of the witness's (``tol`` None: one process's |Δ| printed),
    an arg max that parts from one process's only inside that row's |Δ|;
    ``"free"`` (bf16 ``"scan"``, which cannot be pinned) printed. Every
    rank: its leaves its shards' bytes, finite logits, the predicted
    parameter and cache bytes and collectives a decode step (counts and
    bytes by kind)."""
    for r in res:
        check(r["logits_finite"],
              f"mesh {tag}: rank {r['rank']}'s logits are not finite")
        check(not r["shard_mismatches"],
              f"mesh {tag}: rank {r['rank']}'s leaves are not its shards: "
              f"{r['shard_mismatches']}")
        if mode != "free":
            steps, pre = r["steps_compared"], r["prefill"]["steps_compared"]
            worst = max(r["logits_max_abs_diff"] or 0.0,
                        r["prefill"]["logits_max_abs_diff"] or 0.0)
            check(steps == len(ref["step_ms"]) > 0
                  and pre == r["prefills"] > 0,
                  f"mesh {tag}: rank {r['rank']} compared {steps} decode "
                  f"steps and {pre} prefills with one process's")
            check(tol is None or worst <= tol,
                  f"mesh {tag}: rank {r['rank']}'s logits part from one "
                  f"process's by {worst} > {tol}")
            check(r["tokens"] == ref["tokens"],
                  f"mesh {tag}: rank {r['rank']}'s tokens part from one "
                  "process's")
            partings = (r["argmax_partings"]
                        + r["prefill"]["argmax_partings"])
            check(mode == "pinned" or not partings,
                  f"mesh {tag}: rank {r['rank']}'s arg max parts: {partings}")
            check(all(p["one_process_top1_margin"] <= p["abs_diff"]
                      for p in partings),
                  f"mesh {tag}: rank {r['rank']}'s arg max parts outside "
                  f"its deviation: {partings}")
        if wit is not None:
            w = r["witness"]
            steps, pre = w["steps_compared"], w["prefill"]["steps_compared"]
            worst = max(w["logits_max_abs_diff"] or 0.0,
                        w["prefill"]["logits_max_abs_diff"] or 0.0)
            check(steps == len(wit["step_ms"]) > 0
                  and pre == r["prefills"] > 0 and worst <= wtol,
                  f"mesh {tag}: rank {r['rank']}'s logits part from its "
                  f"witness's by {worst} > {wtol} ({steps} decode steps, "
                  f"{pre} prefills compared)")
            check(mode == "pinned" or r["tokens"] == wit["tokens"],
                  f"mesh {tag}: rank {r['rank']}'s tokens part from its "
                  "witness's")
        if pred is None:
            continue
        check(r["param_bytes"] == pred["params_bytes"]
              and r["cache_bytes"] == pred["caches_bytes"],
              f"mesh {tag}: rank {r['rank']} holds {r['param_bytes']} + "
              f"{r['cache_bytes']} B, the dry run predicts "
              f"{pred['params_bytes']} + {pred['caches_bytes']}")
        check(r["collectives_per_step"] in (None,
                                            pred["collectives"]["counts"])
              and r["collective_bytes_per_step"] in (
                  None, pred["collectives"]["bytes"]),
              f"mesh {tag}: rank {r['rank']} runs "
              f"{r['collectives_per_step']} collectives a step "
              f"({r['collective_bytes_per_step']} B), the dry run predicts "
              f"{pred['collectives']}")


def _ssm_bounds(dtype: str) -> tuple:
    """(mode, bound against one process, bound against the witness) of an
    SSM mesh run in ``dtype``: bf16 is held to its witness alone."""
    if dtype == "float32":
        return "exact", MESH_SSM_FP32_LOGITS_TOL, MESH_FP32_LOGITS_TOL
    return "pinned", None, MESH_LOGITS_TOL


def _mesh_ssm(world, store: Path, cards, pred) -> dict:
    """The gloo SSM runs of :data:`MESH_SSM_RUNS` (the runs of one mesh
    shape in one run of ``world``'s ranks), each against one process (one
    reference per config and dtype), the witness of its mesh and the mesh
    dry run's prediction."""
    refs, wits, runs = {}, {}, {}
    for arch, layers, dtype in dict.fromkeys(
            (a, n, d) for _, a, n, _, d in MESH_SSM_RUNS):
        t0 = time.perf_counter()
        refs[(arch, layers, dtype)] = _ssm_reference(arch, layers, dtype,
                                                     store)
        refs[(arch, layers, dtype)]["s"] = time.perf_counter() - t0
    for tag, arch, layers, shape, dtype in MESH_SSM_RUNS:
        ref = refs[(arch, layers, dtype)]
        wits[tag] = _ssm_reference(
            arch, layers, dtype, store, sums=shape,
            force=ref["path"] if dtype == "bfloat16" else None)
    for shape in dict.fromkeys(r[3] for r in MESH_SSM_RUNS):
        tags = [r for r in MESH_SSM_RUNS if r[3] == shape]
        scs = [{"arch": arch, "layers": layers, "dtype": dtype,
                "mode": "python", "force": dtype == "bfloat16",
                "reference": refs[(arch, layers, dtype)]["path"],
                "witness": wits[tag]["path"]}
               for tag, arch, layers, _, dtype in tags]
        t0 = time.perf_counter()
        res = world.run(_mesh_ssm_rank, *shape, args=(scs,),
                        timeout=MESH_TIMEOUT_S)
        run_s = time.perf_counter() - t0
        for i, (tag, arch, layers, _, dtype) in enumerate(tags):
            ref, wit = refs[(arch, layers, dtype)], wits[tag]
            rr = [r[i] for r in res]
            mode, tol, wtol = _ssm_bounds(dtype)
            runs[tag] = {
                "arch": arch, "shape": list(shape), "layers": layers,
                "dtype": dtype, "cards": cards, "ranks": len(rr),
                "backend": "gloo", "decode_mode": "python", "mode": mode,
                "logits_tol": tol, "witness_logits_tol": wtol,
                "tokens_equal_one_process": all(
                    r["tokens"] == ref["tokens"] for r in rr),
                "logits_max_abs_diff": [r["logits_max_abs_diff"]
                                        for r in rr],
                "prefill_logits_max_abs_diff": [
                    r["prefill"]["logits_max_abs_diff"] for r in rr],
                "argmax_partings": [len(r["argmax_partings"])
                                    + len(r["prefill"]["argmax_partings"])
                                    for r in rr],
                "witness_logits_max_abs_diff": [
                    r["witness"]["logits_max_abs_diff"] for r in rr],
                "witness_prefill_logits_max_abs_diff": [
                    r["witness"]["prefill"]["logits_max_abs_diff"]
                    for r in rr],
                "witness_against_one_process": _witness_against(wit, ref),
                "param_bytes_per_rank": rr[0]["param_bytes"],
                "state_bytes_per_rank": rr[0]["cache_bytes"],
                "one_process_param_bytes": ref["param_bytes"],
                "one_process_state_bytes": ref["cache_bytes"],
                "predicted": {k: pred[tag][k] for k in ("params_bytes",
                                                        "caches_bytes")},
                "collectives_per_step_by_kind":
                    rr[0]["collectives_per_step"],
                "collective_bytes_per_step_by_kind":
                    rr[0]["collective_bytes_per_step"],
                "prefills": rr[0]["prefills"],
                "decode_steps": rr[0]["decode_steps"],
                "staged_bytes": [r["staged_bytes"] for r in rr],
                "decode_step_ms_median_per_rank": [
                    statistics.median(r["step_ms"]) for r in rr],
                "one_process_decode_step_ms_median":
                    statistics.median(ref["step_ms"]),
                "witness_decode_step_ms_median":
                    statistics.median(wit["step_ms"]),
                "wall_s_per_rank": [r["wall_s"] for r in rr],
                "run_s_of_the_shape": run_s,
                "one_process_s": ref["s"]}
            emit({"phase": "mesh", "run": tag, **runs[tag]})
            _check_ssm_run(tag, rr, ref, pred[tag], mode, tol, wit, wtol)
        del res
        gc.collect()
    return runs


def _nccl_ssm_scan(store: Path, cards) -> dict:
    """mamba2 over NCCL, a card a rank, at (1, 4) in ``"scan"`` (one
    capture a rank): its whole depth in bf16 (``"free"``: a captured step
    cannot be pinned) and 8 layers in fp32 held to one process and to the
    witness of the mesh."""
    from repro_torch.launch.mesh import spawn

    out = {}
    for layers, dtype in zip(MESH_SSM_NCCL_LAYERS, ("bfloat16", "float32")):
        ref = _ssm_reference(MAMBA2, layers, dtype, store)
        fp32 = dtype == "float32"
        wit = (_ssm_reference(MAMBA2, layers, dtype, store,
                              sums=(1, MESH_MODEL)) if fp32 else None)
        tag = f"nccl_scan_mamba2_{layers}_{dtype}"
        res = spawn(_mesh_ssm_rank, 1, MESH_MODEL, backend="nccl",
                    device="cuda", store_dir=store / tag,
                    args=([{"arch": MAMBA2, "layers": layers,
                            "dtype": dtype, "mode": "scan", "force": False,
                            "reference": ref["path"],
                            "witness": wit and wit["path"]}],),
                    timeout=MESH_TIMEOUT_S)
        res = [r[0] for r in res]
        mode = "exact" if fp32 else "free"
        out[tag] = {
            "layers": layers, "dtype": dtype, "mode": mode, "cards": cards,
            "devices": [r["device"] for r in res], "captures_per_rank": 1,
            "tokens_equal_one_process": all(r["tokens"] == ref["tokens"]
                                            for r in res),
            "logits_max_abs_diff": [r["logits_max_abs_diff"] for r in res],
            "witness_logits_max_abs_diff": [
                r["witness"]["logits_max_abs_diff"] if fp32 else None
                for r in res],
            "param_bytes_per_rank": res[0]["param_bytes"],
            "state_bytes_per_rank": res[0]["cache_bytes"],
            "decode_step_ms_median_per_rank": [
                statistics.median(r["step_ms"]) for r in res],
            "one_process_decode_step_ms_median":
                statistics.median(ref["step_ms"])}
        emit({"phase": "mesh", "run": tag, **out[tag]})
        _check_ssm_run(tag, res, ref, None, mode, MESH_SSM_FP32_LOGITS_TOL,
                       wit, MESH_FP32_LOGITS_TOL)
        check(all(r["captures"] == {"decode": 1, "prefill": 0, "migrate": 0}
                  for r in res),
              f"mesh {tag}: captures {[r['captures'] for r in res]}")
        del res
        gc.collect()
    return out


def _mt_ssm_build(cfg, device, policy):
    """mamba2's fp32 train state on this process (the seed-0 draw, the
    rank's shards under ``policy``), its step (the launcher's optimizer,
    remat off) and the ``train`` phase's batches."""
    from repro_torch.models import init_params
    from repro_torch.training import (
        AdamWConfig,
        DataConfig,
        SyntheticTokenStream,
        init_train_state,
        make_train_step,
    )

    params = init_params(cfg, seed=0, device=device, dtype=torch.float32,
                         policy=policy)
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=10,
                      total_steps=TRAIN_STEPS)
    state = init_train_state(params, opt)
    step = make_train_step(cfg, opt, policy=policy, remat=False)
    data = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    return state, step, data


def _mt_ssm_reference(cfg, store: Path) -> dict:
    """One process on the card: the steps, and the first step's gradients
    saved for the ranks."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    state, step, data = _mt_ssm_build(cfg, dev, None)
    path = store / "ssm_train_grads.pt"

    def save(grads):
        torch.save({n: g.detach().float().cpu() for n, g in _leaves(grads)},
                   path)

    history, step_ms = _mt_run(state, step, None, data, dev, save,
                               steps=MESH_SSM_TRAIN_STEPS)
    out = {"history": history, "step_ms": step_ms, "grads": str(path),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mt_ssm_rank(mesh, sc):
    """One rank of mamba2's training: the steps, its first step's reduced
    gradients against one process's blocks (each leaf's cosine, and max
    |Δ| over the whole leaf's max |g|), its parameter and moment bytes."""
    from repro_torch.launch.mesh import policy_for
    from repro_torch.sharding import ShardingPolicy, param_specs, take_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _ssm_config(MAMBA2, sc["layers"])
    policy = (policy_for(mesh, step_kind="train") if sc["fsdp"]
              else ShardingPolicy(mesh=mesh))
    state, step, data = _mt_ssm_build(cfg, mesh.device, policy)
    specs = dict(_leaves(param_specs(state["params"], policy, cfg)))
    ref = torch.load(sc["grads"])
    shares, cosines = {}, {}

    def held(grads):
        for name, g in _leaves(grads):
            whole = ref[name]
            want = take_shard(whole, specs[name], mesh).double()
            got = g.detach().cpu().double()
            shares[name] = float((got - want).abs().max()
                                 / max(float(whole.abs().max()), 1e-30))
            cosines[name] = float(torch.nn.functional.cosine_similarity(
                got.flatten(), want.flatten(), dim=0))

    mesh.staged_bytes = 0
    torch.cuda.reset_peak_memory_stats()
    history, step_ms = _mt_run(state, step, None, data, mesh.device, held,
                               steps=MESH_SSM_TRAIN_STEPS)
    worst = max(shares, key=shares.get)
    least = min(cosines, key=cosines.get)
    return {"rank": mesh.rank, "history": history, "step_ms": step_ms,
            "grad_share": shares[worst], "grad_share_leaf": worst,
            "grad_cos": cosines[least], "grad_cos_leaf": least,
            "param_bytes": _tree_nbytes(state["params"]),
            "moment_bytes": _tree_nbytes({k: state["opt"][k]
                                          for k in ("mu", "nu")}),
            "staged_bytes": mesh.staged_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def _mesh_train_ssm(world, store: Path, cards, pred) -> dict:
    """mamba2 trained at (1, 4) and under FSDP at (2, 2) on ``world``'s
    gloo ranks against one process: step 1's loss and gradients' cosines,
    every rank the same metrics, the bytes the mesh dry run predicts."""
    cfg = _ssm_config(MAMBA2, MESH_SSM_TRAIN_LAYERS)
    t0 = time.perf_counter()
    ref = _mt_ssm_reference(cfg, store)
    ref_s = time.perf_counter() - t0
    runs = {}
    for tag, shape, fsdp in (("mamba2_train_1x4", (1, MESH_MODEL), False),
                             ("mamba2_train_fsdp_2x2", (2, 2), True)):
        t0 = time.perf_counter()
        res = world.run(_mt_ssm_rank, *shape,
                        args=({"layers": cfg.num_layers, "fsdp": fsdp,
                               "grads": ref["grads"]},),
                        timeout=MESH_TRAIN_TIMEOUT_S)
        run_s = time.perf_counter() - t0
        want = (pred[tag]["params_bytes"], pred[tag]["moments_bytes"])
        loss, ref_loss = (res[0]["history"][0]["loss"],
                          ref["history"][0]["loss"])
        runs[tag] = {
            "shape": list(shape), "layers": cfg.num_layers, "cards": cards,
            "policy": ("policy_for(mesh, step_kind='train'): fsdp" if fsdp
                       else "ShardingPolicy(mesh)"),
            "steps": MESH_SSM_TRAIN_STEPS,
            "losses": [h["loss"] for h in res[0]["history"]],
            "one_process_losses": [h["loss"] for h in ref["history"]],
            "grad_norms": [h["grad_norm"] for h in res[0]["history"]],
            "one_process_grad_norms": [h["grad_norm"]
                                       for h in ref["history"]],
            "step1_loss_rel_diff": abs(loss / ref_loss - 1.0),
            "grad_share_per_rank": [r["grad_share"] for r in res],
            "grad_share_leaf_per_rank": [r["grad_share_leaf"] for r in res],
            "grad_cos_per_rank": [r["grad_cos"] for r in res],
            "grad_cos_leaf_per_rank": [r["grad_cos_leaf"] for r in res],
            "grad_cos_limit": MESH_SSM_TRAIN_GRAD_COS,
            "grad_share_limit": MESH_SSM_TRAIN_GRAD_TOL,
            "param_bytes_per_rank": res[0]["param_bytes"],
            "moment_bytes_per_rank": res[0]["moment_bytes"],
            "predicted": list(want),
            "staged_bytes_per_rank": [r["staged_bytes"] for r in res],
            "peak_bytes_per_rank": [r["peak_bytes"] for r in res],
            "one_process_peak_bytes": ref["peak_bytes"],
            "step_ms_median_per_rank": [
                statistics.median(r["step_ms"][1:]) for r in res],
            "one_process_step_ms_median": statistics.median(
                ref["step_ms"][1:]),
            "run_s": run_s, "one_process_s": ref_s}
        emit({"phase": "mesh_train", "run": tag, **runs[tag]})
        check(abs(loss / ref_loss - 1.0) <= MESH_TRAIN_LOSS_RTOL[0],
              f"mesh_train {tag}: step 1's loss {loss} against one "
              f"process's {ref_loss}")
        check(all(r["grad_cos"] >= MESH_SSM_TRAIN_GRAD_COS for r in res),
              f"mesh_train {tag}: a gradient leaf's cosine with one "
              f"process's is {runs[tag]['grad_cos_per_rank']} "
              f"({runs[tag]['grad_cos_leaf_per_rank']}), under "
              f"{MESH_SSM_TRAIN_GRAD_COS}")
        check(all(r["grad_share"] <= MESH_SSM_TRAIN_GRAD_TOL for r in res),
              f"mesh_train {tag}: a gradient leaf parts from one process's "
              f"by {runs[tag]['grad_share_per_rank']} of its max "
              f"({runs[tag]['grad_share_leaf_per_rank']}), over "
              f"{MESH_SSM_TRAIN_GRAD_TOL}")
        check(all(r["history"] == res[0]["history"] for r in res),
              f"mesh_train {tag}: the ranks' metrics differ")
        check(all((r["param_bytes"], r["moment_bytes"]) == want
                  for r in res),
              f"mesh_train {tag}: a rank holds "
              f"{[(r['param_bytes'], r['moment_bytes']) for r in res]} B, "
              f"the dry run predicts {want}")
        del res
        gc.collect()
    return runs


def nccl_paths():
    """The multi-card paths alone (four cards): the ``mesh`` phase's NCCL
    ``"scan"`` serves at (1, 4) and under FSDP at (4, 1) and the
    ``mesh_train`` phase's NCCL training of full granite at (1, 4) and
    under FSDP at (2, 2), each against its one-process run. Returns their
    launches."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    n_cards = torch.cuda.device_count()
    check(n_cards >= MESH_MODEL, f"nccl: {n_cards} card(s), {MESH_MODEL} needed")
    cards = _cards()
    cfg = get_config(ARCH)
    row_bytes = 3 * cfg.d_model * (cfg.expert_d_ff // cfg.expert_tp) * 2
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_nccl_"))
    launches = collections.Counter()
    try:
        t0 = time.perf_counter()
        record, counts = _nccl_scan(store, row_bytes, cards)
        launches.update(counts)
        emit({"phase": "mesh", "nccl_scan": record,
              "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        emit({"phase": "mesh", "nccl_scan_ssm": _nccl_ssm_scan(store, cards),
              "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        _, counts = _nccl_train(store, cards)
        launches.update(counts)
        emit({"phase": "mesh_train", "nccl_train_ok": True,
              "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return dict(launches)


def _meta_params(cfg):
    from repro_torch.models import init_params

    return init_params(cfg, device="meta")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--src", type=Path, default=ROOT / "src",
        help="directory holding the repro_torch package to run (default: "
             "this checkout's src/)")
    args = parser.parse_args(argv)
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "setup", "src": str(src), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False,
          "cudnn_allow_tf32": False})

    phase_build()
    summary = phase_kernels()
    phase_parity()
    launches, serve_peak = phase_serve(summary)
    dense_ref_launches = phase_dense_ref(summary)
    replan_launches = phase_replan(serve_peak)
    online_launches = phase_online(serve_peak)
    replicated_launches = phase_replicated(
        summary["serve_decode_step_ms_median"], serve_peak)
    gc.collect()
    torch.cuda.empty_cache()
    swa_launches = phase_swa()
    families_launches = phase_families()
    train_launches, train_step_ms = phase_train()
    dryrun_launches, mesh_pred = phase_dryrun(src, train_step_ms)
    examples_launches = phase_examples()
    collective_launches = phase_collective()
    mesh_launches = phase_mesh(summary, mesh_pred)
    mesh_train_launches = phase_mesh_train(summary, mesh_pred)

    sources = {
        "moe_ffn": ("src/repro_torch/kernels/csrc/moe_ffn.cu",
                    "src/repro/kernels/moe_gemm.py:50"),
        "topk_router_stats": ("src/repro_torch/kernels/csrc/topk_router.cu",
                              "src/repro/kernels/topk_router.py:63"),
        "topk_router": ("src/repro_torch/kernels/csrc/topk_router.cu",
                        "src/repro/kernels/topk_router.py:56"),
        # K1's large-capacity kernels (bf16, C >= C_MIN): ``launches`` and
        # the numbers are the ``train`` phase's (C = 205), whose forward
        # runs them; the serving decode never does
        "moe_ffn_wgmma": ("src/repro_torch/kernels/csrc/moe_ffn_wgmma.cuh",
                          "src/repro/kernels/moe_gemm.py:50"),
    }
    main_row = {"moe_ffn_wgmma": "moe_ffn/train"}
    main_launches = {"moe_ffn_wgmma": train_launches}
    kernels = []
    for name, (source, replaces) in sources.items():
        row = summary[main_row.get(name, f"{name}/decode")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": main_launches.get(name, launches)[name],
            # the capacity-free oracle's card runs: K2 only
            "dense_ref_launches": dense_ref_launches[name],
            "replan_launches": replan_launches[name],
            "online_launches": online_launches[name],
            "replicated_launches": replicated_launches[name],
            "swa_launches": swa_launches[name],
            "families_launches": families_launches[name],
            "train_launches": train_launches[name],
            "dryrun_launches": dryrun_launches[name],
            "examples_launches": examples_launches[name],
            "collective_launches": collective_launches[name],
            # summed over the ranks of every mesh run
            "mesh_launches": mesh_launches.get(name, 0),
            # summed over the ranks of every mesh_train run
            "mesh_train_launches": mesh_train_launches.get(name, 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_us": row["device_us"], "bound_share": row["bound_share"],
            "shape": row["shape"],
        })
        if name.startswith("moe_ffn"):
            kernels[-1].update(path=row["path"],
                               wgmma_min_c=summary["moe_ffn_wgmma_min_c"])
    rank_row = summary["moe_ffn/decode_rank"]
    kernels[0]["decode_rank"] = {
        k: rank_row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                 "library_ms", "bound_ms", "bound_by",
                                 "device_us", "bound_share")}
    for i, name, tags in ((0, "moe_ffn", ("train_rank", "train_rank_2x2",
                                          "train_rank_4x1")),
                          (1, "topk_router_stats", ("train_rank_2x2",
                                                    "train_rank_4x1"))):
        for tag in tags:
            row = summary[f"{name}/{tag}"]
            kernels[i][tag] = {
                k: row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by",
                                    "device_us", "bound_share", "path")
                if k in row}
    s84 = summary["moe_ffn/decode_s84"]
    kernels[0]["replicated_pool"] = {
        k: s84[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                            "library_ms", "bound_ms", "bound_by",
                            "device_us", "bound_share")}
    for i, name in ((0, "moe_ffn"), (1, "topk_router_stats")):
        kernels[i]["train"] = {
            k: summary[f"{name}/train"][k]
            for k in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                      "bound_ms", "bound_by", "device_us", "bound_share",
                      "path")
            if k in summary[f"{name}/train"]}
    for i, name in ((0, "moe_ffn"), (1, "topk_router_stats")):
        for tag in ("mixtral_decode", "mixtral_prefill"):
            row = summary[f"{name}/{tag}"]
            kernels[i][tag] = {
                k: row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by",
                                    "device_us", "bound_share", "path")
                if k in row}
    # the wgmma kernels at every timed shape that runs them
    wg = kernels[3]
    for tag in ("mixtral_prefill", "train_rank", "train_rank_2x2",
                "train_rank_4x1"):
        row = summary[f"moe_ffn/{tag}"]
        if row["path"] == "wgmma":
            wg[tag] = {k: row[k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "device_us", "bound_share")}
    check(wg["launches"] > 0 and wg["swa_launches"] > 0,
          "the wgmma kernels never ran on the train or swa path")
    emit({"kernels": kernels})
    emit({"timing": {"phase_s": dict(PHASE_S),
                     "gloo_worlds": sum(GLOO_WORLDS.values()),
                     "gloo_worlds_by_phase": dict(GLOO_WORLDS),
                     "total_s": time.perf_counter() - start}})
    print("\n".join(_cards()), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
