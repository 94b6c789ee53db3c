#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--src DIR]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. It imports the port (``src/repro_torch``, or ``DIR/repro_torch``
with ``--src``, e.g. an unpacked parent commit, so that one call can
compare two versions on one card) and nothing of the JAX package, and
runs eleven phases, each printing JSON lines:

1. ``build``   — compile the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel) into the ignored build dir.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card at the serving path's full-width shapes, at every row-tile
   boundary of K1 (C = 1 … 64), at ragged edges and the router's limits
   and at many-block router shapes (T = 1000, 4096); check that K1 gives
   the same bytes twice and under a permutation of its slots, and that
   K2's statistics are bit-equal from call to call; time kernel, plain
   version and one library call with CUDA events, and the kernels alone
   with torch.profiler, next to the card's bound for the same work. K1 is
   also held and timed at the replicated pool's S = 84 slots (decode C =
   3, prefill C = 2) and at Mixtral-8x7B's shapes, (16, 4, 4096)×(16,
   4096, 7168) at decode and C = 1,279 for the ``swa`` phase's longest
   prompt, and K2 at Mixtral's (8, 8) and (4,090, 8), k 2.
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
6. ``replan``  — GEM's one-shot control plane at full granite (32 layers,
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
7. ``online`` — GEM's online plane at full granite (32 layers, bf16,
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
8. ``replicated`` — the shed scenario at full granite (32 layers, bf16,
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
9. ``swa`` — Mixtral-8x7B at its published width and 4,096-token sliding
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
10. ``families`` — the eight configs without MoE layers (qwen1.5-4b,
   qwen2.5-14b, qwen3-32b, gemma-7b, mamba2-1.3b, zamba2-1.2b,
   musicgen-medium, internvl2-76b) at full width, bf16, whole depth for
   mamba2, zamba2, qwen1.5 and musicgen and 4 layers for the others (to
   bound the card's time): 4 requests of 16 new tokens in ``"scan"`` and
   ``"python"``, tokens equal, one capture, no port kernel launched (no
   MoE layer); then each at 2 layers (zamba2: 7, one stage and the shared
   block), fp32, card tokens equal the CPU's. It prints the decode-step
   medians.
11. ``train`` — full granite-moe-3b-a800m (32 layers, bf16 parameters,
   fp32 moments, seed-0 weights, a seeded non-identity placement) through
   the port's training launcher (``repro_torch.launch.train``): 20 AdamW
   steps of 4 × 128 tokens from the synthetic stream at capacity factor
   2.0 (C = 205), through K1/K2 forward and their ``torch.autograd.
   Function`` backwards. It checks that every loss and grad norm is
   finite, that the last loss is below the first, that each step's
   expert counts sum to 512 × 8 a layer, and that K1 and K2 launched
   32 × 20 times and K3 never. It prints the step time (CUDA events at
   each step's end, median of steps 5–18), tokens/s, the median shares of
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

Then it prints the ``kernels`` summary line, the card's name and power
limit, and as its last line ``{"ok": true, "device": …}``. Any failed check
raises and the script exits non-zero. TF32 is off for matmuls and cuDNN:
fp32 products are full fp32.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
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


# CUDA kernel names of the port: K1 bf16 (tensor cores), K1 fp32 (and K1
# bf16 before the tensor-core redesign), K2/K3
PORT_KERNELS = ("ffn_mma_kernel", "grouped_gemm_kernel", "router_kernel")
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.int32: torch.int32}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


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
    emit({"phase": "build", "sources": list(_build.SOURCES),
          "seconds": round(time.perf_counter() - t0, 3)})


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


def phase_kernels():
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moe_ffn_ref, topk_router_ref

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
    rows = []
    tol = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
    summary = {}
    # bf16 at every row-tile boundary of the tensor-core kernel (8/16/32
    # token rows) plus the fp32 path and a ragged F
    ffn_cases = [
        ("decode", S, 4, D, F, torch.bfloat16),
        ("prefill", S, 32, D, F, torch.bfloat16),
        ("decode_fp32", S, 4, D, F, torch.float32),
        ("ragged_c1", S, 1, D, F, torch.bfloat16),
        ("ragged_c3", S, 3, D, F, torch.float32),
        ("ragged_c33", S, 33, D, F, torch.bfloat16),
        ("ragged_f96", 8, 4, D, 96, torch.float32),
        *((f"c{c}", S, c, D, F, torch.bfloat16)
          for c in (2, 5, 7, 8, 9, 16, 17, 64)),
        *((tag, S_rep, c, D, F, torch.bfloat16) for tag, c in c_rep.items()),
        *((tag, mS, c, mD, mF, torch.bfloat16) for tag, c in m_cap.items()),
        # the ``train`` phase's forward: 512 tokens at capacity factor 2.0
        ("train", S, c_train, D, F, torch.bfloat16),
    ]
    # loops of calls for the timings; the prefill shape takes milliseconds
    # a call (fp32 for the plain version)
    iters = {"mixtral_prefill": (10, 3, 10)}
    for tag, s, c, d, f, dtype in ffn_cases:
        args = _ffn_case(s, c, d, f, dtype, gen, dev)
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
               "dtype": str(dtype), "max_abs_err": abs_err, "rel_err": rel,
               "bit_equal_twice": True, "slot_permutation_exact": True}
        if tag in ("decode", "prefill", "train", *c_rep, *m_cap):
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

    router_cases = [("decode", 8, E, k), ("prefill", 128, E, k),
                    ("train", TRAIN_BATCH * TRAIN_SEQ, E, k),
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
            if tag in ("decode", "prefill", "train", "mixtral_decode",
                       "mixtral_prefill"):
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
    emit({"phase": "kernels", "cases": rows})
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


def phase_parity():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig

    cfg = dataclasses.replace(get_config(ARCH), num_layers=2)
    params = init_params(cfg, seed=1, device="cuda", dtype=torch.float32)
    s2e, e2s = _placement(cfg.num_layers, cfg.num_virtual_experts, seed=2)
    params = _with_placement(params, s2e)
    rng = np.random.default_rng(3)
    requests = [(rng.integers(0, cfg.vocab_size, size=int(n)), 8)
                for n in rng.integers(16, 41, size=4)]
    ecfg = EngineConfig(max_batch=4, max_len=64)
    torch.set_num_threads(8)
    tokens = {}
    for device, p in (("cuda", params), ("cpu", _to(params, "cpu"))):
        eng = _serve(p, cfg, ecfg, device, e2s, requests)
        t0 = time.perf_counter()
        done = eng.run()
        tokens[device] = {r.uid: r.generated for r in done}
        check(len(done) == len(requests), f"parity {device}: not all finished")
        emit({"phase": "parity", "device": device,
              "seconds": round(time.perf_counter() - t0, 3)})
    check(tokens["cuda"] == tokens["cpu"],
          f"parity: GPU tokens {tokens['cuda']} != CPU tokens {tokens['cpu']}")
    emit({"phase": "parity", "ok": True, "layers": cfg.num_layers,
          "dtype": "float32", "requests": len(requests), "tokens": tokens["cuda"]})
    phase_parity_shed()
    phase_parity_swa()


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
    check(counts["moe_ffn"] == calls and counts["topk_router_stats"] == calls,
          f"{phase} {tag}: launches {counts} != {calls}")
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
        "layers": L, "dtype": "bfloat16",
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


def _parent_draw(cfg, seed, dtype):
    """The weights as the parent commit drew them: each stacked weight
    whole in fp32 from one generator, scaled and cast, in
    ``init_params``' order (embed, attention, MoE)."""
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
    moe = {"router": normal((L, D, cfg.num_experts), s),
           "w_gate": normal((L, Ev, D, Fv), s), "w_up": normal((L, Ev, D, Fv), s),
           "w_down": normal((L, Ev, Fv, D), s_out)}
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
    emit({"phase": "serve", "ok": True, "placement_invariant": True})
    phase_graph(placed, cfg, ecfg, e2s, requests, new_tokens, scan, summary)
    return main_counts, serve_peak


def phase_graph(placed, cfg, ecfg, e2s, requests, new_tokens, scan, summary):
    """The serve phase's placed run again, in ``decode_mode="python"``:
    tokens equal, logits compared bit for bit, both modes' numbers side
    by side; then three profiled decode steps of each mode."""
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
    emit({"phase": "replan", "ok": True, "tokens_equal_linear": True,
          "rows_equal_plan": True, "linear_launches": lin_counts})
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
    emit({"phase": "online", "ok": True, "tokens_equal_linear": True,
          "rows_equal_placement": True, "tables_inverse": True,
          "batches": len(batches), "replans_applied": sorted(applied)})
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
    emit({"phase": "replicated", "ok": True, "slots": S,
          "rows_equal_layout": True, "tables_equal_replica_tables": True,
          "batches_checked": checked["batches"], "retargets_checked": 1})
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
    emit({"phase": "swa", "ok": True, "placement_invariant": True,
          "tokens_equal_python": True, "ring_wrapped": True,
          "decode_step_ms_median": {"scan": row["decode_step_ms_median"],
                                    "python": py_row["decode_step_ms_median"]},
          "decode_step_bound_ms": bound_ms,
          "decode_only_tokens_per_s": row["decode_only_tokens_per_s"],
          "graph_pool_bytes": row["graph_pool_bytes"],
          "prefill_s_total": row["prefill_s_total"],
          "peak_mem_gib": row["peak_mem_gib"]})
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
    emit({"phase": "families", "ok": True, "configs": list(FAMILIES),
          "decode_step_ms_median": medians})
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
          "share_median": {n: statistics.median(v) for n, v in parts.items()},
          "peak_mem_gib": peak / 2 ** 30, "wall_s": wall,
          "profile": profile_row})
    check(busy_us > 0, "train: the profiled step holds no device time")
    del history
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_parity()
    phase_train_resume()
    emit({"phase": "train", "ok": True, "loss_first": losses[0],
          "loss_last": losses[-1], "step_ms_median": step_ms})
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--src", type=Path, default=ROOT / "src",
        help="directory holding the repro_torch package to run (default: "
             "this checkout's src/)")
    args = parser.parse_args(argv)
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
    replan_launches = phase_replan(serve_peak)
    online_launches = phase_online(serve_peak)
    replicated_launches = phase_replicated(
        summary["serve_decode_step_ms_median"], serve_peak)
    gc.collect()
    torch.cuda.empty_cache()
    swa_launches = phase_swa()
    families_launches = phase_families()
    train_launches = phase_train()

    sources = {
        "moe_ffn": ("src/repro_torch/kernels/csrc/moe_ffn.cu",
                    "src/repro/kernels/moe_gemm.py:50"),
        "topk_router_stats": ("src/repro_torch/kernels/csrc/topk_router.cu",
                              "src/repro/kernels/topk_router.py:63"),
        "topk_router": ("src/repro_torch/kernels/csrc/topk_router.cu",
                        "src/repro/kernels/topk_router.py:56"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        row = summary[f"{name}/decode"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "replan_launches": replan_launches[name],
            "online_launches": online_launches[name],
            "replicated_launches": replicated_launches[name],
            "swa_launches": swa_launches[name],
            "families_launches": families_launches[name],
            "train_launches": train_launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_us": row["device_us"], "bound_share": row["bound_share"],
            "shape": row["shape"],
        })
    s84 = summary["moe_ffn/decode_s84"]
    kernels[0]["replicated_pool"] = {
        k: s84[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                            "library_ms", "bound_ms", "bound_by",
                            "device_us", "bound_share")}
    for i, name in ((0, "moe_ffn"), (1, "topk_router_stats")):
        kernels[i]["train"] = {
            k: summary[f"{name}/train"][k]
            for k in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                      "bound_ms", "bound_by", "device_us", "bound_share")}
    for i, name in ((0, "moe_ffn"), (1, "topk_router_stats")):
        for tag in ("mixtral_decode", "mixtral_prefill"):
            row = summary[f"{name}/{tag}"]
            kernels[i][tag] = {
                k: row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by",
                                    "device_us", "bound_share")}
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
