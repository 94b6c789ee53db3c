#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--src DIR]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. It imports the port (``src/repro_torch``, or ``DIR/repro_torch``
with ``--src``, e.g. an unpacked parent commit, so that one call can
compare two versions on one card) and nothing of the JAX package, and
runs six phases, each printing one JSON line:

1. ``build``   — compile the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel) into the ignored build dir.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card at the serving path's full-width shapes, at every row-tile
   boundary of K1 (C = 1 … 64), at ragged edges and the router's limits
   and at many-block router shapes (T = 1000, 4096); check that K1 gives
   the same bytes twice and under a permutation of its slots, and that
   K2's statistics are bit-equal from call to call; time kernel, plain
   version and one library call with CUDA events, and the kernels alone
   with torch.profiler, next to the card's bound for the same work.
3. ``parity``  — granite-moe-3b-a800m at full width, 2 layers, fp32: the
   engine on the card (kernels) and on the CPU (plain versions), same
   seeded weights and placement, must give equal greedy tokens.
4. ``serve``   — full granite-moe-3b-a800m (32 layers, bf16, seeded random
   weights, paged KV, max_batch 8) serves 8 requests under a seeded
   non-identity placement in the engine's default ``decode_mode="scan"``
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

Then it prints the ``kernels`` summary line, the card's name and power
limit, and as its last line ``{"ok": true, "device": …}``. Any failed check
raises and the script exits non-zero. TF32 is off for matmuls and cuDNN:
fp32 products are full fp32.
"""
from __future__ import annotations

import argparse
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


def device_us(fn, iters: int = 20) -> tuple[float, float]:
    """Device time of one call of ``fn`` (µs): of the port kernels it
    launches, summed over them, and of all its device work (the plain
    reductions around a kernel included). torch.profiler over ``iters``
    calls; fails when the trace holds no port kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    port = sum(e.self_device_time_total for e in dev if _is_port_kernel(e.key))
    check(port > 0, "profile: no port kernel in the trace")
    every = sum(e.self_device_time_total for e in dev)
    return port / iters, every / iters


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
    ]
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
        if tag in ("decode", "prefill"):
            x, wg, wu, wd = args

            def library():
                h = torch.nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)
                return torch.bmm(h, wd)

            el = x.element_size()
            nbytes = (2 * x.numel() + wg.numel() + wu.numel() + wd.numel()) * el
            b_ms, b_by = bound(nbytes, 2.0 * s * c * d * f * 3, dtype)
            row.update(
                ms=time_ms(lambda: ops.moe_ffn(*args), 50),
                plain_ms=time_ms(lambda: moe_ffn_ref(*args), 20),
                library_ms=time_ms(library, 50),
                bound_ms=b_ms, bound_by=b_by,
            )
            row["device_us"], row["call_device_us"] = device_us(
                lambda: ops.moe_ffn(*args))
            row["bound_share"] = b_ms / (row["device_us"] / 1e3)
            summary[f"moe_ffn/{tag}"] = row
        rows.append(row)

    router_cases = [("decode", 8, E, k), ("prefill", 128, E, k),
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
            if tag in ("decode", "prefill"):
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
                row["device_us"], row["call_device_us"] = device_us(kernel)
                row["bound_share"] = b_ms / (row["device_us"] / 1e3)
                summary[f"{name}/{tag}"] = row
            rows.append(row)
    emit({"phase": "kernels", "cases": rows})
    return summary


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
               logits=None):
    """One full-granite run of ``requests``; checks what every run must
    hold and returns (engine, tokens, launch counts, its JSON row)."""
    from repro_torch.kernels import ops

    L = cfg.num_layers
    eng = _serve(params, cfg, ecfg, "cuda", e2s, requests)
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
    check(len(done) == len(requests), f"serve {tag}: not all finished")
    check(all(len(r.generated) == new_tokens for r in done),
          f"serve {tag}: wrong token counts")
    calls = L * (eng.prefill_count + eng.decode_count)
    check(counts["moe_ffn"] == calls and counts["topk_router_stats"] == calls,
          f"serve {tag}: launches {counts} != {calls}")
    per_layer = eng.expert_counts.sum(axis=1)
    check(bool((per_layer == ecfg.max_batch * cfg.experts_per_token).all()),
          f"serve {tag}: expert counts {per_layer}")
    scan = ecfg.decode_mode == "scan"
    check(eng.graph_capture_counts == {"decode": int(scan), "prefill": 0,
                                       "migrate": 0},
          f"serve {tag}: capture counts {eng.graph_capture_counts}")
    check(_counters_at_zero(), f"serve {tag}: a K2 arrival counter is not 0")
    step_ms = [s.elapsed_time(e) for _, s, e in events]
    median = statistics.median(step_ms)
    row = {
        "phase": "serve", "placement": tag, "decode_mode": ecfg.decode_mode,
        "layers": L, "dtype": "bfloat16",
        "requests": len(done), "new_tokens": new_tokens,
        "prefills": eng.prefill_count, "decode_steps": eng.decode_count,
        "launches": counts, "graph_capture_counts": eng.graph_capture_counts,
        "graph_pool_mib": (eng.decode_graph.pool_bytes / 2 ** 20
                           if scan else None),
        "decode_step_ms_median": median,
        "decode_step_ms_min": min(step_ms),
        "decode_only_tokens_per_s": ecfg.max_batch / (median / 1e3),
        "tokens_per_s": len(done) * new_tokens / wall, "wall_s": wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    return eng, {r.uid: r.generated for r in done}, counts, row


def phase_serve(summary):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig

    cfg = get_config(ARCH)
    L = cfg.num_layers
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
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
    run, from the ``kernels`` phase: K1 at the prefill shape and K3."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
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
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_us": row["device_us"], "bound_share": row["bound_share"],
            "shape": row["shape"],
        })
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
