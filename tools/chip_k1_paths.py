#!/usr/bin/env python3
"""K1's two bf16 paths side by side on the card: where the threshold sits.

    python3 tools/chip_k1_paths.py [--quick] [--timeout SECONDS]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. It builds ``src/repro_torch/kernels/csrc/moe_ffn.cu`` three times
with ``nvcc``, in parallel, into ``src/repro_torch/kernels/build/paths/``:
as the port builds it, and with ``MOE_FFN_WGMMA_MIN_C`` defined so that
every bf16 call takes the wgmma/TMA kernels (1) or none does (2**30). It
prints what ``ptxas -v`` says of the port's build (registers, spills),
then calls each library's ``moe_ffn_launch`` through ``ctypes``:

1. ``check``: at ragged and boundary shapes, each variant against the
   plain PyTorch version (relative error <= 1e-2), the same bytes twice,
   under a permutation of the slots, and a call's first rows equal to the
   same rows of a larger-C call; the two paths' |delta| on the same inputs.
2. ``sweep``: CUDA-event times (median of 5 loops) of both paths and of
   one library call (``torch.bmm`` x3 + silu) at granite's (80, C, 1536,
   256) and Mixtral-8x7B's (16, C, 4096, 7168) widths over a range of C,
   beside the card's bound for the work, and the wgmma kernels' device
   µs (torch.profiler) by launch (gate/up, down).
3. ``depth``: the wgmma gate/up at Mixtral's prefill tile count over
   depths K = D of 256 … 4,096, and a line through its device µs: the
   mainloop's µs a k step against the bf16 peak's, and the fixed µs a
   launch (prologue, pipeline fill, epilogue) left at K = 4,096.

The work runs in a child process with a time limit, so that a kernel that
never finishes is killed and reported rather than holding the card. The
last line is a JSON summary; the card's name and power limit come before.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"port": None, "wgmma": 1, "mma": 1 << 30}
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
# granite's gate/up and down at a few C, Mixtral's at decode-to-prefill C
SWEEP = [(80, c, 1536, 256) for c in (33, 40, 48, 52, 56, 64, 80, 96, 103,
                                      128, 205)] + [
    (20, 205, 1536, 256), (40, 103, 1536, 256)] + [
    (16, c, 4096, 7168) for c in (33, 48, 64, 96, 128, 256, 1279)]
DEPTHS = (256, 512, 1024, 2048, 4096)
QUICK_SWEEP = [(80, 52, 1536, 256), (80, 205, 1536, 256),
               (16, 1279, 4096, 7168)]
CHECK = [(3, 1, 128, 128), (2, 33, 128, 256), (3, 64, 256, 256),
         (2, 65, 256, 384), (4, 130, 520, 264), (2, 128, 1536, 256),
         (5, 205, 1536, 256), (3, 300, 4096, 7168)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(alts: dict) -> dict:
    """Build each variant (in parallel); its library path. ``alts`` maps a
    name to a directory holding another ``moe_ffn.cu`` (and its headers),
    built with every bf16 call on the wgmma path."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out_dir = _build.BUILD / "paths"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: (_build.CSRC, n) for name, n in VARIANTS.items()}
    sources.update({name: (Path(d), 1) for name, d in alts.items()})
    procs, libs = {}, {}
    t0 = time.perf_counter()
    for name, (csrc, n) in sources.items():
        lib = out_dir / f"libmoe_ffn-{name}.so"
        libs[name] = lib
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               *([f"-DMOE_FFN_WGMMA_MIN_C={n}"] if n is not None else []),
               "-o", str(lib), str(csrc / "moe_ffn.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, flush=True)
            raise SystemExit(f"nvcc failed for the {name} variant")
        if name == "port" or name in alts:
            for line in log.splitlines():
                if "ffn_wgmma" in line or "registers" in line or "spill" in line \
                        or "warning" in line.lower():
                    print(f"ptxas {name}:", line.strip(), flush=True)
    emit({"phase": "build", "variants": list(procs),
          "seconds": round(time.perf_counter() - t0, 3)})
    return libs


def child(quick: bool, alts: dict) -> int:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ref import moe_ffn_ref

    libs = build(alts)
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.moe_ffn_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        lib.moe_ffn_wgmma_min_c.restype = ctypes.c_int
        if name == "port":
            min_c = int(lib.moe_ffn_wgmma_min_c())
    emit({"phase": "setup", "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "wgmma_min_c": min_c})
    dev = torch.device("cuda")

    def call(name, x, wg, wu, wd):
        S, C, D = x.shape
        F = wg.shape[-1]
        h = torch.empty((S, C, F), dtype=x.dtype, device=dev)
        y = torch.empty_like(x)
        err = fns[name](x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                        h.data_ptr(), y.data_ptr(), S, C, D, F, 1,
                        torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: moe_ffn_launch returned {err}")
        return y

    def inputs(S, C, D, F, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)

        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev) * scale).to(
                torch.bfloat16)

        return (randn(S, C, D), randn(S, D, F, scale=D ** -0.5),
                randn(S, D, F, scale=D ** -0.5), randn(S, F, D, scale=(2 * F) ** -0.5))

    def bits(t):
        return t.view(torch.int16)

    ok = True
    checks = CHECK[:4] + CHECK[-2:] if quick else CHECK
    for S, C, D, F in checks:
        args = inputs(S, C, D, F, seed=C)
        want = moe_ffn_ref(*args)
        row = {"phase": "check", "shape": [S, C, D, F]}
        outs = {}
        for name in ("wgmma", "mma", *alts):
            got = call(name, *args)
            again = call(name, *args)
            perm = torch.randperm(S, device=dev)
            permuted = call(name, *(t[perm].contiguous() for t in args))
            half = max(C // 2, 1)
            prefix = call(name, args[0][:, :half].contiguous(), *args[1:])
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs().max().item()
            rel = diff / max(want.float().abs().max().item(), 1e-30)
            res = {"rel_err": rel,
                   "finite": bool(torch.isfinite(got.float()).all()),
                   "twice": bool(torch.equal(bits(got), bits(again))),
                   "perm": bool(torch.equal(bits(permuted), bits(got[perm]))),
                   "rows": bool(torch.equal(bits(prefix), bits(got[:, :half])))}
            res["ok"] = (rel <= 1e-2 and res["finite"] and res["twice"]
                         and res["perm"] and res["rows"])
            if not res["ok"]:
                bad = (got.float() - want.float()).abs() > 1e-2 * want.float().abs().max()
                idx = bad.nonzero()[:8].tolist()
                res["first_bad"] = idx
            ok &= res["ok"]
            row[name] = res
            outs[name] = got
        d = (outs["wgmma"].float() - outs["mma"].float()).abs()
        row["paths_abs_delta"] = d.max().item()
        row["paths_differing_share"] = (d > 0).float().mean().item()
        emit(row)
        del args, want, outs

    sweep = QUICK_SWEEP if quick else SWEEP

    def time_ms(fn, iters):
        for _ in range(3):
            fn()
        loops = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            torch.cuda.synchronize()
            loops.append(a.elapsed_time(b) / iters)
        return statistics.median(loops)

    def kernel_us(fn, iters=10):
        """Device µs a call by kernel (torch.profiler): gate/up, down."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                name = ("gate_up" if "kernel<true" in e.key else
                        "down" if "kernel<false" in e.key else e.key[:40])
                out[name] = e.self_device_time_total / iters
        return out

    for S, C, D, F in sweep:
        args = inputs(S, C, D, F, seed=7)
        x, wg, wu, wd = args
        iters = 10 if S * C * D * F > 1e11 else 50
        nbytes = (2 * x.numel() + wg.numel() + wu.numel() + wd.numel()) * 2
        ops = 6.0 * S * C * D * F
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3

        def library():
            h = torch.nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)
            return torch.bmm(h, wd)

        row = {"phase": "sweep", "shape": [S, C, D, F], "bound_ms": bound_ms,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
               >= ops / BF16_OPS_PER_S else "operations"}
        # turns: mma, wgmma, (alternatives), then back, then the library
        names = ["mma", "wgmma", *alts]
        t = {name: [] for name in names}
        for name in names + names[::-1]:
            t[name].append(time_ms(lambda: call(name, *args), iters))
        row["library_ms"] = time_ms(library, iters)
        for name in names:
            row[f"{name}_ms"] = t[name]
            row[f"{name}_share"] = bound_ms / min(t[name])
        for name in ["wgmma", *alts]:
            row[f"{name}_device_us"] = kernel_us(lambda: call(name, *args))
        emit(row)
        del args, x, wg, wu, wd
    # where the wgmma kernel's time goes: gate/up at Mixtral's tile count
    # (16 slots x 10 M tiles x 56 N tiles) over a range of depths K = D.
    # A least-squares line through (k steps, device µs) gives the mainloop's
    # time a k step across the card and the fixed cost a launch (prologue,
    # pipeline fill, epilogue, waves); one k step of all 8,960 tiles is
    # 37.6 GFLOP, 38 µs at the bf16 peak.
    pts = []
    for D in DEPTHS:
        args = inputs(16, 1279, D, 7168, seed=11)
        us = kernel_us(lambda: call("wgmma", *args))["gate_up"]
        pts.append((D // 64, us))
        emit({"phase": "depth", "shape": [16, 1279, D, 7168], "k_steps": D // 64,
              "gate_up_device_us": us})
        del args
    n = len(pts)
    mx = sum(x for x, _ in pts) / n
    my = sum(y for _, y in pts) / n
    slope = (sum((x - mx) * (y - my) for x, y in pts)
             / sum((x - mx) ** 2 for x, _ in pts))
    peak_us = 2.0 * 16 * 10 * 128 * 56 * 256 * 64 / BF16_OPS_PER_S * 1e6
    emit({"phase": "depth_fit", "us_per_k_step": slope,
          "fixed_us": my - slope * mx, "peak_us_per_k_step": peak_us,
          "mainloop_share_of_peak": peak_us / slope,
          "fixed_share_at_4096": (my - slope * mx) / pts[-1][1]})
    emit({"phase": "done", "ok": ok})
    return 0 if ok else 1


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true",
                   help="fewer check shapes; sweep three shapes only")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds before the child is killed")
    p.add_argument("--alt", action="append", default=[], metavar="NAME=DIR",
                   help="also build DIR/moe_ffn.cu (its whole bf16 path on "
                        "wgmma) and check and time it beside the port's")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    alts = dict(a.split("=", 1) for a in args.alt)
    if args.child:
        return child(args.quick, alts)
    import torch

    if not torch.cuda.is_available():
        print("chip_k1_paths: no CUDA device", file=sys.stderr)
        return 1
    cmd = [sys.executable, __file__, "--child", *(["--quick"] if args.quick else []),
           *(f"--alt={a}" for a in args.alt)]
    try:
        rc = subprocess.run(cmd, timeout=args.timeout).returncode
    except subprocess.TimeoutExpired:
        print(f"chip_k1_paths: child killed after {args.timeout} s (hung?)",
              flush=True)
        rc = 124
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    emit({"ok": rc == 0, "rc": rc})
    return rc


if __name__ == "__main__":
    sys.exit(main())
