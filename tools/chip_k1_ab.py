#!/usr/bin/env python3
"""Two checkouts of the port on one card, in turns: K1's bits and two times.

    python3 tools/chip_k1_ab.py --parent DIR [--order pccp] [--timeout SECONDS]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. ``DIR`` is the root of another checkout (e.g. the parent commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists). Each
turn is a child process that puts one checkout's ``src/`` and root first on
``sys.path`` and imports that checkout's own ``chip_smoke.py`` (so each
version runs its own phases), then:

1. ``phase_build()`` and K1 (``repro_torch.kernels.ops.moe_ffn``) at the
   shapes in ``K1_CASES``, on inputs drawn on the CPU from fixed seeds (the
   same bytes in every turn); the outputs are saved for the parent process;
2. ``phase_swa()`` (Mixtral-8x7B, 16 layers, 4k prompts) and
   ``phase_train()`` (full granite, 20 steps), whose JSON lines give each
   prefill's seconds and the train step's median.

The parent process compares the first parent turn's K1 outputs with the
first change turn's bit for bit (|delta| where they differ), and each
version with its own repeat, and prints each turn's prefill seconds and
step median. ``--order`` is a string of ``p`` and ``c`` (default ``pccp``).
The card's name and power limit come before the last line, a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (tag, S, C, D, F, dtype): granite's decode and C <= 32 tiles, fp32, Mixtral's
# decode (unchanged paths), then the large-C shapes the wgmma path takes over
K1_CASES = [
    ("decode", 80, 4, 1536, 256, "bfloat16"),
    *((f"c{c}", 80, c, 1536, 256, "bfloat16") for c in (1, 5, 8, 16, 17, 32)),
    ("decode_fp32", 80, 4, 1536, 256, "float32"),
    ("c33_fp32", 80, 33, 1536, 256, "float32"),
    ("mixtral_decode", 16, 4, 4096, 7168, "bfloat16"),
    ("c52", 80, 52, 1536, 256, "bfloat16"),
    ("c64", 80, 64, 1536, 256, "bfloat16"),
    ("train", 80, 205, 1536, 256, "bfloat16"),
    ("mixtral_prefill", 16, 1279, 4096, 7168, "bfloat16"),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def child(root: Path, out: Path) -> int:
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_build()
    from repro_torch.kernels import ops

    outs = {}
    for i, (tag, S, C, D, F, dtype) in enumerate(K1_CASES):
        g = torch.Generator().manual_seed(1000 + i)
        dt = getattr(torch, dtype)
        x = torch.randn((S, C, D), generator=g).to(dt)
        ws = [(torch.randn(shape, generator=g) * scale).to(dt)
              for shape, scale in (((S, D, F), D ** -0.5), ((S, D, F), D ** -0.5),
                                   ((S, F, D), (2 * F) ** -0.5))]
        y = ops.moe_ffn(*(t.cuda() for t in (x, *ws)))
        torch.cuda.synchronize()
        outs[tag] = y.cpu()
        del x, ws, y
    torch.save(outs, out)
    chip_smoke.phase_swa()
    chip_smoke.phase_train()
    return 0


def _turn(root: Path, out: Path, timeout: float) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, "--child", str(root), "--out", str(out)],
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
        raise SystemExit(f"chip_k1_ab: the turn of {root} failed")
    res = {"prefill_s": None, "train_step_ms_median": None}
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        row = json.loads(line)
        if row.get("phase") == "swa" and row.get("placement") == "placed" \
                and row.get("decode_mode") == "scan":
            res["prefill_s"] = row["prefill_s"]
            res["swa_decode_step_ms_median"] = row["decode_step_ms_median"]
        if row.get("phase") == "train" and row.get("ok"):
            res["train_step_ms_median"] = row["step_ms_median"]
        if row.get("phase") == "build":
            res["build_s"] = row["seconds"]
    return res


def _compare(a: dict, b: dict) -> dict:
    import torch

    out = {}
    for tag in a:
        x, y = a[tag], b[tag]
        bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype]
        d = (x.float() - y.float()).abs()
        out[tag] = {"bit_equal": bool(torch.equal(x.view(bits), y.view(bits))),
                    "max_abs_delta": d.max().item(),
                    "differing_share": (d > 0).float().mean().item()}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", type=Path, help="root of the other checkout")
    p.add_argument("--order", default="pccp")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds a turn may take")
    p.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    p.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child is not None:
        return child(args.child.resolve(), args.out)
    import torch

    if not torch.cuda.is_available():
        print("chip_k1_ab: no CUDA device", file=sys.stderr)
        return 1
    roots = {"p": args.parent.resolve(), "c": ROOT}
    tmp = Path(tempfile.mkdtemp(prefix="k1_ab_"))
    seen, first = {"p": 0, "c": 0}, {}
    for i, v in enumerate(args.order):
        out = tmp / f"{i}_{v}.pt"
        res = _turn(roots[v], out, args.timeout)
        seen[v] += 1
        emit({"phase": "turn", "version": {"p": "parent", "c": "change"}[v],
              "n": seen[v], **res})
        outs = torch.load(out)
        out.unlink()
        if v in first:
            emit({"phase": "k1_repeat", "version": v,
                  "cases": _compare(first[v], outs)})
            continue
        first[v] = outs
        if len(first) == 2:
            emit({"phase": "k1_parent_vs_change",
                  "cases": _compare(first["p"], first["c"])})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    emit({"ok": True, "order": args.order})
    return 0


if __name__ == "__main__":
    sys.exit(main())
