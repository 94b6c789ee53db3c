"""One run of one cell: set-up, the measured window, the check, and the
result line (the last line of standard output).

A cell's kind (its traffic file's ``kind``) names the module that runs it,
``bench/<kind>.py``. That module gives ``setup(cell, *, seed, device,
t_origin, log)``, ``window(state, *, seconds, trace, log, rate=None,
finish=False)`` and ``judge(cell, state, w, *, seed, device, log,
control=False)``; ``window`` returns at least ``run`` (what the metric
readers read), ``attempted`` and ``memory_peak_bytes``, and ``judge``
returns ``correct``, ``failed`` and ``checks`` (each number compared, with
its limit), and with ``control`` also ``control_correct``: the verdict of
the same comparison with the control in the program's place. A new kind
of cell is a new module, and edits none."""
from __future__ import annotations

import argparse
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # measurements made while defining a cell (the control's verdict, the
    # knee sweep); a cell's scored runs pass neither
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also judge the float8 control in the program's "
                         "place (its verdict has to be false)")
    ap.add_argument("--rates", default="",
                    help="comma-separated arrival rates: one window each "
                         "after one set-up, no check (a knee sweep)")
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def kind_module(kind: str):
    """``bench/<kind>.py``, or None where there is no such kind."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", kind) or kind == "cli":
        return None
    if not (Path(__file__).parent / f"{kind}.py").exists():
        return None
    mod = importlib.import_module(f"{__package__}.{kind}")
    if not all(callable(getattr(mod, f, None))
               for f in ("setup", "window", "judge")):
        return None
    return mod


def _metrics(defs, run) -> dict:
    out = {}
    for m in defs:
        v = m.read(run)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out


def _sweep(kind, cell, state, rates, seconds) -> None:
    """One window a rate, read by the cell's own end-to-end readers (and
    the median time to first token beside them): the knee's sweep."""
    from ..yardstick.stats import percentile

    for rate in rates:
        w = kind.window(state, seconds=seconds, trace=False, rate=rate,
                        finish=True, log=log)
        run = w["run"]
        line = {"rate": rate, "due": len(run.requests), "steps": len(run.steps),
                "ttft_p50_ms": percentile(
                    [(r.first - r.due) * 1e3 for r in run.requests], 50),
                "offered_tokens_per_s": sum(
                    r.spec.max_new_tokens + 1 for r in run.requests) / seconds}
        line.update({k: v["value"]
                     for k, v in _metrics(cell.end_to_end, run).items()})
        print(json.dumps(line), flush=True)


def main(args: argparse.Namespace, t_origin: float) -> int:
    import torch

    from . import spec
    from .trace import breakdown, busy

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    kind = kind_module(cell.traffic["kind"])
    if kind is None:
        log(f"unknown cell kind {cell.traffic['kind']!r}")
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    log(f"card: {card_power_limit()}")
    state = kind.setup(cell, seed=args.seed, device=device,
                       t_origin=t_origin, log=log)
    if args.rates:
        _sweep(kind, cell, state, [float(r) for r in args.rates.split(",")],
               args.seconds)
        return 0
    w = kind.window(state, seconds=args.seconds, trace=bool(args.trace),
                    log=log)
    run = w["run"]
    metrics = _metrics(cell.per_layer if args.trace else cell.end_to_end, run)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": 1, "memory_peak_bytes": w["memory_peak_bytes"]}
    result_extra = {}
    if args.trace:
        if run.trace is None or run.trace["window"] is None:
            log("the profiler gave no trace of the window")
            return 4
        b, win = busy(run.trace)
        device_info.update(busy_s=b, window_s=win)
        result_extra["breakdown"] = breakdown(run.trace)
        log(f"K1/K2 launches in the slice: {run.trace['launches']}")

    verdict = kind.judge(cell, state, w, seed=args.seed, device=device,
                         log=log, control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        log(f"modules that must not load were loaded: {bad}")
        return 3
    if "control_correct" in verdict:
        result_extra["control_correct"] = verdict["control_correct"]
        log(f"control_correct: {verdict['control_correct']} (has to be false)")
    checks = verdict["checks"]
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    result = {"correct": verdict["correct"], "attempted": w["attempted"],
              "failed": verdict["failed"], "metrics": metrics,
              "device": device_info, **result_extra, "checks": checks}
    print(json.dumps(result), flush=True)
    return 0
