"""Dry run: every (arch × shape) step on the meta device, on one card.

    python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--out results/dryrun_torch.json]

The port of ``repro/launch/dryrun.py``. The JAX dry run lowers and compiles
each cell against a 512-device TPU mesh; this one runs the port's own step
functions once on ``torch.device("meta")`` (shapes only: no card, no
allocation, no arithmetic) under :func:`repro_torch.launch.cost.trace_cost`,
at the full width and depth of every config and the shapes of
:data:`repro_torch.configs.SHAPES`, on one card with no mesh. The MoE
layers take the plain versions of the kernels there (the same shapes);
train steps recompute each layer in the backward (``remat=True``), as the
JAX dry run's do.

Per cell it records:

* ``memory`` — the bytes of the parameters, of their gradients and AdamW
  moments (train), of the dense decode caches (decode) and of the batch,
  and the step's ``peak_bytes`` (live storages, inputs included);
* ``fits_hbm`` — whether the peak fits the card: this machine's
  ``total_memory`` when a CUDA device is present, else the 80 GB of the
  H100 data sheet; ``hbm_bytes`` and ``hbm_source`` say which;
* ``cost`` — the step's matrix-product ``flops`` and eager ``bytes``
  (:mod:`repro_torch.launch.cost` says what each leaves out);
* ``host_s`` — the host seconds of the trace.

``status`` is ``ok``, ``skipped`` (with :func:`shape_applicable`'s reason)
or ``error`` (with the traceback: a failing cell is a bug to fix, not to
hide). Results go to ``--out``, keyed ``arch|shape|1xgpu``; the exit code
is 1 when any cell errs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..configs.base import ModelConfig, ShapeSpec
from ..tree import leaves
from .cost import trace_cost, tree_bytes
from .specs import input_specs

__all__ = ["build_step_fn", "measure", "run_cell", "main", "H100_HBM_BYTES"]

MESH = "1xgpu"
H100_HBM_BYTES = 80 * 10**9  # H100 SXM data sheet: 80 GB


def build_step_fn(config: ModelConfig, shape: ShapeSpec, *,
                  remat: bool = True):
    """(step function taking :func:`input_specs`' keywords, the names of
    the arguments it updates in place)."""
    from ..models.model import decode_step, prefill
    from ..training.optimizer import AdamWConfig
    from ..training.train_step import make_train_step

    if shape.kind == "train":
        ts = make_train_step(config, AdamWConfig(), remat=remat)

        def train_fn(state, batch, placements=None):
            return ts(state, batch, placements)

        return train_fn, ("state",)
    if shape.kind == "prefill":
        def prefill_fn(params, batch, placements=None):
            with torch.no_grad():
                return prefill(params, batch["tokens"], config, placements,
                               patches=batch.get("patches"))

        return prefill_fn, ()
    if shape.kind == "decode":
        def decode_fn(params, caches, cur_len, tokens, placements=None):
            with torch.no_grad():
                return decode_step(params, caches, cur_len, tokens, config,
                                   placements)

        return decode_fn, ("caches",)
    raise ValueError(shape.kind)


def _hbm() -> tuple[int, str]:
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return int(props.total_memory), f"cuda:0 total_memory ({props.name})"
    return H100_HBM_BYTES, "H100 data sheet (80 GB)"


def _memory_of(kwargs: dict, kind: str) -> dict[str, int]:
    """The input bytes of a step by part: params, grads (train: one per
    parameter, in its dtype), moments (train: AdamW's ``mu`` and ``nu``;
    the host-side step count left out), caches (decode) and batch (the
    rest: tokens, labels, patches, mask, lengths, tables)."""
    if kind == "train":
        params = kwargs["state"]["params"]
        opt = kwargs["state"]["opt"]
        moments = tree_bytes([opt["mu"], opt["nu"]])
    else:
        params, moments = kwargs["params"], 0
    p_bytes = tree_bytes(leaves(params))
    caches = tree_bytes(leaves(kwargs.get("caches", {})))
    rest = {k: v for k, v in kwargs.items()
            if k not in ("state", "params", "caches")}
    return {
        "params_bytes": p_bytes,
        "grads_bytes": p_bytes if kind == "train" else 0,
        "moments_bytes": moments,
        "caches_bytes": caches,
        "batch_bytes": tree_bytes(rest),
    }


def measure(config: ModelConfig, shape: ShapeSpec, *,
            remat: bool = True) -> dict:
    """One step of ``config`` at ``shape`` on meta: ``memory`` (with
    ``peak_bytes``), ``cost`` (``flops``, ``bytes``, ``ops``) and
    ``host_s``."""
    t0 = time.perf_counter()
    kwargs = input_specs(config, shape)
    memory = _memory_of(kwargs, shape.kind)
    fn, _ = build_step_fn(config, shape, remat=remat)
    out, cost = trace_cost(fn, **kwargs)
    del out
    memory["peak_bytes"] = cost.pop("peak_bytes")
    return {"memory": memory, "cost": cost,
            "host_s": time.perf_counter() - t0}


def run_cell(arch: str, shape: str | ShapeSpec, *,
             config: ModelConfig | None = None, remat: bool = True,
             hbm: tuple[int, str] | None = None) -> dict:
    """The dry run of one cell: ``arch``'s config (or ``config``, e.g. a
    cut one) at ``shape`` (a name of :data:`SHAPES`, or a ShapeSpec).
    ``hbm``: (bytes, source) to hold the peak against, instead of asking
    the CUDA device (or the data sheet without one)."""
    config = config or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cell: dict = {"arch": arch, "shape": shape.name, "mesh": MESH}
    ok, why = shape_applicable(config, shape)
    if not ok:
        cell.update(status="skipped", reason=why)
        return cell
    try:
        m = measure(config, shape, remat=remat)
        hbm, source = hbm or _hbm()
        cell.update(
            status="ok", remat=remat if shape.kind == "train" else None,
            memory=m["memory"], cost=m["cost"], host_s=m["host_s"],
            fits_hbm=m["memory"]["peak_bytes"] <= hbm, hbm_bytes=hbm,
            hbm_source=source,
        )
    except Exception as e:  # a failing cell is a bug to fix, not to hide
        cell.update(
            status="error",
            error=f"{type(e).__name__}: {e}",
            traceback=traceback.format_exc()[-2000:],
        )
    return cell


def cell_line(key: str, cell: dict) -> str:
    status = cell["status"]
    extra = ""
    if status == "ok":
        gb = cell["memory"]["peak_bytes"] / 1e9
        extra = (f" host={cell['host_s']:.2f}s peak={gb:.2f}GB "
                 f"fits={cell['fits_hbm']} "
                 f"tflop={cell['cost']['flops'] / 1e12:.3f}")
    elif status == "skipped":
        extra = " " + cell["reason"]
    else:
        extra = " " + cell["error"][:160]
    return f"[{status:7s}] {key}{extra}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    n_err = 0
    t0 = time.perf_counter()
    for arch, shape in cells:
        key = f"{arch}|{shape}|{MESH}"
        cell = run_cell(arch, shape)
        results[key] = cell
        n_err += cell["status"] == "error"
        print(cell_line(key, cell), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"{len(cells)} cells in {time.perf_counter() - t0:.1f}s host, "
          f"{n_err} errors", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
