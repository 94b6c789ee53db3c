"""Dry run: every (arch × shape) step on the meta device, on one card or
one rank of JAX's production meshes.

    python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--out results/dryrun_torch.json]
    python -m repro_torch.launch.dryrun --all --mesh 16x16   # or 2x16x16
    python -m repro_torch.launch.dryrun --all --moe-backend dense_ref

The port of ``repro/launch/dryrun.py``. The JAX dry run lowers and compiles
each cell against a 512-device TPU mesh; this one runs the port's own step
functions once on ``torch.device("meta")`` (shapes only: no card, no
allocation, no arithmetic) under :func:`repro_torch.launch.cost.trace_cost`,
at the full width and depth of every config and the shapes of
:data:`repro_torch.configs.SHAPES`. The MoE layers take the plain versions
of the kernels there (the same shapes); train steps recompute each layer in
the backward (``remat=True``), as the JAX dry run's do.

``--mesh 1xgpu`` (the default) is one card with no mesh. ``--mesh 16x16``
and ``--mesh 2x16x16`` run rank 0 of JAX's production meshes: a
:class:`~repro_torch.launch.meta_mesh.MetaMesh` (no processes) under
``policy_for(mesh, step_kind=…, global_batch=…, config=…)``, as JAX's
``run_cell`` takes it, with the rank's inputs
(:func:`~repro_torch.launch.specs.input_specs` under the policy). The port's
step API takes the global batch on every rank (each rank reads its own
rows): the step is handed global meta stand-ins of it, made outside the
trace, so that only the rank's rows count as held; the prefill runs every
row on every rank (the engine prefills one request), so its rows are
all-gathered over the batch axes in the step.

Per cell it records:

* ``memory`` — the bytes of the parameters, of their gradients and AdamW
  moments (train), of the dense decode caches (decode) and of the batch,
  and the step's ``peak_bytes`` (live storages, inputs included);
* ``fits_hbm`` — whether the peak fits the card: this machine's
  ``total_memory`` when a CUDA device is present, else the 80 GB of the
  H100 data sheet; ``hbm_bytes`` and ``hbm_source`` say which;
* ``cost`` — the step's matrix-product ``flops`` and eager ``bytes``
  (:mod:`repro_torch.launch.cost` says what each leaves out);
* ``host_s`` — the host seconds of the trace;
* ``collectives`` (on a mesh) — the collectives the rank's step calls, by
  JAX's kind names: ``bytes`` (operands), ``counts``, ``total_bytes``
  and ``total_count`` (:func:`~repro_torch.launch.meta_mesh.
  record_collectives`). Every number of a mesh cell is one rank's.

``--moe-backend`` runs the MoE configs' cells under that data plane, as
JAX's ``--moe-backend`` lowers them (``"dense_ref"``: the capacity-free
oracle, whose trace counts every expert's products on every token); the
cell then carries ``moe_backend``.

``status`` is ``ok``, ``skipped`` (with :func:`shape_applicable`'s reason)
or ``error`` (with the traceback: a failing cell is a bug to fix, not to
hide). Results go to ``--out``, keyed ``arch|shape|<mesh>`` as JAX's are;
the exit code is 1 when any cell errs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..configs.base import MOE_BACKENDS, ModelConfig, ShapeSpec
from ..tree import leaves
from .cost import trace_cost, tree_bytes
from .mesh import policy_for
from .meta_mesh import production_meta_mesh
from .specs import batch_specs, input_specs

__all__ = ["build_step_fn", "measure", "run_cell", "main", "H100_HBM_BYTES",
           "MESHES"]

MESHES = ("1xgpu", "16x16", "2x16x16")
H100_HBM_BYTES = 80 * 10**9  # H100 SXM data sheet: 80 GB


def build_step_fn(config: ModelConfig, shape: ShapeSpec, *,
                  remat: bool = True, policy=None):
    """(step function taking :func:`input_specs`' keywords, the names of
    the arguments it updates in place). Under ``policy`` with a mesh the
    keywords are a rank's (``input_specs(…, policy)``) and the function is
    meant for meta tensors: it hands the step global stand-ins of the
    batch (see the module's notes)."""
    from ..models.model import decode_step, prefill
    from ..training.optimizer import AdamWConfig
    from ..training.train_step import make_train_step

    mesh = None if policy is None else policy.mesh
    num_slots = (config.num_virtual_experts
                 if mesh is not None and config.is_moe else None)
    # the global batch the step's API takes, on meta, made here (outside
    # the trace): each rank reads its own rows of it
    whole = None
    if mesh is not None:
        whole = batch_specs(config, shape)
        if shape.kind == "decode":
            whole = {"tokens": torch.empty((shape.global_batch, 1),
                                           dtype=torch.int32, device="meta")}

    def gathered(t):
        """The rank's rows all-gathered over the batch axes, in order."""
        if not policy.batch_axes or policy.data_axis_size == 1:
            return t
        return mesh.all_gather(t, policy.batch).flatten(0, 1)

    if shape.kind == "train":
        ts = make_train_step(config, AdamWConfig(), policy=policy,
                             remat=remat)

        def train_fn(state, batch, placements=None):
            return ts(state, batch if whole is None else whole, placements)

        return train_fn, ("state",)
    if shape.kind == "prefill":
        def prefill_fn(params, batch, placements=None):
            if mesh is not None:
                batch = {k: gathered(t) for k, t in batch.items()}
            with torch.no_grad():
                return prefill(params, batch["tokens"], config, placements,
                               patches=batch.get("patches"), policy=policy,
                               num_slots=num_slots)

        return prefill_fn, ()
    if shape.kind == "decode":
        def decode_fn(params, caches, cur_len, tokens, placements=None):
            if whole is not None:
                tokens = whole["tokens"]
            with torch.no_grad():
                return decode_step(params, caches, cur_len, tokens, config,
                                   placements, policy=policy,
                                   num_slots=num_slots)

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
            remat: bool = True, policy=None, dtype=torch.bfloat16) -> dict:
    """One step of ``config`` at ``shape`` on meta, its parameters and
    caches in ``dtype``: ``memory`` (with ``peak_bytes``), ``cost``
    (``flops``, ``bytes``, ``ops``; under a ``policy`` with a mesh, the
    rank's, with its ``collectives``) and ``host_s``."""
    t0 = time.perf_counter()
    kwargs = input_specs(config, shape, policy, dtype=dtype)
    memory = _memory_of(kwargs, shape.kind)
    fn, _ = build_step_fn(config, shape, remat=remat, policy=policy)
    out, cost = trace_cost(fn, mesh=None if policy is None else policy.mesh,
                           **kwargs)
    del out
    memory["peak_bytes"] = cost.pop("peak_bytes")
    return {"memory": memory, "cost": cost,
            "host_s": time.perf_counter() - t0}


def run_cell(arch: str, shape: str | ShapeSpec, *,
             config: ModelConfig | None = None, remat: bool = True,
             hbm: tuple[int, str] | None = None, mesh="1xgpu",
             policy=None, dtype=torch.bfloat16,
             moe_backend: str | None = None) -> dict:
    """The dry run of one cell: ``arch``'s config (or ``config``, e.g. a
    cut one) at ``shape`` (a name of :data:`SHAPES`, or a ShapeSpec), on
    ``mesh``: ``"1xgpu"``, a production mesh's name (``"16x16"``,
    ``"2x16x16"``: rank 0 of it) or a mesh object (a
    :class:`~repro_torch.launch.meta_mesh.MetaMesh` of any shape; its
    name in the cell is its extents joined by ``x``), under ``policy``
    (over that mesh) where given, else JAX's ``policy_for`` of the cell.
    ``hbm``: (bytes, source) to hold the peak against, instead of asking
    the CUDA device (or the data sheet without one). ``dtype``: the
    parameters' and caches' (JAX's dry run: bf16). ``moe_backend``: the
    MoE data plane of a MoE config's step (default: the config's own),
    recorded in the cell as JAX's ``run_cell`` records it."""
    config = config or get_config(arch)
    if moe_backend is not None and config.is_moe:
        config = dataclasses.replace(config, moe_backend=moe_backend)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    name = mesh if isinstance(mesh, str) else "x".join(
        str(n) for n in mesh.shape.values())
    cell: dict = {"arch": arch, "shape": shape.name, "mesh": name}
    if moe_backend is not None and config.is_moe:
        cell["moe_backend"] = moe_backend
    ok, why = shape_applicable(config, shape)
    if not ok:
        cell.update(status="skipped", reason=why)
        return cell
    try:
        if policy is None and mesh != "1xgpu":
            meta = production_meta_mesh(mesh) if isinstance(mesh, str) \
                else mesh
            policy = policy_for(meta, step_kind=shape.kind,
                                global_batch=shape.global_batch,
                                config=config)
        m = measure(config, shape, remat=remat, policy=policy, dtype=dtype)
        hbm, source = hbm or _hbm()
        cell.update(
            status="ok", remat=remat if shape.kind == "train" else None,
            memory=m["memory"], cost=m["cost"], host_s=m["host_s"],
            fits_hbm=m["memory"]["peak_bytes"] <= hbm, hbm_bytes=hbm,
            hbm_source=source,
        )
        if policy is not None:
            cell["collectives"] = cell["cost"].pop("collectives")
            cell["policy"] = {
                "batch_axes": list(policy.batch_axes),
                "kv_seq_axes": list(policy.kv_seq_axes),
                "cache_batch_axes": (None if policy.cache_batch_axes is None
                                     else list(policy.cache_batch_axes)),
                "fsdp": policy.fsdp}
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
        if "collectives" in cell:
            coll = cell["collectives"]
            extra += (f" collectives={coll['total_count']}/"
                      f"{coll['total_bytes'] / 1e9:.3f}GB")
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
    ap.add_argument("--mesh", choices=MESHES, default="1xgpu",
                    help="one card, or rank 0 of a production mesh")
    ap.add_argument("--moe-backend", default=None, choices=MOE_BACKENDS,
                    help="MoE data-plane backend for MoE archs (default: "
                    "each config's own setting)")
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
        key = f"{arch}|{shape}|{args.mesh}"
        cell = run_cell(arch, shape, mesh=args.mesh,
                        moe_backend=args.moe_backend)
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
