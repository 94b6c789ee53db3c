"""Checkpoints with an atomic commit, in the JAX package's format (port of
``repro/checkpoint/manager.py``), so that each package restores the
other's files.

Layout (one directory per step)::

    <root>/step_00000100/
        arrays.npz     flat {path: ndarray} of every leaf
        manifest.json  every path's shape and dtype + user metadata
        COMMIT         empty marker written last — a step directory without
                       it is torn (crashed mid-save) and is ignored

A leaf's path is its dict keys from the root, sorted at each level and
joined by ``/`` (``opt/mu/blocks/moe/w_gate``). The manifest names dtypes
as JAX does (``"float32"``, ``"bfloat16"``, ``"int32"``). numpy has no
bfloat16 without ``ml_dtypes``: a bf16 leaf is stored as the 2-byte void
array JAX's ``np.savez`` writes for it (``|V2``), and read back through a
``uint16`` view, so the bytes cross unchanged in both directions.

The directory is written as ``step_XXXXXXXX.tmp`` and renamed once
``COMMIT`` is in it; a kill at any point leaves the last committed step
intact. The manifest's ``extra`` carries opaque user state (the data
stream's position), so that a restart reproduces the batch sequence.
:meth:`CheckpointManager.restore_sharded` restores onto a mesh of ranks:
arrays are stored unsharded, so a checkpoint written by either package on
any mesh (or one device) restores onto any mesh shape. ``save(…,
mesh=…, shardings=…)`` writes one from a mesh: every sharded leaf is
all-gathered into its global shape, as JAX's ``save`` writes global
arrays, and one rank writes the step.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from ..sharding import spec_axes

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _to_numpy(t) -> tuple[np.ndarray, str]:
    """A leaf → (the array ``np.savez`` stores, its dtype's name)."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        # ml_dtypes' bfloat16 or the void array numpy loads without it
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(name)))


def _flatten(tree, prefix="", out=None) -> dict:
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}/", out)
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(skeleton, flat, prefix=""):
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in skeleton.items()}
    if skeleton is None:
        return None
    t = flat[prefix[:-1]]
    if isinstance(skeleton, torch.Tensor):
        if tuple(t.shape) != tuple(skeleton.shape):
            raise ValueError(f"{prefix[:-1]}: stored shape {tuple(t.shape)}, "
                             f"expected {tuple(skeleton.shape)}")
        t = t.to(skeleton.device)
    return t


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    # -- discovery -----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def committed_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name, "COMMIT")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    # -- save / restore ------------------------------------------------------
    def save(self, step: int, state, *, extra: dict | None = None,
             mesh=None, shardings=None) -> str:
        """Write ``state`` (a nested dict of tensors) as step ``step``.

        From a ``mesh`` every rank calls it: ``shardings`` mirrors
        ``state`` with each leaf's spec (as :meth:`restore_sharded` takes
        them; None for a whole leaf), and each sharded leaf is all-gathered
        over its axes into the global shape, a leaf at a time, by the
        ranks whose position off those axes is 0. Rank 0 writes the step
        with the same atomic commit; the others write nothing and return
        once it is committed (a barrier)."""
        if mesh is not None:
            return self._save_from_mesh(step, state, extra, mesh, shardings)
        return self._write(step, _flatten(state), extra)

    def _save_from_mesh(self, step, state, extra, mesh, shardings) -> str:
        import torch.distributed as dist

        specs = _flatten(shardings) if shardings is not None else {}
        flat = {}
        for k, v in _flatten(state).items():
            spec = specs.get(k)
            named = spec_axes(spec)
            # only the ranks that hold the first copy along the other
            # axes gather: their groups are apart from the others'
            if any(mesh.coords[a] for a in mesh.axis_names if a not in named):
                continue
            for dim, axes in enumerate(spec or ()):
                if axes is not None:
                    parts = mesh.all_gather(v, axes)  # (n, *v.shape)
                    v = torch.cat(list(parts.unbind(0)), dim=dim)
            if mesh.rank == 0:
                flat[k] = v.detach().cpu()
        d = self._step_dir(step)
        if mesh.rank == 0:
            self._write(step, flat, extra)
        dist.barrier()
        return d

    def _write(self, step: int, leaves: dict, extra) -> str:
        d = self._step_dir(step)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat, names = {}, {}
        for k, v in leaves.items():
            flat[k], names[k] = _to_numpy(v)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "paths": {k: {"shape": list(v.shape), "dtype": names[k]}
                      for k, v in flat.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # commit: marker inside, then atomic rename of the directory
        open(os.path.join(tmp, "COMMIT"), "w").close()
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        self._gc()
        return d

    def restore(self, skeleton, *, step: int | None = None):
        """Returns (state shaped as ``skeleton``, extra dict, step). Each
        leaf is a tensor of the stored dtype, on the device of the
        skeleton's tensor there (the CPU where the skeleton holds none)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint in {self.root}")
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, "COMMIT")):
            raise FileNotFoundError(f"step {step} is not committed")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: _from_numpy(z[k], manifest["paths"][k]["dtype"])
                    for k in z.files}
        state = _unflatten_into(skeleton, flat)
        return state, manifest["extra"], step

    def restore_sharded(self, skeleton, shardings, *, mesh,
                        step: int | None = None):
        """Restore and keep, on this rank, its shard of every leaf: the JAX
        manager's elastic re-mesh path.

        ``shardings`` mirrors ``skeleton`` with a spec for each leaf (a
        tuple of one axis name, tuple of names or None a dim, as
        :func:`repro_torch.sharding.param_specs` gives them) or None for a
        whole leaf; ``skeleton``'s tensors have this rank's shapes and
        devices. A dim sharded over axes of extent n keeps block ``i`` of n,
        i being the rank's position along them. Returns (state, extra,
        step), as :meth:`restore`."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint in {self.root}")
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, "COMMIT")):
            raise FileNotFoundError(f"step {step} is not committed")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        specs = _flatten(shardings) if shardings is not None else {}
        flat = {}
        with np.load(os.path.join(d, "arrays.npz")) as z:
            for k in z.files:
                arr = z[k]
                spec = specs.get(k)
                for dim, axes in enumerate(spec or ()):
                    if axes is None:
                        continue
                    n = mesh.size(axes)
                    block = arr.shape[dim] // n
                    lo = mesh.index(axes) * block
                    arr = arr.take(np.arange(lo, lo + block), axis=dim)
                flat[k] = _from_numpy(arr, manifest["paths"][k]["dtype"])
        state = _unflatten_into(skeleton, flat)
        return state, manifest["extra"], step

    # -- retention -----------------------------------------------------------
    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
