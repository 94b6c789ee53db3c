"""A mesh of ranks with no processes, for the dry run on a production mesh.

:class:`MetaMesh` has :class:`~repro_torch.launch.mesh.Mesh`'s interface
(``shape``, ``axis_names``, ``coords``, ``size``, ``index`` and the
collectives) and stands at one rank's coordinates of a grid of any shape:
JAX's production meshes, ``16x16`` over ``("data", "model")`` and
``2x16x16`` over ``("pod", "data", "model")`` (:func:`production_meta_mesh`),
need 256 or 512 ranks, which one host cannot start. Each collective returns
a tensor of the shape and dtype the real one returns, on the device of its
input (``torch.device("meta")`` in the dry run: nothing is allocated or
moved); the values are not the real ones (a gather repeats the rank's own
block, a sum is the rank's own term), which a step on meta tensors never
reads.

:func:`record_collectives` counts what a step sends, on a metadata mesh or
a real one alike: every top-level call of a collective (an ``all_reduce``
once, not the gather it is made of), by JAX's kind names as
``repro/launch/hlo_analysis.py::collective_stats`` reports them, with the
bytes of its operand (a broadcast and ``send_recv`` are point-to-point:
``collective-permute``). A call over a 1-wide axis counts as a call and
moves no bytes.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["KINDS", "CollectiveLog", "MetaMesh", "production_meta_mesh",
           "record_collectives"]

# JAX's collective kinds (``repro/launch/hlo_analysis.py``), and the mesh
# method each of the port's collectives is reported under
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_KIND_OF = {"all_gather": "all-gather", "all_reduce": "all-reduce",
            "reduce_scatter": "reduce-scatter",
            "all_to_all_single": "all-to-all",
            "broadcast": "collective-permute",
            "send_recv": "collective-permute"}


def _nbytes(t: torch.Tensor) -> int:
    return t.nelement() * t.element_size()


class CollectiveLog:
    """Counts and operand bytes of the collectives recorded while
    :attr:`on` is set, by kind."""

    def __init__(self):
        self.on = True
        self.counts = dict.fromkeys(KINDS, 0)
        self.bytes = dict.fromkeys(KINDS, 0)

    def add(self, kind: str, nbytes: int) -> None:
        self.counts[kind] += 1
        self.bytes[kind] += nbytes

    def reset(self) -> None:
        self.counts = dict.fromkeys(KINDS, 0)
        self.bytes = dict.fromkeys(KINDS, 0)

    def stats(self) -> dict:
        """``{"bytes", "counts"}`` by kind, ``total_bytes`` and
        ``total_count``: the keys of JAX's ``collective_stats`` that the
        port can count (it sees no wire bytes and no loops)."""
        return {"bytes": dict(self.bytes), "counts": dict(self.counts),
                "total_bytes": sum(self.bytes.values()),
                "total_count": sum(self.counts.values())}


def record_collectives(mesh) -> CollectiveLog:
    """Wrap ``mesh``'s collectives (on the instance, once: a second call
    returns the first's log) so that each top-level call is added to the
    returned log while ``log.on``. The operand's bytes count where the
    axis has more than one rank."""
    log = getattr(mesh, "collective_log", None)
    if log is not None:
        return log
    log = mesh.collective_log = CollectiveLog()
    depth = [0]

    def sent(name, args, kwargs) -> int:
        if name == "send_recv":
            sends = args[0] if args else kwargs["sends"]
            return sum(_nbytes(t) for _, t in sends)
        return _nbytes(args[0] if args else next(iter(kwargs.values())))

    def axis_of(name, args, kwargs):
        at = 2 if name == "send_recv" else 1
        return args[at] if len(args) > at else kwargs["axis"]

    def wrapped(name, fn):
        def call(*args, **kwargs):
            if log.on and depth[0] == 0:
                wide = mesh.size(axis_of(name, args, kwargs)) > 1
                log.add(_KIND_OF[name],
                        sent(name, args, kwargs) if wide else 0)
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return call

    for name in _KIND_OF:
        setattr(mesh, name, wrapped(name, getattr(mesh, name)))
    return log


class MetaMesh:
    """Rank ``rank`` (row-major over ``shape``) of a grid of ranks that
    do not exist; the collectives of :class:`~repro_torch.launch.mesh.
    Mesh` by shape and dtype. ``device``: what :attr:`device` reports
    (the device a step's tensors live on)."""

    def __init__(self, shape: dict[str, int], rank: int = 0, *,
                 device="meta"):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        sizes = tuple(self.shape.values())
        world = int(np.prod(sizes))
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a mesh of {world}")
        self.rank = rank
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(rank, sizes))))
        self.device = torch.device(device)

    @staticmethod
    def _axes(axis) -> tuple[str, ...]:
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def size(self, axis) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axis)]))

    def index(self, axis) -> int:
        axes = self._axes(axis)
        return int(np.ravel_multi_index(
            [self.coords[a] for a in axes], [self.shape[a] for a in axes]))

    def all_gather(self, t: torch.Tensor, axis) -> torch.Tensor:
        n = self.size(axis)
        return t.unsqueeze(0).expand(n, *t.shape).clone()

    def broadcast(self, t: torch.Tensor, axis) -> torch.Tensor:
        return t

    def all_reduce(self, t: torch.Tensor, axis, op: str = "sum",
                   dtype=None) -> torch.Tensor:
        if op not in ("sum", "max"):
            raise ValueError(f"op {op!r} not in ('sum', 'max')")
        return t.to(dtype or t.dtype, copy=True)

    def reduce_scatter(self, t: torch.Tensor, axis, dim: int = 0,
                       dtype=None) -> torch.Tensor:
        n = self.size(axis)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"split over {n} ranks")
        per = t.shape[dim] // n
        return t.narrow(dim, self.index(axis) * per, per).to(
            dtype or t.dtype, copy=True)

    def all_to_all_single(self, inp: torch.Tensor, axis,
                          in_splits: list[int], out_splits: list[int]
                          ) -> torch.Tensor:
        return inp.new_empty((int(sum(out_splits)), *inp.shape[1:]))

    def send_recv(self, sends, recvs, axis) -> list[torch.Tensor]:
        return [torch.empty(shape, dtype=dtype, device=self.device)
                for _, shape, dtype in recvs]


def production_meta_mesh(name: str, rank: int = 0) -> MetaMesh:
    """JAX's production mesh by its dry-run name, ``"16x16"`` or
    ``"2x16x16"`` (``make_production_mesh``'s shapes), at ``rank``."""
    shapes = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}
    if name not in shapes:
        raise ValueError(f"mesh {name!r} not in {sorted(shapes)}")
    return MetaMesh(shapes[name], rank)
