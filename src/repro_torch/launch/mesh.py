"""Meshes of ranks over ``torch.distributed`` (port of ``repro/launch/mesh.py``).

A JAX mesh is a grid of devices that one program addresses by named axes;
here it is a grid of processes, one a rank, each holding its own device.
:class:`Mesh` lays the world out row-major over its axes (``("data",
"model")``, or ``("pod", "data", "model")``): rank ``r`` sits at the
coordinates ``np.unravel_index(r, shape)``. At construction every rank
makes one process group for each set of axes (a row of the grid over
``model``, a column over ``data``, …), in the same order everywhere, as
``torch.distributed.new_group`` requires; within a group the ranks are in
ascending order, which is the order along the axes.

The collectives the expert-parallel data plane needs live here, over a
named axis (or a tuple of axes): :meth:`Mesh.all_gather`,
:meth:`Mesh.all_reduce` (a gather reduced in rank order: the training
step's gradient reductions, the model axis's partial sums),
:meth:`Mesh.reduce_scatter` (the same sum, each rank its block: FSDP's
gradients),
:meth:`Mesh.broadcast`,
:meth:`Mesh.all_to_all_single` and
:meth:`Mesh.send_recv` (paired point-to-point transfers). Under
``backend="nccl"`` they are NCCL's own collectives on the card's tensors,
which a CUDA graph can capture. Under
``backend="gloo"`` a tensor on a CUDA device is staged through pinned host
buffers, here and nowhere else: that is the transport when several ranks
share one card (NCCL puts no two ranks on one GPU), and
:attr:`Mesh.staged_bytes` counts the bytes copied each way.

:func:`spawn` starts ``data · model`` ranks on one host (the tests on the
CPU over ``gloo``; ``chip_smoke.py``'s ``mesh`` phase on the card) with a
``file://`` store, one thread each, and joins them with a time limit.
"""
from __future__ import annotations

import gc
import itertools
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = [
    "Mesh",
    "make_production_mesh",
    "make_host_mesh",
    "policy_for",
    "spawn",
]


class Mesh:
    """The rank grid: ``shape`` (an ordered ``{axis: size}``),
    ``axis_names``, this rank's ``coords``, its ``device`` and the
    ``backend``; one process group per set of axes."""

    def __init__(self, shape: dict[str, int], *, device=None,
                 backend: str | None = None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "a Mesh needs an initialised default process group "
                "(torch.distributed.init_process_group)")
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        sizes = tuple(self.shape.values())
        world = int(np.prod(sizes))
        if dist.get_world_size() != world:
            raise ValueError(
                f"mesh {self.shape} needs {world} ranks, the world has "
                f"{dist.get_world_size()}")
        self.backend = backend or dist.get_backend()
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {self.backend!r} not in ('nccl', 'gloo')")
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, sizes))))
        if device is None:
            device = resolve_device(None)
            device = torch.device("cuda", local_rank() % torch.cuda.device_count())
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("backend='nccl' needs ranks on CUDA devices")
        # one group for every non-empty set of axes, made in the same order
        # on every rank
        grid = np.arange(world).reshape(sizes)
        self._groups: dict[tuple[str, ...], object] = {}
        for k in range(1, len(sizes) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                along = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(len(sizes)) if i not in along]
                moved = np.moveaxis(grid, along + rest, range(len(sizes)))
                lanes = moved.reshape(int(np.prod([sizes[i] for i in along])), -1)
                for col in range(lanes.shape[1]):
                    ranks = [int(r) for r in lanes[:, col]]
                    group = dist.new_group(ranks, backend=self.backend)
                    if self.rank in ranks:
                        self._groups[axes] = (group, ranks)
        self.staged_bytes = 0
        self._pinned: dict[str, torch.Tensor] = {}

    # ---- axes ----------------------------------------------------------
    @staticmethod
    def _axes(axis) -> tuple[str, ...]:
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def size(self, axis) -> int:
        """The extent of an axis, or the product over a tuple of axes."""
        return int(np.prod([self.shape[a] for a in self._axes(axis)]))

    def index(self, axis) -> int:
        """This rank's position along an axis (row-major over a tuple)."""
        axes = self._axes(axis)
        return int(np.ravel_multi_index(
            [self.coords[a] for a in axes], [self.shape[a] for a in axes]))

    def _group(self, axis):
        axes = tuple(a for a in self.axis_names if a in self._axes(axis))
        return self._groups[axes]

    # ---- staging (gloo on a CUDA device) -------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _host(self, shape, dtype, slot: str) -> torch.Tensor:
        """A pinned host buffer of ``shape``: a view of one pinned byte
        buffer a use (``slot``), grown to the largest call's size and
        reused, so that the varying shapes of a serving run allocate
        pinned memory only when a call outgrows every earlier one."""
        n = int(np.prod(shape)) * dtype.itemsize
        buf = self._pinned.get(slot)
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 1), dtype=torch.uint8, pin_memory=True)
            self._pinned[slot] = buf
        return buf[:n].view(dtype).view(shape)

    def _down(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        buf = self._host(t.shape, t.dtype, slot)
        buf.copy_(t)
        self.staged_bytes += t.numel() * t.element_size()
        return buf

    def _up(self, buf: torch.Tensor, device) -> torch.Tensor:
        self.staged_bytes += buf.numel() * buf.element_size()
        return buf.to(device, copy=True)

    # ---- collectives ---------------------------------------------------
    def all_gather(self, t: torch.Tensor, axis) -> torch.Tensor:
        """``(n, *t.shape)``: every rank's ``t`` along ``axis``, in axis
        order. A 1-wide axis returns ``t[None]`` and moves nothing."""
        n = self.size(axis)
        if n == 1:
            return t.unsqueeze(0)
        group, _ = self._group(axis)
        t = t.contiguous()
        if self.backend == "nccl":
            out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t, group=group)
            return out
        staged = self._staged(t)
        src = self._down(t, "gather_in") if staged else t
        out = (self._host((n, *t.shape), t.dtype, "gather_out") if staged
               else torch.empty((n, *t.shape), dtype=t.dtype, device=t.device))
        dist.all_gather(list(out.unbind(0)), src, group=group)
        return self._up(out, t.device) if staged else out

    def broadcast(self, t: torch.Tensor, axis) -> torch.Tensor:
        """The tensor of the axis's first rank, on every rank of it (``t``
        gives the shape and dtype elsewhere). A 1-wide axis returns ``t``
        and moves nothing."""
        if self.size(axis) == 1:
            return t
        group, ranks = self._group(axis)
        t = t.contiguous()
        mine = self.index(axis) == 0
        if self.backend == "nccl":
            out = t if mine else torch.empty_like(t)
            dist.broadcast(out, ranks[0], group=group)
            return out
        staged = self._staged(t)
        if not staged:
            out = t.clone() if not mine else t
            dist.broadcast(out, ranks[0], group=group)
            return out
        buf = (self._down(t, "bcast") if mine
               else self._host(t.shape, t.dtype, "bcast"))
        dist.broadcast(buf, ranks[0], group=group)
        return t if mine else self._up(buf, t.device)

    def all_reduce(self, t: torch.Tensor, axis, op: str = "sum",
                   dtype=None) -> torch.Tensor:
        """The ``"sum"`` or ``"max"`` of every rank's ``t`` along ``axis``,
        in ``dtype`` (default ``t``'s): one :meth:`all_gather` of ``t`` as
        it is, reduced in axis order, so that every rank gets the same
        bits (a ring all-reduce adds in an order that depends on the
        rank). A bf16 ``t`` summed in fp32 is the sum of its values
        converted first, at half the bytes moved. A 1-wide axis moves
        nothing."""
        if op not in ("sum", "max"):
            raise ValueError(f"op {op!r} not in ('sum', 'max')")
        dtype = dtype or t.dtype
        if self.size(axis) == 1:
            return t.to(dtype)
        parts = self.all_gather(t, axis)
        out = parts[0].to(dtype, copy=True)
        for p in parts[1:]:
            if op == "sum":
                out.add_(p.to(dtype))
            else:
                torch.maximum(out, p.to(dtype), out=out)
        return out

    def reduce_scatter(self, t: torch.Tensor, axis, dim: int = 0,
                       dtype=None) -> torch.Tensor:
        """This rank's block along ``dim`` (one of ``size(axis)``, in axis
        order) of the sum of every rank's ``t`` along ``axis``, in
        ``dtype`` (default ``t``'s): each rank's blocks go to their owners
        in one :meth:`all_to_all_single` of ``t`` as it is, and the owner
        adds them in axis order — :meth:`all_reduce`'s sum, bit for bit,
        of this block alone, at 1/n of its bytes received. A 1-wide axis
        moves nothing."""
        dtype = dtype or t.dtype
        n = self.size(axis)
        if n == 1:
            return t.to(dtype)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"split over {n} ranks")
        per = t.shape[dim] // n
        rows = t.movedim(dim, 0)
        got = self.all_to_all_single(rows.reshape(t.shape[dim], -1), axis,
                                     [per] * n, [per] * n)
        parts = got.view(n, per, -1)
        out = parts[0].to(dtype, copy=True)
        for p in parts[1:]:
            out.add_(p.to(dtype))
        return out.view(per, *rows.shape[1:]).movedim(0, dim)

    def all_to_all_single(self, inp: torch.Tensor, axis,
                          in_splits: list[int], out_splits: list[int]
                          ) -> torch.Tensor:
        """Rows ``in_splits[q]`` of ``inp`` (in order) go to the rank at
        position ``q`` of ``axis``; the result holds ``out_splits[q]`` rows
        from each, in axis order."""
        group, _ = self._group(axis)
        shape = (int(sum(out_splits)), *inp.shape[1:])
        inp = inp.contiguous()
        staged = self._staged(inp)
        src = self._down(inp, "a2a_in") if staged else inp
        out = (self._host(shape, inp.dtype, "a2a_out") if staged
               else torch.empty(shape, dtype=inp.dtype, device=inp.device))
        dist.all_to_all_single(out, src, output_split_sizes=list(out_splits),
                               input_split_sizes=list(in_splits), group=group)
        return self._up(out, inp.device) if staged else out

    def send_recv(self, sends, recvs, axis) -> list[torch.Tensor]:
        """Paired point-to-point transfers over ``axis``: ``sends`` is a
        list of ``(peer, tensor)``, ``recvs`` of ``(peer, shape, dtype)``,
        peers by position along the axis; every send has its receive on
        the peer. Returns the received tensors, in ``recvs`` order, on
        this rank's device."""
        _, ranks = self._group(axis)
        ops, outs, staged_out = [], [], []
        for i, (peer, t) in enumerate(sends):
            t = t.contiguous()
            if self._staged(t):
                t = self._down(t, f"send{i}")
            ops.append(dist.P2POp(dist.isend, t, ranks[peer]))
        for i, (peer, shape, dtype) in enumerate(recvs):
            staged = self.backend == "gloo" and self.device.type == "cuda"
            buf = (self._host(shape, dtype, f"recv{i}") if staged
                   else torch.empty(shape, dtype=dtype, device=self.device))
            ops.append(dist.P2POp(dist.irecv, buf, ranks[peer]))
            outs.append(buf)
            staged_out.append(staged)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [self._up(b, self.device) if s else b
                for b, s in zip(outs, staged_out)]


def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK``, else the global
    rank: :func:`spawn` starts every rank on one host)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def make_host_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """A ``(data, model)`` mesh over the initialised world, which must hold
    ``data · model`` ranks. ``device``: this rank's device (default the
    card ``cuda:(local_rank % device_count)``; ``"cpu"`` on a host without
    one)."""
    return Mesh({"data": data, "model": model}, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """JAX's production shapes: ``(16, 16)`` over ``("data", "model")``,
    ``(2, 16, 16)`` over ``("pod", "data", "model")`` with ``multi_pod``.
    Raises unless the world has that many ranks."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return Mesh(shape, device=device)


def policy_for(mesh, *, step_kind: str, global_batch: int | None = None,
               config=None):
    """The ShardingPolicy used for a given lowered step on a given mesh.

    * Long-context decode (global_batch smaller than the data-axis extent)
      replicates the batch and shards the KV sequence over data AND model,
      so the whole fleet still participates in the cache sweep.
    * Huge models (bf16 params > ~6 GB per model-axis shard, i.e.
      internvl2-76b) also FSDP-shard parameters at inference. Decode then
      runs batch-*replicated* activations; only the KV cache keeps its
      batch sharded over data (``cache_batch_axes``).

    The same decisions as JAX's; ``mesh`` needs only ``shape`` and
    ``axis_names``. What the port stores under them
    (:func:`~repro_torch.sharding.param_specs`): every policy stores the
    projections, the SSD heads, the vocabulary and the expert slots over
    ``model``, the dense KV cache's positions over ``kv_seq_axes`` and
    the SSM state's heads over ``model``; ``fsdp`` (every train step, and
    inference past 6 GB a model-axis shard) also stores those leaves over
    ``data`` (ZeRO-3, their moments with them, a layer gathered before it
    runs); the caches' rows lie over ``cache_batch_axes`` (decode under
    FSDP: every rank runs every row and holds a 1/d share of the rows) or
    the batch axes. Every family alike. ``mesh`` may be a
    :class:`~repro_torch.launch.meta_mesh.MetaMesh` (the dry run's).
    """
    from ..sharding.policy import ShardingPolicy

    multi_pod = "pod" in mesh.axis_names
    batch_axes: tuple = ("pod", "data") if multi_pod else ("data",)
    kv_seq_axes: tuple = ("model",)
    cache_batch_axes = None
    fsdp = step_kind == "train"
    model_size = mesh.shape["model"]
    if config is not None and step_kind in ("decode", "prefill"):
        per_shard_gb = config.param_count() * 2 / model_size / 1024**3
        if per_shard_gb > 6.0:
            fsdp = True
            if step_kind == "decode":
                cache_batch_axes = batch_axes
                batch_axes = ()
    if step_kind == "decode" and global_batch is not None:
        data_size = 1
        for a in (cache_batch_axes or batch_axes):
            data_size *= mesh.shape[a]
        if global_batch < data_size:
            kv_seq_axes = (cache_batch_axes or batch_axes) + ("model",)
            batch_axes = ()
            cache_batch_axes = ()
    return ShardingPolicy(
        mesh=mesh,
        batch_axes=batch_axes,
        model_axis="model",
        kv_seq_axes=kv_seq_axes,
        cache_batch_axes=cache_batch_axes,
        fsdp=fsdp,
    )


# ----------------------------------------------------------------- spawn
def _rank_main(rank: int, fn, args, data: int, model: int, backend: str,
               device, store_dir: str) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    os.environ.setdefault("LOCAL_RANK", str(rank))
    world = data * model
    dev = device
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{Path(store_dir) / 'store'}",
        world_size=world, rank=rank,
        # NCCL binds each rank's communicators to its own card
        device_id=dev if backend == "nccl" else None,
    )
    try:
        mesh = make_host_mesh(data, model, device=dev)
        try:
            result = fn(mesh, *args)
        except BaseException:
            # the cause, for the parent: the other ranks fail after it, in
            # the collectives it left
            (Path(store_dir) / f"error_{rank}.txt").write_text(
                traceback.format_exc())
            raise
        with open(Path(store_dir) / f"result_{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
        # what fn left behind (a captured graph holding NCCL's kernels)
        # goes before the groups do
        del result
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, data: int, model: int, *, backend: str, device, store_dir,
          args=(), timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``data · model`` ranks of this host and
    return each rank's result, in rank order.

    Each rank is a process of the spawn context with one thread
    (``torch.set_num_threads(1)``) that joins the world through a
    ``file://`` store in ``store_dir`` (no TCP port), builds
    :func:`make_host_mesh` on ``device`` (``"cuda"``: ``cuda:(rank %
    device_count)``, or ``"cpu"``; the caller names it, as it names
    ``backend``, ``"nccl"`` or ``"gloo"``), calls ``fn`` (a module-level function,
    so that the spawn context can pickle it) and pickles its result into
    ``store_dir``. A rank that raises fails the call with its traceback
    (every failed rank's, when others fail after it); a world that has not
    finished within ``timeout`` seconds is killed and raises
    ``TimeoutError``."""
    import torch.multiprocessing as mp

    store_dir = Path(store_dir)
    store_dir.mkdir(parents=True, exist_ok=True)
    for stale in (store_dir / "store", *store_dir.glob("error_*.txt"),
                  *store_dir.glob("result_*.pkl")):
        stale.unlink(missing_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(fn, args, data, model, backend, device,
                          str(store_dir)),
        nprocs=data * model, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"mesh ({data}, {model}) ranks did not finish within "
                    f"{timeout} s")
    except mp.ProcessRaisedException as e:
        causes = sorted(store_dir.glob("error_*.txt"))
        if not causes:
            raise
        raise RuntimeError("\n".join(
            f"{p.stem.replace('_', ' ')} raised:\n{p.read_text()}"
            for p in causes)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    out = []
    for rank in range(data * model):
        with open(store_dir / f"result_{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
