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

:class:`World` starts ranks on one host once, with a ``file://`` store
and one thread each, and runs many functions on them with a time limit,
each over a fresh mesh of any shape of its size (``chip_smoke.py``'s gloo
runs on one card). :func:`spawn` is one such run on a world started for
it (the tests on the CPU over ``gloo``; ``chip_smoke.py``'s NCCL runs on
four cards).
"""
from __future__ import annotations

import gc
import itertools
import os
import pickle
import queue
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = [
    "Mesh",
    "World",
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


# ----------------------------------------------------------------- World
# how long a failed run waits for the other ranks' tracebacks, and a
# closing world for its ranks to leave, before it kills them
_FAILURE_GRACE_S = 5.0
_CLOSE_TIMEOUT_S = 60.0


def _join_world(rank: int, world: int, backend: str, device,
                store_dir: str):
    """This process as rank ``rank`` of a world of ``world`` ranks on this
    host: one thread, its card (``device="cuda"``: ``cuda:(rank %
    device_count)``), the default group over the ``file://`` store in
    ``store_dir``. Returns its device."""
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    os.environ.setdefault("LOCAL_RANK", str(rank))
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
    return dev


def _call_on_mesh(fn, args, data: int, model: int, dev, result: Path):
    """``fn(mesh, *args)`` on a fresh ``(data, model)`` mesh of the world,
    its result pickled into ``result``; returns the mesh once every rank
    is done."""
    mesh = make_host_mesh(data, model, device=dev)
    out = fn(mesh, *args)
    with open(result, "wb") as f:
        pickle.dump(out, f)
    # what fn left behind (a captured graph holding NCCL's kernels)
    # goes before the groups do
    del out
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dist.barrier()
    return mesh


def _world_main(rank: int, size: int, backend: str, device, store_dir: str,
                tasks, done) -> None:
    """A rank of a :class:`World`: joins the world once, then runs each
    task ``(fn, data, model, args)`` from ``tasks`` on a fresh mesh and
    answers on ``done``, until it reads None. A task that raises leaves
    its traceback in ``store_dir`` and ends the rank (the parent then
    stops the world)."""
    from ..kernels import launches

    dev = _join_world(rank, size, backend, device, store_dir)
    seed = torch.initial_seed()
    try:
        while (task := tasks.get()) is not None:
            fn, data, model, args = task
            # each run starts as the rank's first did: its launch counts
            # at 0, the default generators at the seed the process drew
            launches.reset()
            torch.manual_seed(seed)
            try:
                mesh = _call_on_mesh(fn, args, data, model, dev,
                                     Path(store_dir) / f"result_{rank}.pkl")
                for group, _ in mesh._groups.values():
                    dist.destroy_process_group(group)
            except BaseException:
                # the cause, for the parent (the other ranks fail after
                # it, in the collectives it left): fn, the mesh, the
                # result's pickling or the groups' teardown
                (Path(store_dir) / f"error_{rank}.txt").write_text(
                    traceback.format_exc())
                done.put((rank, "error"))
                raise
            # the card's memory back for the parent between runs
            del mesh
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            done.put((rank, "ok"))
    finally:
        dist.destroy_process_group()


def _clear_store(store_dir: Path) -> None:
    for stale in (store_dir / "store", *store_dir.glob("error_*.txt"),
                  *store_dir.glob("result_*.pkl")):
        stale.unlink(missing_ok=True)


def _failure(store_dir: Path) -> str | None:
    """Every failed rank's traceback, as the ranks left them."""
    causes = sorted(store_dir.glob("error_*.txt"))
    if not causes:
        return None
    return "\n".join(f"{p.stem.replace('_', ' ')} raised:\n{p.read_text()}"
                     for p in causes)


def _results(store_dir: Path, n: int) -> list:
    out = []
    for rank in range(n):
        path = store_dir / f"result_{rank}.pkl"
        with open(path, "rb") as f:
            out.append(pickle.load(f))
        path.unlink()
    return out


class World:
    """``size`` ranks of this host, started once, that run many functions:
    each :meth:`run` builds a fresh :class:`Mesh` of the shape it asks
    for over the same processes, without a process start and a card
    context a run.

    Each rank is a process of the spawn context with one thread
    (``torch.set_num_threads(1)``) that joins the world through a
    ``file://`` store in ``store_dir`` (no TCP port), on ``device``
    (``"cuda"``: ``cuda:(rank % device_count)``, or ``"cpu"``; the caller
    names it, as it names ``backend``, ``"nccl"`` or ``"gloo"``). Each run
    starts as the rank's first did: the launch counts at 0 and torch's
    default generators at the seed the process drew when it started. Use as a context manager, or
    :meth:`start` it and :meth:`close` it in a ``finally``: closing joins
    every rank and removes the store, whatever happened before."""

    def __init__(self, size: int, *, backend: str, device, store_dir):
        self.size, self.backend, self.device = size, backend, device
        self.store_dir = Path(store_dir)
        self.processes: list = []
        self._tasks: list = []
        self._done = None
        self._stopped = False

    def __enter__(self) -> "World":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def start(self) -> "World":
        """Start the ranks (they join the world while the caller goes
        on); returns the world."""
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.store_dir.mkdir(parents=True, exist_ok=True)
        _clear_store(self.store_dir)
        self._done = ctx.Queue()
        try:
            for rank in range(self.size):
                tasks = ctx.Queue()
                proc = ctx.Process(
                    target=_world_main, daemon=True,
                    args=(rank, self.size, self.backend, self.device,
                          str(self.store_dir), tasks, self._done))
                proc.start()
                self._tasks.append(tasks)
                self.processes.append(proc)
        except BaseException:
            self.close()
            raise
        return self

    def run(self, fn, data: int, model: int, *, args=(),
            timeout: float = 600.0) -> list:
        """``fn(mesh, *args)`` on every rank, over a fresh ``(data,
        model)`` mesh of the world (``data · model`` must be its size;
        ``fn`` a module-level function, so that the spawn context can
        pickle it), and each rank's result in rank order. After it, each
        rank destroys the mesh's groups, frees what ``fn`` left behind and
        resets the card's peak-memory statistics. A rank that raises fails
        the run with its traceback (every failed rank's, when others fail
        after it); a run that has not finished within ``timeout`` seconds
        raises ``TimeoutError``. Either stops the whole world, which takes
        no run after."""
        if data * model != self.size:
            raise ValueError(f"mesh ({data}, {model}) needs {data * model} "
                             f"ranks, the world has {self.size}")
        if self._stopped or not self.processes:
            raise RuntimeError("the world's ranks are not running")
        try:
            for tasks in self._tasks:
                tasks.put((fn, data, model, args))
            self._wait(time.monotonic() + timeout,
                       f"mesh ({data}, {model}) ranks did not finish within "
                       f"{timeout} s")
            return _results(self.store_dir, self.size)
        except BaseException:
            self._stop()
            raise

    def _wait(self, deadline: float, late: str) -> None:
        """Until every rank has answered; raises ``TimeoutError(late)``
        past ``deadline``, and every failed rank's traceback if one fails."""
        waiting = set(range(self.size))
        while waiting:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(late)
            try:
                rank, status = self._done.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r in waiting if not self.processes[r].is_alive()]
                if dead:
                    self._fail(f"rank(s) {dead} exited without a result")
                continue
            if status != "ok":
                self._fail(f"rank {rank} raised")
            waiting.discard(rank)

    def _fail(self, what: str) -> None:
        # the others fail after the first, in the collectives it left:
        # a moment for their tracebacks
        deadline = time.monotonic() + _FAILURE_GRACE_S
        while (time.monotonic() < deadline
               and any(p.is_alive() for p in self.processes)):
            time.sleep(0.1)
        raise RuntimeError(_failure(self.store_dir) or what)

    def _stop(self) -> None:
        """Kill every rank and wait for it."""
        self._stopped = True
        for p in self.processes:
            if p.is_alive():
                p.kill()
            p.join()
        for q in (*self._tasks, self._done):
            if q is not None:
                q.cancel_join_thread()
                q.close()

    def close(self) -> None:
        """Let every rank leave the world (killed if it has not within
        :data:`_CLOSE_TIMEOUT_S`), then remove the store."""
        if not self._stopped:
            for tasks in self._tasks:
                tasks.put(None)
            deadline = time.monotonic() + _CLOSE_TIMEOUT_S
            for p in self.processes:
                p.join(max(deadline - time.monotonic(), 0.0))
            self._stop()
        _clear_store(self.store_dir)


def spawn(fn, data: int, model: int, *, backend: str, device, store_dir,
          args=(), timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``data · model`` ranks of this host and
    return each rank's result, in rank order: one :meth:`World.run` of a
    :class:`World` of that size, started for it and closed after it
    (``backend``, ``device``, ``store_dir``, the failures and the
    ``timeout`` as there)."""
    with World(data * model, backend=backend, device=device,
               store_dir=store_dir) as world:
        return world.run(fn, data, model, args=args, timeout=timeout)
