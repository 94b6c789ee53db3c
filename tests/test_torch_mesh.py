"""The port's mesh transport (``repro_torch/launch/mesh.py``) over ``gloo``
ranks on the CPU, and the helpers the other multi-rank parity tests
(``test_torch_mesh_*.py``) share.

* :func:`ranks` starts ``data · model`` ranks through the port's own
  :func:`~repro_torch.launch.mesh.spawn`: one process and one thread a
  rank, a ``file://`` store under the test's ``tmp_path`` (no TCP port, so
  the suite's workers never collide), joined with a time limit so that a
  hung rank fails the test.
* :func:`run_jax` runs a function of a test module in a fresh interpreter
  with ``XLA_FLAGS=--xla_force_host_platform_device_count=N
  JAX_PLATFORMS=cpu``: JAX's real mesh path (``shard_map`` over a
  ``make_host_mesh`` of that many host devices) on the same numpy inputs,
  handing numpy back. JAX fixes its device count when it first starts,
  which is why it cannot run inside the suite's own process.

The module itself imports no JAX, so that the spawned ranks start quickly.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
RANK_TIMEOUT_S = 240.0
JAX_TIMEOUT_S = 300.0


def ranks(fn, data: int, model: int, tmp_path, *args) -> list:
    """Each rank's ``fn(mesh, *args)`` on a ``(data, model)`` gloo mesh of
    CPU ranks, in rank order."""
    return spawn(fn, data, model, backend="gloo", device="cpu",
                 store_dir=Path(tmp_path) / f"mesh_{data}x{model}",
                 args=args, timeout=RANK_TIMEOUT_S)


def run_jax(entry: str, payload, tmp_path, *, devices: int = 4):
    """``module:function`` called on ``payload`` in a fresh interpreter
    with ``devices`` forced JAX host devices; returns its result."""
    module, func = entry.split(":")
    tmp_path = Path(tmp_path)
    inp, out = tmp_path / f"{func}_in.pkl", tmp_path / f"{func}_out.pkl"
    with open(inp, "wb") as f:
        pickle.dump(payload, f)
    code = (
        "import pickle, sys\n"
        f"sys.path[:0] = [{str(TESTS)!r}, {str(ROOT / 'src')!r}]\n"
        f"import {module} as m\n"
        f"with open({str(inp)!r}, 'rb') as f:\n"
        f"    r = m.{func}(pickle.load(f))\n"
        f"with open({str(out)!r}, 'wb') as f:\n"
        "    pickle.dump(r, f)\n"
    )
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"{flags} --xla_force_host_platform_device_count="
                         f"{devices}".strip())
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True,
                          timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


class MeshAt:
    """A stand-in for rank ``rank`` of a ``(data, model)`` mesh: the
    extents and positions the port's specs read (no process group)."""

    def __init__(self, shape, rank):
        self.shape = {"data": shape[0], "model": shape[1]}
        self.axis_names = ("data", "model")
        self.coords = {"data": rank // shape[1], "model": rank % shape[1]}

    def size(self, axis):
        axes = (axis,) if isinstance(axis, str) else axis
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axis):
        axes = (axis,) if isinstance(axis, str) else axis
        return int(np.ravel_multi_index([self.coords[a] for a in axes],
                                        [self.shape[a] for a in axes]))


def spec_of(specs_flat: dict, path: str):
    """A train-state path's parameter spec (``opt/mu/…``, ``opt/nu/…``,
    ``ef_residual/…`` and ``params/…`` name their parameter's)."""
    for prefix in ("opt/mu/", "opt/nu/", "ef_residual/", "params/"):
        if path.startswith(prefix):
            path = path[len(prefix):]
            break
    return specs_flat.get(path)


def rank_shard(whole, spec, shape, rank):
    """The rank's block of a whole array by its spec."""
    from repro_torch.sharding import take_shard

    return take_shard(whole, spec, MeshAt(shape, rank))


# ----------------------------------------------------------- the transport
def _transport(mesh):
    """Every collective of the mesh over every axis, on tensors that name
    the sending rank, so that order and routing show."""
    r = mesh.rank
    out = {"coords": mesh.coords, "index": {a: mesh.index(a)
                                            for a in ("data", "model")},
           "size": {a: mesh.size(a) for a in ("data", "model")}}
    t = torch.tensor([r, 10 * r, 100 * r], dtype=torch.int32)
    out["gather"] = {a: mesh.all_gather(t, a).numpy()
                     for a in ("data", "model", ("data", "model"))}
    n, me = mesh.size("model"), mesh.index("model")
    # rank at model position me sends q + 1 rows to position q
    splits = [q + 1 for q in range(n)]
    inp = torch.cat([torch.full((q + 1, 2), 1000 * me + q, dtype=torch.float32)
                     for q in range(n)])
    out["a2a"] = mesh.all_to_all_single(inp, "model", splits,
                                        [me + 1] * n).numpy()
    # a ring: send to the next model position, receive from the previous
    if n > 1:
        nxt, prv = (me + 1) % n, (me - 1) % n
        got = mesh.send_recv([(nxt, torch.full((3,), float(r)))],
                             [(prv, (3,), torch.float32)], "model")
        out["ring"] = got[0].numpy()
    out["staged"] = mesh.staged_bytes
    return out


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_mesh_collectives_route_by_axis(shape, tmp_path):
    data, model = shape
    res = ranks(_transport, data, model, tmp_path)
    grid = np.arange(data * model).reshape(data, model)
    for r, out in enumerate(res):
        dr, mr = divmod(r, model)
        assert out["coords"] == {"data": dr, "model": mr}
        assert out["index"] == {"data": dr, "model": mr}
        assert out["size"] == {"data": data, "model": model}
        # gathers come back in axis order
        for axis, members in (("data", grid[:, mr]), ("model", grid[dr]),
                              (("data", "model"), grid.reshape(-1))):
            want = np.stack([[m, 10 * m, 100 * m] for m in members])
            np.testing.assert_array_equal(out["gather"][axis], want)
        # position q of the model axis got mr + 1 rows from each sender q
        want = np.concatenate([np.full((mr + 1, 2), 1000 * q + mr)
                               for q in range(model)])
        np.testing.assert_array_equal(out["a2a"], want)
        prev = grid[dr, (mr - 1) % model]
        np.testing.assert_array_equal(out["ring"], np.full(3, float(prev)))
        assert out["staged"] == 0  # CPU tensors are never staged


def _reductions(mesh):
    """``all_reduce`` (sum, max) and ``broadcast`` over every axis, on
    values that name the rank."""
    r = mesh.rank
    t = torch.tensor([r + 0.5, -10.0 * r], dtype=torch.float32)
    out = {}
    for axis in ("data", "model", ("data", "model")):
        out[("sum", axis)] = mesh.all_reduce(t, axis).numpy()
        out[("max", axis)] = mesh.all_reduce(t, axis, "max").numpy()
        out[("bcast", axis)] = mesh.broadcast(t, axis).numpy()
    try:
        mesh.all_reduce(t, "model", "mean")
    except ValueError as e:
        out["bad_op"] = str(e)
    return out


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_all_reduce_and_broadcast_route_by_axis(shape, tmp_path):
    """Sums and maxima over an axis are the same on each of its ranks
    (one gather, reduced in axis order); a broadcast hands every rank of
    the axis the tensor of its first rank."""
    data, model = shape
    res = ranks(_reductions, data, model, tmp_path)
    grid = np.arange(data * model).reshape(data, model)
    for r, out in enumerate(res):
        dr, mr = divmod(r, model)
        for axis, members in (("data", grid[:, mr]), ("model", grid[dr]),
                              (("data", "model"), grid.reshape(-1))):
            vals = np.stack([[m + 0.5, -10.0 * m] for m in members])
            np.testing.assert_array_equal(out[("sum", axis)], vals.sum(0))
            np.testing.assert_array_equal(out[("max", axis)], vals.max(0))
            src = members[0]
            np.testing.assert_array_equal(out[("bcast", axis)],
                                          [src + 0.5, -10.0 * src])
        assert "'mean'" in out["bad_op"]


def _world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)


def test_make_host_mesh_needs_a_world_of_its_size(tmp_path):
    with pytest.raises(RuntimeError, match="initialised default process group"):
        tmesh.make_host_mesh(1, 1, device="cpu")
    _world_of_one(tmp_path)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            tmesh.make_host_mesh(2, 2, device="cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            tmesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="needs 512 ranks"):
            tmesh.make_production_mesh(multi_pod=True, device="cpu")
        one = tmesh.make_host_mesh(1, 1, device="cpu")
        assert one.shape == {"data": 1, "model": 1}
        assert one.axis_names == ("data", "model")
        assert one.backend == "gloo" and one.device == torch.device("cpu")
        t = torch.arange(3)
        assert torch.equal(one.all_gather(t, "model"), t[None])
    finally:
        dist.destroy_process_group()


def test_mesh_device_needs_a_card_unless_cpu_is_asked_for(tmp_path,
                                                          monkeypatch):
    _world_of_one(tmp_path)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _raise_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    return mesh.rank


def _hang_on_rank_one(mesh):
    if mesh.rank == 1:
        import time

        time.sleep(60)
    return mesh.rank


def test_spawn_returns_results_and_reports_a_failing_rank(tmp_path):
    assert ranks(_identity_rank, 1, 2, tmp_path / "ok") == [0, 1]
    with pytest.raises(Exception, match="rank one fails"):
        ranks(_raise_on_rank_one, 1, 2, tmp_path / "bad")
    with pytest.raises(TimeoutError):
        spawn(_hang_on_rank_one, 1, 2, backend="gloo", device="cpu",
              store_dir=tmp_path / "hang", timeout=8.0)


def _identity_rank(mesh):
    return mesh.rank
