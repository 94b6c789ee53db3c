"""The port's persistent world of ranks (``repro_torch/launch/mesh.py::
World``) over ``gloo`` on the CPU: one world of 4 ranks serves the module,
each run a fresh mesh of its shape over the same processes, held to a
fresh :func:`~repro_torch.launch.mesh.spawn` of the same function and
shape; a failing or hung rank stops the whole world, and closing it joins
every rank and removes its store. Every run has a time limit of its own.
"""
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launches, ops  # noqa: E402
from repro_torch.launch.mesh import World, spawn  # noqa: E402
from repro_torch.launch.meta_mesh import record_collectives  # noqa: E402
from test_torch_mesh import (  # noqa: E402
    _hang_on_rank_one,
    _identity_rank,
    _raise_on_rank_one,
    _reductions,
    _transport,
)

torch.set_num_threads(1)

RUN_TIMEOUT_S = 60.0
HANG_TIMEOUT_S = 5.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, backend="gloo", device="cpu",
               store_dir=tmp_path_factory.mktemp("world")) as w:
        yield w


def _fresh(fn, data, model, tmp_path):
    return spawn(fn, data, model, backend="gloo", device="cpu",
                 store_dir=Path(tmp_path) / f"fresh_{data}x{model}",
                 timeout=RUN_TIMEOUT_S)


def _assert_same(got, want, where="result"):
    """Equal nested results: dicts by key, sequences by item, arrays
    exactly."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def _routed(mesh):
    """The collectives' routed values over every axis, and the mesh's
    staged bytes."""
    return {"transport": _transport(mesh), "reductions": _reductions(mesh)}


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)],
                         ids=["1x4", "2x2", "4x1"])
def test_world_runs_each_shape_as_a_fresh_spawn(world, shape, tmp_path):
    """The module's world takes the three shapes in turn (each test a run
    after the last); each run routes as a fresh spawn of that shape."""
    got = world.run(_routed, *shape, timeout=RUN_TIMEOUT_S)
    _assert_same(got, _fresh(_routed, *shape, tmp_path))


def _dirty(mesh):
    """What an earlier run may leave behind in a rank: launches counted,
    a collective log on its mesh, the default generator moved on."""
    launches.LAUNCHES["moe_ffn"] += 1  # as a launch on the card counts
    torch.rand(5)
    log = record_collectives(mesh)
    mesh.all_reduce(torch.ones(3), "model")
    return log.stats()["total_count"]


def _state(mesh):
    """What a run reads of its rank: the routed values and staged bytes,
    the collectives a log of this mesh counts, a draw from an explicit
    generator and the launch counts."""
    out = {"transport": _transport(mesh)}
    log = record_collectives(mesh)
    mesh.all_gather(torch.arange(3), ("data", "model"))
    mesh.all_reduce(torch.ones(2), "data")
    out["collectives"] = log.stats()
    gen = torch.Generator().manual_seed(7)
    out["explicit_draw"] = torch.rand(4, generator=gen).numpy()
    out["launches"] = ops.launch_counts()
    return out


def _default_draw(mesh):
    return torch.rand(4).numpy()


def test_a_run_after_others_equals_a_fresh_run(world, tmp_path):
    before = world.run(_default_draw, 1, 4, timeout=RUN_TIMEOUT_S)
    assert world.run(_dirty, 1, 4, timeout=RUN_TIMEOUT_S) == [1] * 4
    got = world.run(_state, 2, 2, timeout=RUN_TIMEOUT_S)
    want = _fresh(_state, 2, 2, tmp_path)
    _assert_same(got, want)
    assert all(r["launches"]["moe_ffn"] == 0 for r in got)
    assert got[0]["collectives"]["total_count"] == 2
    # a new process seeds the default generator as it will; each run of
    # a rank starts it where the rank's first run did
    _assert_same(world.run(_default_draw, 4, 1, timeout=RUN_TIMEOUT_S),
                 before)


def test_a_shape_not_of_the_worlds_size_raises(world):
    with pytest.raises(ValueError, match="needs 2 ranks, the world has 4"):
        world.run(_identity_rank, 1, 2, timeout=RUN_TIMEOUT_S)
    # the world goes on
    assert world.run(_identity_rank, 4, 1,
                     timeout=RUN_TIMEOUT_S) == [0, 1, 2, 3]


def _assert_stopped(w):
    assert w.processes and not any(p.is_alive() for p in w.processes)
    with pytest.raises(RuntimeError, match="not running"):
        w.run(_identity_rank, 1, 2, timeout=RUN_TIMEOUT_S)


def test_a_failing_rank_stops_the_world_with_its_traceback(tmp_path):
    with World(2, backend="gloo", device="cpu", store_dir=tmp_path) as w:
        assert w.run(_identity_rank, 1, 2, timeout=RUN_TIMEOUT_S) == [0, 1]
        with pytest.raises(RuntimeError, match="rank one fails") as e:
            w.run(_raise_on_rank_one, 1, 2, timeout=RUN_TIMEOUT_S)
        assert "error 1 raised" in str(e.value)
        assert "Traceback" in str(e.value)
        _assert_stopped(w)


def _unpicklable_result(mesh):
    return lambda: mesh.rank


def test_a_result_that_cannot_be_pickled_fails_with_its_traceback(tmp_path):
    with World(2, backend="gloo", device="cpu", store_dir=tmp_path) as w:
        with pytest.raises(RuntimeError, match="pickle") as e:
            w.run(_unpicklable_result, 1, 2, timeout=RUN_TIMEOUT_S)
        assert "error 0 raised" in str(e.value)
        assert "Traceback" in str(e.value)
        _assert_stopped(w)


def test_a_hung_rank_times_out_and_stops_the_world(tmp_path):
    with World(2, backend="gloo", device="cpu", store_dir=tmp_path) as w:
        assert w.run(_identity_rank, 2, 1, timeout=RUN_TIMEOUT_S) == [0, 1]
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="within 5.0 s"):
            w.run(_hang_on_rank_one, 1, 2, timeout=HANG_TIMEOUT_S)
        assert time.monotonic() - t0 < HANG_TIMEOUT_S + 10.0
        _assert_stopped(w)


def test_closing_joins_every_rank_and_removes_the_store(tmp_path):
    with World(2, backend="gloo", device="cpu", store_dir=tmp_path) as w:
        assert w.run(_identity_rank, 1, 2, timeout=RUN_TIMEOUT_S) == [0, 1]
        assert (tmp_path / "store").exists()
    assert all(p.exitcode == 0 for p in w.processes)
    assert not any(tmp_path.iterdir())
