"""The port's GEM core against the JAX package's, on the same seeded inputs.

``repro_torch.core``, ``repro_torch.telemetry``, ``repro_torch.replication``
and ``repro_torch.online`` are verbatim copies of their ``repro`` packages
(numpy and the standard library only), as are ``repro_torch.serving.shed``
and ``repro_torch.training.data``,
pinned byte for byte here, so the
planner's outputs must be equal, not close: placements, scores, swap
counts, the EPLB baseline, the per-step cost and token matrices, the
profile and the migration cost. The port's host migration executable is
held bit for bit against the JAX ``MigrationExecutable(mesh=None)``, and
it copies only the rows that move.
"""
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.kernels.collective import (  # noqa: E402
    MigrationExecutable as JaxMigrationExecutable,
)
from repro.online.migration import MigrationConfig as JaxMigrationConfig  # noqa: E402
from repro_torch.kernels.collective import MigrationExecutable  # noqa: E402
from repro_torch.online import MigrationConfig  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MODULES = ["types", "trace", "latency_model", "variability", "profiling",
           "score", "search", "eplb", "gem", "classify", "workload",
           "simulate"]
# the other control-plane packages the port copies whole (``__init__`` too)
COPIED = {
    "telemetry": ["registry", "spans", "audit", "export", "attribution",
                  "regret", "__init__"],
    "replication": ["types", "score", "planner", "__init__"],
    "online": ["drift", "migration", "controller", "replay", "__init__"],
}
PINNED = [pytest.param("core", name, id=name) for name in MODULES] + [
    pytest.param(pkg, name, id=f"{pkg}/{name}")
    for pkg, names in COPIED.items() for name in names
] + [
    # single modules of packages the port keeps its own versions of
    pytest.param("serving", "shed", id="serving/shed"),
    pytest.param("training", "data", id="training/data"),
]
NUM_DEVICES = 4


@pytest.mark.parametrize("package, name", PINNED)
def test_core_module_is_a_verbatim_copy(package, name):
    ours = (ROOT / "src" / "repro_torch" / package / f"{name}.py").read_bytes()
    ref = (ROOT / "src" / "repro" / package / f"{name}.py").read_bytes()
    assert ours == ref


@pytest.mark.parametrize("package", sorted(COPIED))
def test_copied_package_holds_every_module(package):
    def names(root):
        return sorted(p.stem for p in (root / package).glob("*.py"))

    assert names(ROOT / "src" / "repro_torch") == names(ROOT / "src" / "repro")
    assert names(ROOT / "src" / "repro") == sorted(COPIED[package])


def test_core_exports_what_the_jax_core_exports():
    assert tcore.__all__ == jcore.__all__
    assert all(hasattr(tcore, name) for name in tcore.__all__)


def _inputs(core, num_experts):
    """Per-layer traces and a 4-device profile, made by ``core``."""
    spec = core.WorkloadSpec(
        num_experts=num_experts, top_k=2 if num_experts == 16 else 8,
        tokens_per_step=64,
    )
    traces = core.generate_layer_traces(spec, 2, 16, seed=3, identity_seed=1)
    fleet = core.DeviceFleet.from_speeds(
        core.setup_speeds("high", NUM_DEVICES), tile=8, tile_time=40e-6,
    )
    profile = core.profile_fleet(
        core.simulator_measure_fn(fleet), NUM_DEVICES,
        max_tokens=512, tile=8, repeats=5,
    ).profile
    return traces, profile


def _outputs(core, num_experts, what):
    traces, profile = _inputs(core, num_experts)
    if what == "profile":
        return [profile.token_counts, profile.latencies,
                np.asarray(profile.tile_size)]
    if what == "gem_place":
        cfg = core.GEMConfig(num_restarts=3)
        out = []
        for trace in traces:
            res = core.gem_place(trace, profile, cfg)
            out += [res.placement.slot_to_expert(), np.asarray(res.score),
                    np.asarray(res.restart_scores),
                    np.asarray(res.swaps_per_restart),
                    np.asarray(res.initial_score)]
        return out
    if what == "eplb":
        return [core.eplb_placement(t, NUM_DEVICES).slot_to_expert()
                for t in traces]
    placements = [core.eplb_placement(t, NUM_DEVICES) for t in traces]
    if what == "step_matrices":
        out = []
        for step in range(traces[0].num_steps):
            counts = np.stack([t.counts[step] for t in traces])
            out += [core.step_cost_matrix(counts, profile, placements),
                    core.step_token_matrix(counts, NUM_DEVICES, placements)]
        return out
    assert what == "migration_cost"
    moves = sum(len(core.Placement.linear(num_experts, NUM_DEVICES)
                    .moved_slots(p)) for p in placements)
    return [np.asarray(moves),
            np.asarray(core.MigrationCostModel.for_expert_dims(
                1536, 256).cost(moves))]


@pytest.mark.parametrize(
    "what",
    ["profile", "gem_place", "eplb", "step_matrices", "migration_cost"],
)
@pytest.mark.parametrize("num_experts", [16, 80])
def test_planner_outputs_equal_jax(num_experts, what):
    ours = _outputs(tcore, num_experts, what)
    ref = _outputs(jcore, num_experts, what)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_migration_config_prices_like_jax():
    for dims in ((1536, 256, 2), (64, 96, 4)):
        d, f, nbytes = dims
        ours = MigrationConfig().cost_model_for_dims(d, f, bytes_per_param=nbytes)
        ref = JaxMigrationConfig().cost_model_for_dims(
            d, f, bytes_per_param=nbytes)
        assert ours.cost(37) == ref.cost(37)
        assert ours.expert_bytes == ref.expert_bytes


def _source_map(kind, L, S, rng):
    src = np.tile(np.arange(S, dtype=np.int32), (L, 1))
    if kind == "permutation":
        src = np.stack([rng.permutation(S) for _ in range(L)])
        src[1] = np.arange(S)  # an untouched layer passes through
        return src.astype(np.int32)
    if kind == "swaps":
        # an online batch: k = 3 disjoint two-slot swaps over two of the
        # three layers
        for layer, a, b in ((0, 1, 6), (0, 2, 4), (2, 0, 7)):
            src[layer, [a, b]] = src[layer, [b, a]]
        return src
    if kind == "broadcast":
        # a replica broadcast: one row copied onto two other slots
        src[0, [1, 5]] = 3
    return src  # identity: no slot moves


class _RowCopies(TorchDispatchMode):
    """Counts the aten ops a call dispatches, the ops that read or write
    the weights' storage, and the rows that each ``index_copy_`` writes."""

    def __init__(self, weights):
        super().__init__()
        self.storages = {w.untyped_storage().data_ptr() for w in weights}
        self.ops = Counter()
        self.weight_ops = Counter()
        self.rows = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        if any(isinstance(a, torch.Tensor)
               and a.untyped_storage().data_ptr() in self.storages
               for a in args):
            self.weight_ops[name] += 1
        if name == "index_copy_":
            self.rows += int(args[2].numel())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind",
                         ["permutation", "broadcast", "identity", "swaps"])
def test_migration_executable_matches_jax(kind):
    L, S, D, F = 3, 8, 4, 6
    rng = np.random.default_rng(11)
    ws = [rng.standard_normal(shape).astype(np.float32)
          for shape in ((L, S, D, F), (L, S, D, F), (L, S, F, D))]
    tables = np.stack([rng.permutation(S) for _ in range(L)]).astype(np.int32)
    src = _source_map(kind, L, S, rng)
    with_tables = kind != "broadcast"  # the table swap needs a permutation

    (jws, jtables) = JaxMigrationExecutable(mesh=None, donate=False)(
        src, jnp.asarray(tables) if with_tables else None,
        *(jnp.asarray(w) for w in ws),
    )
    tws = [torch.from_numpy(w.copy()) for w in ws]
    with _RowCopies(tws) as seen:
        out, ttables = MigrationExecutable()(
            src, torch.from_numpy(tables) if with_tables else None, *tws)
    assert all(a is b for a, b in zip(out, tws))  # rewritten in place
    # only the moved rows are copied, each weight once: a k-swap batch
    # writes 2k rows per weight, an identity map issues no copy at all
    moves = src != np.arange(S)
    assert moves.sum() == {"identity": 0, "swaps": 6}.get(kind, moves.sum())
    assert seen.rows == 3 * moves.sum()
    touched = 3 * int(moves.any(axis=1).sum())  # (layer, weight) pairs
    assert seen.ops["index_copy_"] == seen.ops["index_select"] == touched
    if kind == "identity":
        assert not seen.weight_ops, seen.weight_ops
    else:  # views of the weights as words, and per touched layer and
        # weight one gather and one write
        views = {"view", "detach", "select"}
        assert set(seen.weight_ops) - views == {"index_select",
                                                "index_copy_"}, seen.weight_ops
        assert seen.weight_ops["index_copy_"] == touched
    for got, want in zip(out, jws):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if with_tables:
        assert ttables.dtype == torch.int32
        np.testing.assert_array_equal(ttables.numpy(), np.asarray(jtables))
    else:
        assert ttables is None and jtables is None


def test_migration_executable_refuses_bad_source_maps():
    w = torch.zeros((2, 4, 3, 5))
    mig = MigrationExecutable()
    with pytest.raises(ValueError, match="lie in"):
        mig(np.full((2, 4), 4), None, w, w, w)
    with pytest.raises(ValueError, match="do not match"):
        mig(np.zeros((2, 3), np.int32), None, w, w, w)
    with pytest.raises(ValueError, match=r"\(L, S\)"):
        mig(np.zeros(4, np.int32), None, w, w, w)
