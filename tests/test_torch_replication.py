"""The port's replicated serving engine, with and without the shed plane,
against the JAX engine on mixtral smoke (``sliding_window=0`` on both
sides, so both run paged KV).

* The shed engine is the twin of ``tests/test_scan_decode.py::
  _run_shed_engine``: a zeroed router sends every token to experts 0 and
  1, ``decode_capacity_factor`` 1.5 makes the big-share copies overflow,
  one replica slot a device, ``online=True``, and the fastest believed
  device slowed mid-run. The JAX engine runs ``"scan"``, the port both
  modes: tokens, the shed-enable history, simulated latencies, the
  latency report (shed keys included), migration records, the registry
  snapshot and the exported events must be equal, with one capture.
* The one-shot replicated GEM retarget: tokens, the pool's rows, the
  replica tables, the live layouts and the ``audit.retarget`` event.
* ``auto_slots`` resolves the same ``replica_slots`` as JAX, and the
  engine refuses what JAX refuses with the same ``ValueError``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.online as jonline  # noqa: E402
import repro.replication as jrep  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro.telemetry as jtelemetry  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.online as tonline  # noqa: E402
import repro_torch.replication as trep  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
import repro_torch.telemetry as ttelemetry  # noqa: E402
from test_torch_bridge import smoke_configs  # noqa: E402
from test_torch_graph import NoHostSync  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

torch.set_num_threads(1)

ARCH = "mixtral-8x7b"
NUM_DEVICES = 4
PACKAGES = {
    "jax": (jcore, jonline, jrep, jserving, jtelemetry),
    "port": (tcore, tonline, trep, tserving, ttelemetry),
}
PORT = ["scan", "python"]


def _params(jcfg, tcfg, *, zero_router):
    params, _ = jax_init_params(jcfg, jax.random.PRNGKey(0), host_policy(),
                                jnp.float32)
    if zero_router:  # tied logits: every token's top-2 is experts 0 and 1
        moe = dict(params["blocks"]["moe"])
        moe["router"] = jnp.zeros_like(moe["router"])
        params = {**params, "blocks": {**params["blocks"], "moe": moe}}
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu", torch.float32)
    return params, tparams


def _profile(core, speeds):
    fleet = core.DeviceFleet.from_speeds(
        np.asarray(speeds, dtype=np.float64), tile=1, tile_time=50e-6,
        base=10e-6)
    return core.profile_fleet(
        core.simulator_measure_fn(fleet, seed=0), NUM_DEVICES,
        max_tokens=64, tile=1, repeats=5).profile


BELIEVED = [0.6, 0.8, 1.0, 1.3]
TRUE_SPEEDS = [0.6, 0.8, 1.0, 0.5]  # the believed-fastest device slowed 2.6x


def _shed_knobs(pkg, mode, *, shed=True):
    core, online, rep, serving, _ = PACKAGES[pkg]
    return dict(
        max_batch=16, max_len=96, decode_mode=mode,
        gem=core.GEMConfig(trace_length=8, num_restarts=4),
        other_time_per_step=1e-4, online=True,
        drift=online.DriftConfig(min_steps=4, threshold=100.0,
                                 var_threshold=2.0),
        migration=online.MigrationConfig(max_moves_per_step=2,
                                         base_overhead=0.0),
        replan_cooldown=8, payback_horizon=100_000,
        replication=rep.ReplicationConfig(
            replica_slots=1, exclude_speed_below=0.0, consistent_only=False),
        shed=serving.ShedConfig(enabled=shed, min_overflow=1,
                                drop_penalty_s=0.01),
    )


def _run_shed_engine(pkg, mode, jparams, tparams, cfgs):
    core, _, _, serving, telemetry = PACKAGES[pkg]
    jcfg, tcfg = cfgs
    kwargs = dict(profile=_profile(core, BELIEVED), num_devices=NUM_DEVICES,
                  telemetry=telemetry.Telemetry())
    ecfg = serving.EngineConfig(**_shed_knobs(pkg, mode))
    if pkg == "jax":
        eng = serving.ServingEngine(jparams, jcfg, host_policy(), ecfg,
                                    **kwargs)
    else:
        eng = serving.ServingEngine(_clone(tparams), tcfg, ecfg,
                                    device="cpu", **kwargs)
    counts = []  # each decode step's (L,) overflow, shed, dropped counts
    shed_step = eng._shed_step

    def recorded(counts_virt, moe_aux, cost_mx):
        counts.append(tuple(np.asarray(getattr(moe_aux, n)).tolist() for n in
                            ("overflow_tokens", "shed_tokens",
                             "dropped_tokens")))
        return shed_step(counts_virt, moe_aux, cost_mx)

    eng._shed_step = recorded
    rng = np.random.default_rng(17)
    for _ in range(16):
        eng.submit(rng.integers(0, jcfg.vocab_size, size=8), 24)
    history, steps = [], 0
    while eng.scheduler.has_work() and steps < 120:
        if steps == 12:
            eng.set_true_profile(_profile(core, TRUE_SPEEDS))
        eng.step()
        steps += 1
        history.append(eng.shed_enables.tolist())
    return eng, history, counts


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _tokens(eng):
    return {r.uid: list(r.generated) for r in eng.finished}


@pytest.fixture(scope="module")
def shed_runs():
    cfgs = smoke_configs(ARCH, sliding_window=0, decode_capacity_factor=1.5)
    jparams, tparams = _params(*cfgs, zero_router=True)
    return {(pkg, mode): _run_shed_engine(pkg, mode, jparams, tparams, cfgs)
            for pkg, mode in (("jax", "scan"), ("port", "scan"),
                              ("port", "python"))}


@pytest.mark.parametrize("mode", PORT)
def test_shed_engine_matches_jax(shed_runs, mode):
    jeng, jhist, _ = shed_runs["jax", "scan"]
    teng, thist, _ = shed_runs["port", mode]
    assert _tokens(teng) and _tokens(teng) == _tokens(jeng)
    assert thist == jhist and any(any(h) for h in thist)
    assert teng.step_count == jeng.step_count
    assert teng.sim_step_latencies == jeng.sim_step_latencies
    assert teng.migration_records == jeng.migration_records
    assert teng.controller.replans == jeng.controller.replans
    assert teng.graph_capture_counts == {
        "decode": int(mode == "scan"), "prefill": 0, "migrate": 0}
    assert teng.current_rplacements[0].num_slots == 2 * NUM_DEVICES


@pytest.mark.parametrize("mode", PORT)
def test_shed_engine_reports_match_jax(shed_runs, mode):
    jeng, _, _ = shed_runs["jax", "scan"]
    teng, _, _ = shed_runs["port", mode]
    ours, ref = teng.latency_report(), jeng.latency_report()
    assert ours.keys() == ref.keys()
    assert ours["shed_tokens"] > 0 and ours["shed_overflow_tokens"] > 0
    assert ours == {k: pytest.approx(ref[k], rel=1e-12) for k in ref}
    theirs = jeng.telemetry.registry.snapshot()
    for kind, named in theirs.items():
        if isinstance(named, dict):
            theirs[kind] = {k: v for k, v in named.items()
                            if not k.startswith("jit.trace.")}
    assert teng.telemetry.registry.snapshot() == theirs

    def events(eng):
        return [json.dumps(ev, sort_keys=True) for ev in eng.telemetry.events]

    ours_ev = events(teng)
    assert any('"shed.recv"' in e for e in ours_ev)
    assert ours_ev == events(jeng)


@pytest.mark.parametrize("mode", PORT)
def test_shed_engine_layout_matches_jax(shed_runs, mode):
    jeng, _, _ = shed_runs["jax", "scan"]
    teng, _, _ = shed_runs["port", mode]
    for ours, ref in zip(teng.current_rplacements, jeng.current_rplacements):
        np.testing.assert_array_equal(ours.slot_to_expert, ref.slot_to_expert)
        np.testing.assert_array_equal(ours.shares, ref.shares)
    np.testing.assert_array_equal(teng.placements.numpy(),
                                  np.asarray(jeng.placements))
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            teng.params["blocks"]["moe"][name].numpy(),
            np.asarray(jeng.params["blocks"]["moe"][name]), err_msg=name)


@pytest.mark.parametrize("mode", PORT)
def test_shed_step_counts_match_jax(shed_runs, mode):
    """Each decode step's (L,) overflow, shed and dropped counts equal the
    JAX engine's, with dropped = overflow − shed, and some steps shed."""
    _, _, want = shed_runs["jax", "scan"]
    _, _, got = shed_runs["port", mode]
    assert got == want
    assert any(sum(shed) > 0 for _, shed, _ in got)
    for overflow, shed, dropped in got:
        assert dropped == [o - s for o, s in zip(overflow, shed)]


def _shed_op_counts(eng):
    """Sort and cumsum ops of one decode step (the shed pass adds a
    waterfall argsort, a rank and two cumsums a layer)."""
    seen = {"sort": 0, "cumsum": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__
            for key in seen:
                if name.startswith(key):
                    seen[key] += 1
            return func(*args, **(kwargs or {}))

    graph = eng.decode_graph
    with Count():
        graph._body()
    return seen


def test_shed_off_step_holds_no_shed_operation():
    cfgs = smoke_configs(ARCH, sliding_window=0, decode_capacity_factor=1.5)
    _, tparams = _params(*cfgs, zero_router=True)
    engines = {}
    for shed in (False, True):
        knobs = _shed_knobs("port", "scan", shed=shed)
        engines[shed] = tserving.ServingEngine(
            _clone(tparams), cfgs[1], tserving.EngineConfig(**knobs),
            profile=_profile(tcore, BELIEVED), num_devices=NUM_DEVICES,
            device="cpu")
    off, on = (_shed_op_counts(engines[s]) for s in (False, True))
    L = cfgs[1].num_layers
    assert engines[False].decode_graph.shed_enables is None
    assert on["sort"] - off["sort"] == 3 * L  # waterfall + two rank sorts
    assert on["cumsum"] - off["cumsum"] == 2 * L  # cumfree + the rank's
    # the replicated shed step reads nothing back to the host
    eng = engines[True]
    graph = eng.decode_graph
    with NoHostSync():
        eng._decode(eng.params, eng.caches, np.zeros(16, np.int32),
                    np.zeros((16, 1), np.int32), eng.config, eng.placements,
                    block_tables=np.zeros((16, graph.n_max), np.int32),
                    shed_enables=np.ones(L, np.int32))


# --------------------------------------------------------- one-shot retarget
def _retarget_knobs(pkg):
    core, _, rep, _, _ = PACKAGES[pkg]
    return dict(
        max_batch=4, max_len=64,
        gem=core.GEMConfig(trace_length=8, num_restarts=4),
        other_time_per_step=1e-4, placement_policy="gem",
        replication=rep.ReplicationConfig(replica_slots=2),
    )


@pytest.fixture(scope="module")
def retarget_runs():
    cfgs = smoke_configs(ARCH, sliding_window=0, capacity_factor=8.0,
                         decode_capacity_factor=8.0)
    jparams, tparams = _params(*cfgs, zero_router=False)
    out = {}
    for pkg in ("jax", "port"):
        core, _, _, serving, telemetry = PACKAGES[pkg]
        speeds = core.setup_speeds("high", NUM_DEVICES)
        fleet = core.DeviceFleet.from_speeds(speeds, tile=1, tile_time=50e-6)
        profile = core.profile_fleet(
            core.simulator_measure_fn(fleet), NUM_DEVICES, max_tokens=64,
            tile=1, repeats=5).profile
        ecfg = serving.EngineConfig(**_retarget_knobs(pkg))
        kwargs = dict(profile=profile, num_devices=NUM_DEVICES,
                      telemetry=telemetry.Telemetry())
        if pkg == "jax":
            eng = serving.ServingEngine(jparams, cfgs[0], host_policy(), ecfg,
                                        **kwargs)
        else:
            eng = serving.ServingEngine(tparams, cfgs[1], ecfg, device="cpu",
                                        **kwargs)
        init_tables = np.asarray(eng.placements).copy()
        rng = np.random.default_rng(1)
        for _ in range(4):
            eng.submit(rng.integers(0, cfgs[0].vocab_size, size=10), 14)
        eng.run(max_steps=100)
        out[pkg] = (eng, init_tables)
    return out


def test_replicated_retarget_matches_jax(retarget_runs):
    jeng, jinit = retarget_runs["jax"]
    teng, tinit = retarget_runs["port"]
    np.testing.assert_array_equal(tinit, jinit)  # the installed linear pool
    assert _tokens(teng) and _tokens(teng) == _tokens(jeng)
    assert teng.placement_applied and jeng.placement_applied
    (rec,) = teng.migration_records
    assert teng.migration_records == jeng.migration_records
    assert 0 < rec["step"] < teng.step_count - 1 and rec["moves"] > 0
    assert teng.sim_step_latencies == jeng.sim_step_latencies
    s2e = np.stack([rp.slot_to_expert for rp in teng.current_rplacements])
    want = np.stack([rp.slot_to_expert for rp in jeng.current_rplacements])
    np.testing.assert_array_equal(s2e, want)
    S = s2e.shape[1]
    assert S == teng.config.num_experts + NUM_DEVICES * 2
    linear = trep.ReplicatedPlacement.linear(
        teng.config.num_experts, NUM_DEVICES, 2).slot_to_expert
    assert (s2e != linear).any(axis=1).all()  # every layer moved
    np.testing.assert_array_equal(teng.placements.numpy(),
                                  np.asarray(jeng.placements))
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            teng.params["blocks"]["moe"][name].numpy(),
            np.asarray(jeng.params["blocks"]["moe"][name]), err_msg=name)
    ours, ref = teng.latency_report(), jeng.latency_report()
    assert ours.keys() == ref.keys()
    assert ours == {k: pytest.approx(ref[k], rel=1e-12) for k in ref}


def test_retarget_audit_event_matches_jax(retarget_runs):
    def retargets(eng):
        return [json.dumps(ev, sort_keys=True) for ev in eng.telemetry.events
                if ev.get("name") == "audit.retarget"]

    ours = retargets(retarget_runs["port"][0])
    assert len(ours) == 1
    assert ours == retargets(retarget_runs["jax"][0])


# ------------------------------------------------------ auto_slots, refusals
@pytest.mark.parametrize("budget_mib", [0.0, 0.5, 3.0])
def test_auto_slots_resolve_like_jax(budget_mib):
    jcfg, tcfg = smoke_configs(ARCH, sliding_window=0)
    jparams, tparams = _params(jcfg, tcfg, zero_router=False)
    slots = {}
    for pkg in ("jax", "port"):
        core, _, rep, serving, _ = PACKAGES[pkg]
        profile = _profile(core, BELIEVED)
        ecfg = serving.EngineConfig(
            max_batch=2, max_len=32, hbm_budget_bytes=budget_mib * 2 ** 20,
            replication=rep.ReplicationConfig(auto_slots=True))
        if pkg == "jax":
            eng = serving.ServingEngine(jparams, jcfg, host_policy(), ecfg,
                                        profile=profile, num_devices=4)
        else:
            eng = serving.ServingEngine(tparams, tcfg, ecfg, profile=profile,
                                        num_devices=4, device="cpu")
        slots[pkg] = eng.ecfg.replication.replica_slots
        assert not eng.ecfg.replication.auto_slots
        w = eng.params["blocks"]["moe"]["w_gate"]
        assert int(w.shape[1]) == jcfg.num_experts + 4 * slots[pkg]
    assert slots["port"] == slots["jax"]
    assert (slots["port"] > 0) == (budget_mib > 0)


# case → (EngineConfig knobs, whether a profile is attached)
REFUSALS = {
    "shed-without-replicas": (dict(shed="on"), True),
    "shed-without-profile": (dict(shed="on", replica_slots=1), False),
    "replicas-without-profile": (dict(replica_slots=1), False),
    "replicas-under-eplb": (dict(replica_slots=1, placement_policy="eplb"),
                            True),
    "auto-slots-without-budget": (dict(auto_slots=True), True),
}


def _refusal_config(pkg, knobs):
    _, _, rep, serving, _ = PACKAGES[pkg]
    return serving.EngineConfig(
        max_batch=2, max_len=32,
        placement_policy=knobs.get("placement_policy", "gem"),
        replication=rep.ReplicationConfig(
            replica_slots=knobs.get("replica_slots", 0),
            auto_slots=knobs.get("auto_slots", False)),
        shed=serving.ShedConfig(enabled=knobs.get("shed") == "on"))


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    knobs, with_profile = REFUSALS[case]
    jcfg, tcfg = smoke_configs(ARCH, sliding_window=0)
    jparams, tparams = _params(jcfg, tcfg, zero_router=False)
    messages = {}
    for pkg in ("jax", "port"):
        core = PACKAGES[pkg][0]
        profile = _profile(core, BELIEVED) if with_profile else None
        ecfg = _refusal_config(pkg, knobs)
        with pytest.raises(ValueError) as err:
            if pkg == "jax":
                jserving.ServingEngine(jparams, jcfg, host_policy(), ecfg,
                                       profile=profile, num_devices=4)
            else:
                tserving.ServingEngine(tparams, tcfg, ecfg, profile=profile,
                                       num_devices=4, device="cpu")
        messages[pkg] = str(err.value)
    assert messages["port"] == messages["jax"]


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_mixtral_config_copy_equals_jax(which):
    if which == "full":
        ours, ref = get_config(ARCH), jax_get_config(ARCH)
    else:
        ours, ref = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.num_virtual_experts == ref.num_experts * ref.expert_tp
    assert ours.param_count() == ref.param_count()


def test_mixtral_smoke_serves_on_the_port():
    """The smoke config's sliding window is served on the dense KV ring
    under ``kv_mode="auto"``; forcing the paged cache refuses it, and with
    the window off ``"auto"`` pages."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="sliding"):
        tserving.ServingEngine(params, cfg, tserving.EngineConfig(
            max_batch=2, max_len=32, kv_mode="paged"), device="cpu")
    for window, paged in ((cfg.sliding_window, False), (0, True)):
        wcfg = dataclasses.replace(cfg, sliding_window=window)
        eng = tserving.ServingEngine(params, wcfg, tserving.EngineConfig(
            max_batch=2, max_len=32), device="cpu")
        assert eng.paged is paged
        eng.submit(np.arange(5), max_new_tokens=3)
        assert len(eng.run()[0].generated) == 3
