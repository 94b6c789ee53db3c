"""The port's migration accounting and ``migration_via="collective"`` on one
card, against the JAX package.

* ``kernels/collective.py``: ``stats_for_dense_sources`` and
  ``CollectiveStats`` give JAX's stats on seeded (L, S) row-source maps
  (swaps, cycles, broadcasts, identity layers) for G ∈ {2, 4} shards.
* ``models/moe.py::apply_layer_permutation`` gives JAX's rows for both
  ``via``s; ``"collective"`` warns once and takes the host gather, as JAX
  does without a live expert axis.
* The engine with ``migration_via="collective"`` serves the online stream
  of ``tests/test_torch_online.py`` as the JAX engine with
  ``migration_via="collective"`` does (``host_policy()``: no mesh), in both
  decode modes: tokens, latencies, migration records (``"via": "host"``),
  replans, the latency report and the registry.
* ``set_true_interconnect`` on the shed scenario of
  ``tests/test_torch_replication.py`` moves the shed pass's transfer
  charge as it does in JAX: equal reports, and the charge scaled by the
  believed over the injected bandwidth.
* ``_record_migration``'s measured branch (which one card never reaches on
  its own) fed the same ``CollectiveStats`` gives JAX's record, charge,
  counters and controller measurement, with and without an injected
  interconnect.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.kernels.collective as jcoll  # noqa: E402
import repro.online as jonline  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro.telemetry as jtelemetry  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.kernels.collective as tcoll  # noqa: E402
import repro_torch.models.moe as tmoe  # noqa: E402
import repro_torch.online as tonline  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
import repro_torch.telemetry as ttelemetry  # noqa: E402
import test_torch_online as online_case  # noqa: E402
import test_torch_replication as shed_case  # noqa: E402
from test_torch_bridge import placed_params, smoke_configs  # noqa: E402
from repro.models.moe import apply_layer_permutation as jax_apply_perm  # noqa: E402
from repro.models.moe import init_moe as jax_init_moe  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

torch.set_num_threads(1)


def _maps(L: int, S: int, seed: int) -> np.ndarray:
    """(L, S) row-source maps: identity, a random permutation, a swap, a
    3-cycle and a one-to-many broadcast layer."""
    rng = np.random.default_rng(seed)
    src = np.tile(np.arange(S, dtype=np.int32), (L, 1))
    src[1] = rng.permutation(S)
    src[2, [0, S - 1]] = src[2, [S - 1, 0]]
    a, b, c = rng.choice(S, 3, replace=False)
    src[3, [a, b, c]] = [b, c, a]
    src[4, rng.choice(S, 3, replace=False)] = rng.integers(0, S)
    return src


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_for_dense_sources_match_jax(shards, seed):
    src = _maps(6, 16, seed)
    ours = tcoll.stats_for_dense_sources(src, shards, row_bytes=3 * 512)
    theirs = jcoll.stats_for_dense_sources(src, shards, row_bytes=3 * 512)
    assert [(layer, dataclasses.asdict(s)) for layer, s in ours] == \
        [(layer, dataclasses.asdict(s)) for layer, s in theirs]
    assert [layer for layer, _ in ours] == [1, 2, 3, 4]
    total, jtotal = tcoll.CollectiveStats.zero(), jcoll.CollectiveStats.zero()
    for (_, s), (_, js) in zip(ours, theirs):
        total, jtotal = total + s, jtotal + js
    assert dataclasses.asdict(total) == dataclasses.asdict(jtotal)
    assert total.payload_bytes == total.cross_rows * 3 * 512 > 0


@pytest.mark.parametrize("via", ["host", "collective"])
def test_apply_layer_permutation_matches_jax(via, monkeypatch):
    jcfg, tcfg = smoke_configs()
    jp, _ = jax_init_moe(jax.random.PRNGKey(4), jcfg, num_layers=2,
                         dtype=jnp.float32, policy=host_policy())
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    perm = np.random.default_rng(5).permutation(tcfg.num_virtual_experts)
    monkeypatch.setattr(tmoe, "_WARNED", set())
    stats = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ours = tmoe.apply_layer_permutation(tp, 1, perm, via=via,
                                            stats_out=stats)
        again = tmoe.apply_layer_permutation(ours, 0, perm, via=via)
    mine = [w for w in caught if "apply_layer_permutation" in str(w.message)]
    assert len(mine) == (1 if via == "collective" else 0)
    assert stats == []  # one card ships nothing over an interconnect
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = jax_apply_perm(jp, 1, perm, via=via)
        theirs_again = jax_apply_perm(theirs, 0, perm, via=via)
    for name in ("w_gate", "w_up", "w_down", "router"):
        np.testing.assert_array_equal(ours[name].numpy(),
                                      np.asarray(theirs[name]), err_msg=name)
        np.testing.assert_array_equal(again[name].numpy(),
                                      np.asarray(theirs_again[name]))
    # the input dict is left as it was
    np.testing.assert_array_equal(tp["w_gate"].numpy(),
                                  np.asarray(jp["w_gate"]))
    with pytest.raises(ValueError, match="via"):
        tmoe.apply_layer_permutation(tp, 0, perm, via="nvlink")


@pytest.fixture(scope="module")
def collective_runs():
    """fig23's burst/gem-online stream (``test_torch_online``'s) on the JAX
    engine and the port's, all with ``migration_via="collective"``, and
    the port's ``"host"`` run for reference."""
    jcfg, tcfg = smoke_configs(expert_tp=2, decode_capacity_factor=4.0)
    jparams, tparams, _ = placed_params(jcfg, tcfg, seed=3)
    jbelieved, _ = online_case._profiles(jcore)
    tbelieved, _ = online_case._profiles(tcore)
    kv = dict(block_size=4, num_blocks=40, watermark_blocks=1)
    out = {"jax": online_case._serve(jonline, jserving.ServingEngine(
        jparams, jcfg, host_policy(),
        jserving.EngineConfig(**online_case._knobs(jcore, jonline, "scan"),
                              kv=jserving.PagedKVConfig(**kv),
                              migration_via="collective"),
        profile=jbelieved, num_devices=online_case.NUM_DEVICES,
        telemetry=jtelemetry.Telemetry(),
    ), jcfg.vocab_size)}
    for name, mode, via in (("scan", "scan", "collective"),
                            ("python", "python", "collective"),
                            ("host", "scan", "host")):
        out[name] = online_case._serve(tonline, tserving.ServingEngine(
            online_case._clone(tparams), tcfg,
            tserving.EngineConfig(**online_case._knobs(tcore, tonline, mode),
                                  kv=tserving.PagedKVConfig(**kv),
                                  migration_via=via),
            profile=tbelieved, num_devices=online_case.NUM_DEVICES,
            telemetry=ttelemetry.Telemetry(), device="cpu",
        ), tcfg.vocab_size)
    return out


def _registry(eng):
    snap = eng.telemetry.registry.snapshot()
    for kind, named in snap.items():
        if isinstance(named, dict):
            snap[kind] = {k: v for k, v in named.items()
                          if not k.startswith("jit.trace.")}
    return snap


@pytest.mark.parametrize("mode", ["scan", "python"])
def test_collective_engine_matches_jax(collective_runs, mode):
    jeng, teng = collective_runs["jax"], collective_runs[mode]
    assert teng.ecfg.migration_via == "collective"
    assert online_case._tokens(teng) == online_case._tokens(jeng)
    assert teng.sim_step_latencies == jeng.sim_step_latencies
    assert teng.migration_records == jeng.migration_records
    assert len(teng.migration_records) >= 2
    assert all(r["via"] == "host" and "measured_s" not in r
               for r in teng.migration_records)
    assert teng.controller.replans == jeng.controller.replans
    ours, ref = teng.latency_report(), jeng.latency_report()
    assert ours == {k: pytest.approx(ref[k], rel=1e-12) for k in ref}
    assert _registry(teng) == _registry(jeng)


def test_collective_equals_host_on_one_card(collective_runs):
    coll, host = collective_runs["scan"], collective_runs["host"]
    assert online_case._tokens(coll) == online_case._tokens(host)
    assert coll.migration_records == host.migration_records
    for name in ("w_gate", "w_up", "w_down"):
        assert torch.equal(coll.params["blocks"]["moe"][name],
                           host.params["blocks"]["moe"][name])
    assert torch.equal(coll.placements, host.placements)


TRUE_BANDWIDTH = 2.5e9  # the injected fabric, slower than the believed one


def _shed_run(pkg, jparams, tparams, cfgs, bandwidth):
    core, _, _, serving, telemetry = shed_case.PACKAGES[pkg]
    jcfg, tcfg = cfgs
    kwargs = dict(profile=shed_case._profile(core, shed_case.BELIEVED),
                  num_devices=shed_case.NUM_DEVICES,
                  telemetry=telemetry.Telemetry())
    ecfg = serving.EngineConfig(**shed_case._shed_knobs(pkg, "scan"))
    if pkg == "jax":
        eng = serving.ServingEngine(jparams, jcfg, host_policy(), ecfg,
                                    **kwargs)
    else:
        eng = serving.ServingEngine(shed_case._clone(tparams), tcfg, ecfg,
                                    device="cpu", **kwargs)
    if bandwidth is not None:
        eng.set_true_interconnect(bandwidth)
    rng = np.random.default_rng(17)
    for _ in range(16):
        eng.submit(rng.integers(0, jcfg.vocab_size, size=8), 24)
    steps = 0
    while eng.scheduler.has_work() and steps < 120:
        if steps == 12:
            eng.set_true_profile(shed_case._profile(core,
                                                    shed_case.TRUE_SPEEDS))
        eng.step()
        steps += 1
    return eng


def test_true_interconnect_moves_the_shed_charge_as_in_jax():
    cfgs = smoke_configs(shed_case.ARCH, sliding_window=0,
                         decode_capacity_factor=1.5)
    jparams, tparams = shed_case._params(*cfgs, zero_router=True)
    jeng = _shed_run("jax", jparams, tparams, cfgs, TRUE_BANDWIDTH)
    teng = _shed_run("port", jparams, tparams, cfgs, TRUE_BANDWIDTH)
    base = _shed_run("port", jparams, tparams, cfgs, None)
    assert teng.true_interconnect == dataclasses.replace(
        teng._cost_model, bandwidth=TRUE_BANDWIDTH)
    assert dataclasses.asdict(teng.true_interconnect) == \
        dataclasses.asdict(jeng.true_interconnect)
    assert teng.true_interconnect.bandwidth < teng._cost_model.bandwidth
    ours, ref = teng.latency_report(), jeng.latency_report()
    assert ours == {k: pytest.approx(ref[k], rel=1e-12) for k in ref}
    assert teng.sim_step_latencies == jeng.sim_step_latencies
    assert shed_case._tokens(teng) == shed_case._tokens(jeng)
    # the gate keeps pricing with the believed fabric, so the same tokens
    # shed; only their transfer is charged at the injected bandwidth
    rep_base = base.latency_report()
    assert ours["shed_tokens"] == rep_base["shed_tokens"] > 0
    scale = base._measure_interconnect.bandwidth / TRUE_BANDWIDTH
    assert ours["shed_transfer_s"] == pytest.approx(
        rep_base["shed_transfer_s"] * scale, rel=1e-12)


def _online_engines():
    jcfg, tcfg = smoke_configs(expert_tp=2)
    jparams, tparams, _ = placed_params(jcfg, tcfg, seed=3)
    jprof, _ = online_case._profiles(jcore)
    tprof, _ = online_case._profiles(tcore)
    # half the transfer may hide behind the step's MoE compute, and the
    # measurements recalibrate the controller's bandwidth
    knobs = dict(online=True, migration_via="collective")
    jeng = jserving.ServingEngine(
        jparams, jcfg, host_policy(),
        jserving.EngineConfig(**knobs, migration=jonline.MigrationConfig(
            overlap_fraction=0.5, calibrate_bandwidth=True)),
        profile=jprof, num_devices=online_case.NUM_DEVICES,
        telemetry=jtelemetry.Telemetry())
    teng = tserving.ServingEngine(
        tparams, tcfg,
        tserving.EngineConfig(**knobs, migration=tonline.MigrationConfig(
            overlap_fraction=0.5, calibrate_bandwidth=True)),
        profile=tprof, num_devices=online_case.NUM_DEVICES,
        telemetry=ttelemetry.Telemetry(), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("injected", [None, 1e9])
def test_record_migration_measured_branch_matches_jax(injected):
    jeng, teng = _online_engines()
    if injected is not None:
        jeng.set_true_interconnect(injected, base_overhead=2e-5)
        teng.set_true_interconnect(injected, base_overhead=2e-5)
    fields = dict(rows_rewritten=6, cross_rows=4, local_rows=2, rounds=3,
                  payload_bytes=4 * 3 * 64 * 96 * 4)
    cost_mx = np.random.default_rng(0).uniform(1e-5, 5e-5, size=(2, 4))
    charges = []
    for eng, coll in ((jeng, jcoll), (teng, tcoll)):
        stats = [coll.CollectiveStats(**fields),
                 coll.CollectiveStats(**dict(fields, rounds=1))]
        eng.step_count = 7
        charges.append(eng._record_migration(12, 3e-4, stats, cost_mx))
        # a batch without a measurement keeps the modelled charge
        charges.append(eng._record_migration(2, 1e-4, [], None))
    assert charges[0:2] == charges[2:4]
    assert charges[1] == 1e-4
    assert teng.migration_records == jeng.migration_records
    rec = teng.migration_records[0]
    assert rec["via"] == "collective" and rec["rounds"] == 4
    assert rec["payload_bytes"] == 2 * fields["payload_bytes"]
    assert rec["charged_s"] == charges[0] < rec["measured_s"]
    assert rec["overlap_s"] > 0
    assert teng.migration_records[1]["via"] == "host"
    assert (teng.controller.migration_measurements
            == jeng.controller.migration_measurements)
    assert dataclasses.asdict(teng.controller.cost_model) == \
        dataclasses.asdict(jeng.controller.cost_model)
    assert _registry(teng) == _registry(jeng)
    ours, ref = teng.latency_report(), jeng.latency_report()
    assert ours["migration_payload_bytes"] == ref["migration_payload_bytes"]
    assert ours == {k: pytest.approx(ref[k], rel=1e-12) for k in ref}


def test_engine_builds_and_serves_under_collective_on_the_cpu():
    _, tcfg = smoke_configs(expert_tp=2)
    params = init_params(tcfg, device="cpu", dtype=torch.float32)
    profile, _ = online_case._profiles(tcore)
    eng = tserving.ServingEngine(
        params, tcfg,
        tserving.EngineConfig(max_batch=2, max_len=32, placement_policy="gem",
                              replan_after=4,
                              gem=tcore.GEMConfig(trace_length=4,
                                                  num_restarts=2),
                              migration_via="collective"),
        profile=profile, num_devices=online_case.NUM_DEVICES, device="cpu")
    eng.submit(np.arange(5), max_new_tokens=12)
    done = eng.run()
    assert len(done) == 1 and len(done[0].generated) == 12
    assert eng.placement_applied
    assert [r["via"] for r in eng.migration_records] == ["host"]
