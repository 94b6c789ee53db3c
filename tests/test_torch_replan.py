"""The port's engine against the JAX engine with a variability profile
attached: GEM's Step-1 trace, the one-shot replan under each placement
policy, the in-place migration of the expert pool and the router-table
swap. Same weights, same requests, same 4-device emulated fleet; tokens,
plans, tables, weights, migration records and simulated latencies must be
equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from test_torch_bridge import placed_params, smoke_configs  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.kv_cache import PagedKVConfig as JaxPagedKVConfig  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.replication import ReplicationConfig  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig,
    PagedKVConfig,
    ServingEngine,
    batch_arrivals,
)

torch.set_num_threads(1)

NUM_DEVICES = 4
KNOBS = dict(max_batch=3, max_len=40, other_time_per_step=1e-3)


def _profile(core):
    fleet = core.DeviceFleet.from_speeds(
        core.setup_speeds("high", NUM_DEVICES), tile=8, tile_time=40e-6,
    )
    return core.profile_fleet(
        core.simulator_measure_fn(fleet), NUM_DEVICES,
        max_tokens=512, tile=8, repeats=5,
    ).profile


def _run_both(policy):
    jcfg, tcfg = smoke_configs(expert_tp=2)
    jparams, tparams, _ = placed_params(jcfg, tcfg, seed=9)
    jeng = JaxServingEngine(
        jparams, jcfg, host_policy(),
        JaxEngineConfig(**KNOBS, kv=JaxPagedKVConfig(block_size=4),
                        gem=jcore.GEMConfig(trace_length=4, num_restarts=3),
                        placement_policy=policy),
        profile=_profile(jcore), num_devices=NUM_DEVICES,
    )
    teng = ServingEngine(
        tparams, tcfg,
        EngineConfig(**KNOBS, kv=PagedKVConfig(block_size=4),
                     gem=tcore.GEMConfig(trace_length=4, num_restarts=3),
                     placement_policy=policy),
        profile=_profile(tcore), num_devices=NUM_DEVICES, device="cpu",
    )
    rng = np.random.default_rng(4)
    lengths = [7, 11, 7, 11]  # few distinct lengths: few JAX prefill traces
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in lengths]
    news = [9, 6, 8, 7]
    for eng in (jeng, teng):
        eng.serve(batch_arrivals(prompts, news))
    return jeng, teng


@pytest.mark.parametrize("policy", ["gem", "eplb", "linear"])
def test_replan_matches_jax(policy):
    jeng, teng = _run_both(policy)
    assert len(teng.finished) == len(jeng.finished) == 4
    want = {r.uid: r.generated for r in jeng.finished}
    assert {r.uid: r.generated for r in teng.finished} == want
    assert teng.placement_applied and jeng.placement_applied
    assert teng.step_count == jeng.step_count
    # the replan fired mid-run, at the same step, priced the same way
    assert teng.migration_records == jeng.migration_records
    if policy == "linear":
        assert teng.migration_records == []
    else:
        (rec,) = teng.migration_records
        assert 4 <= rec["step"] < teng.step_count - 1
        assert rec["via"] == "host" and rec["moves"] > 0
    assert teng.sim_step_latencies == jeng.sim_step_latencies
    assert teng.sim_time == jeng.sim_time

    s2e = np.stack([p.slot_to_expert() for p in teng.current_placements])
    want_s2e = np.stack([p.slot_to_expert() for p in jeng.current_placements])
    np.testing.assert_array_equal(s2e, want_s2e)
    moved = (s2e != np.arange(s2e.shape[1])).any(axis=1)
    assert moved.all() if policy != "linear" else not moved.any()
    np.testing.assert_array_equal(teng.placements.numpy(),
                                  np.asarray(jeng.placements))
    np.testing.assert_array_equal(teng.placements.numpy(),
                                  np.argsort(s2e, axis=1))
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            teng.params["blocks"]["moe"][name].numpy(),
            np.asarray(jeng.params["blocks"]["moe"][name]), err_msg=name,
        )

    ours, ref = teng.latency_report(), jeng.latency_report()
    assert ours.keys() <= ref.keys()
    assert ours == {k: pytest.approx(ref[k], rel=1e-12) for k in ours}


def test_replication_is_refused_until_ported():
    """Replication is ported: the engine refuses it, as the JAX engine
    does, only without a profile or under a policy other than gem, and
    builds the replicated pool otherwise."""
    _, tcfg = smoke_configs(expert_tp=2)
    params = init_params(tcfg, device="cpu", dtype=torch.float32)
    rep = ReplicationConfig(replica_slots=1)
    with pytest.raises(ValueError, match="replica_slots>0"):
        ServingEngine(params, tcfg, EngineConfig(replication=rep),
                      device="cpu")
    with pytest.raises(ValueError, match="replica_slots>0"):
        ServingEngine(params, tcfg, EngineConfig(replication=rep,
                                                 placement_policy="eplb"),
                      profile=_profile(tcore), device="cpu")
    eng = ServingEngine(params, tcfg, EngineConfig(replication=rep),
                        profile=_profile(tcore), num_devices=NUM_DEVICES,
                        device="cpu")
    Ev = tcfg.num_virtual_experts
    assert eng.params["blocks"]["moe"]["w_up"].shape[1] == Ev + NUM_DEVICES
    assert tuple(eng.placements.shape) == (tcfg.num_layers, Ev,
                                           rep.pattern_period)
    with pytest.raises(ValueError, match="placement_policy"):
        ServingEngine(params, tcfg, EngineConfig(placement_policy="random"),
                      device="cpu")


def test_true_profile_changes_the_charge_not_the_plan():
    """A fleet that departs the believed profile is charged from the
    ground truth, while the planner keeps planning on its belief."""
    _, tcfg = smoke_configs(expert_tp=2)
    params = init_params(tcfg, seed=2, device="cpu", dtype=torch.float32)
    believed = _profile(tcore)
    slower = tcore.VariabilityProfile(
        believed.token_counts, believed.latencies * 3.0, believed.tile_size)
    runs = []
    for truth in (None, slower):
        eng = ServingEngine(
            params, tcfg,
            EngineConfig(**KNOBS, gem=tcore.GEMConfig(trace_length=2,
                                                      num_restarts=2),
                         placement_policy="linear"),
            profile=believed, num_devices=NUM_DEVICES, device="cpu",
        )
        eng.set_true_profile(truth)
        eng.submit(np.arange(6), max_new_tokens=4)
        eng.run()
        runs.append(eng)
    base, capped = runs
    assert capped.planner.profile is believed
    moe = [a - KNOBS["other_time_per_step"] for a in base.sim_step_latencies]
    moe3 = [a - KNOBS["other_time_per_step"]
            for a in capped.sim_step_latencies]
    assert moe3 == pytest.approx([3.0 * m for m in moe])
