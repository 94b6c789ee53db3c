"""The port's online adaptation plane and telemetry plane against the JAX
engine's, on fig23's burst/gem-online scenario cut to 14 requests.

Both engines serve the same arrival stream (fig23's chat/summarize mix,
shifting mid-stream, under a bursty arrival process) with the same weights
on the same 4-device emulated fleet, through each package's
``serve_scenario``, with ``online=True`` and a mid-run slowdown of the
fleet's fastest device. The JAX engine runs once (``decode_mode="scan"``),
the port in both decode modes. Tokens, simulated latencies, migration
records, replans, placements, tables, weights, the latency report, the
registry snapshot and the exported audit events must be equal, and the
port's event log must replay byte for byte through
``benchmarks/decision_replay.py``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.online as jonline  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro.telemetry as jtelemetry  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.online as tonline  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
import repro_torch.telemetry as ttelemetry  # noqa: E402
from benchmarks.decision_replay import replay_log  # noqa: E402
from test_torch_bridge import placed_params, smoke_configs  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.replication import ReplicationConfig  # noqa: E402

torch.set_num_threads(1)

NUM_DEVICES = 4
NUM_REQUESTS = 14
SLOWDOWN_STEP = 32  # engine step at which the true fleet departs the belief
ARRIVAL_RATE = 1000.0  # req/s in simulated time


def _profiles(core):
    """(believed, true) fleet profiles: fig23's moderate staircase fleet,
    and the same fleet with its fastest device at half speed."""
    def profile(speeds):
        fleet = core.DeviceFleet.from_speeds(speeds, tile=1, tile_time=20e-6)
        return core.profile_fleet(
            core.simulator_measure_fn(fleet, seed=2), NUM_DEVICES,
            max_tokens=4 * 64, tile=1, repeats=3,
        ).profile

    speeds = core.setup_speeds("moderate", NUM_DEVICES)
    slow = speeds.copy()
    slow[int(np.argmax(speeds))] /= 2.0
    return profile(speeds), profile(slow)


def _knobs(core, online, mode):
    """fig23's gem-online engine configuration, in one package's types."""
    return dict(
        max_batch=4, max_len=64,
        gem=core.GEMConfig(trace_length=8, num_restarts=4),
        placement_policy="gem", replan_after=8, other_time_per_step=2e-5,
        online=True, drift=online.DriftConfig(min_steps=4),
        migration=online.MigrationConfig(max_moves_per_step=2),
        replan_cooldown=8, staggered_replan=True,
        prefill_chunk=16, prefill_time_per_token=2e-6, ttft_slo_s=0.05,
        decode_mode=mode,
    )


def _stream(serving, vocab_size):
    chat = serving.TaskProfile(
        "chat", prompt_buckets=(8, 16), output_mean=12.0,
        output_bounds=(4, 24), vocab_band=(0.0, 0.5))
    summ = serving.TaskProfile(
        "summarize", prompt_buckets=(16, 32), output_mean=8.0,
        output_bounds=(4, 16), vocab_band=(0.5, 1.0))
    return serving.generate_arrivals(
        serving.ArrivalConfig(
            rate=ARRIVAL_RATE, num_requests=NUM_REQUESTS, process="burst",
            burst_multiplier=4.0, burst_active_frac=0.25, burst_regime_len=8,
        ),
        vocab_size, seed=1,
        mix=[(chat, 0.8), (summ, 0.2)],
        mix_shift=(0.5 * NUM_REQUESTS / ARRIVAL_RATE,
                   [(chat, 0.2), (summ, 0.8)]),
    )


def _serve(online, engine, vocab_size):
    serving = jserving if online is jonline else tserving
    _, true_slow = _profiles(jcore if online is jonline else tcore)
    scen = online.ServeScenario(
        "burst/gem-online", list(_stream(serving, vocab_size)),
        profile_schedule={SLOWDOWN_STEP: true_slow},
    )
    done = online.serve_scenario(engine, scen, max_steps=5_000)
    assert len(done) == NUM_REQUESTS
    return engine


@pytest.fixture(scope="module")
def runs():
    """The JAX engine (scan) and the port's engines (scan and python with
    a live hub, scan with none), all on the same weights and stream."""
    jcfg, tcfg = smoke_configs(expert_tp=2, decode_capacity_factor=4.0)
    jparams, tparams, _ = placed_params(jcfg, tcfg, seed=3)
    jbelieved, _ = _profiles(jcore)
    tbelieved, _ = _profiles(tcore)
    kv = dict(block_size=4, num_blocks=40, watermark_blocks=1)
    out = {"jax": _serve(jonline, jserving.ServingEngine(
        jparams, jcfg, host_policy(),
        jserving.EngineConfig(**_knobs(jcore, jonline, "scan"),
                              kv=jserving.PagedKVConfig(**kv)),
        profile=jbelieved, num_devices=NUM_DEVICES,
        telemetry=jtelemetry.Telemetry(),
    ), jcfg.vocab_size)}
    for name, mode, hub in (("scan", "scan", True), ("python", "python", True),
                            ("scan-off", "scan", False)):
        params = _clone(tparams)  # every engine rewrites its own pool
        out[name] = _serve(tonline, tserving.ServingEngine(
            params, tcfg,
            tserving.EngineConfig(**_knobs(tcore, tonline, mode),
                                  kv=tserving.PagedKVConfig(**kv)),
            profile=tbelieved, num_devices=NUM_DEVICES,
            telemetry=ttelemetry.Telemetry() if hub else None, device="cpu",
        ), tcfg.vocab_size)
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _tokens(eng):
    return {r.uid: list(r.generated) for r in eng.finished}


PORT = ["scan", "python"]


@pytest.mark.parametrize("mode", PORT)
def test_online_serving_matches_jax(runs, mode):
    jeng, teng = runs["jax"], runs[mode]
    assert _tokens(teng) == _tokens(jeng)
    assert teng.step_count == jeng.step_count
    assert teng.sim_step_latencies == jeng.sim_step_latencies
    assert teng.sim_time == jeng.sim_time
    assert teng.migration_records == jeng.migration_records
    assert teng.controller.replans == jeng.controller.replans
    # the online plane did its work: batches at distinct steps, each within
    # the budget, and a replan on the injected slowdown
    steps = [r["step"] for r in teng.migration_records]
    assert len(steps) >= 2 and len(set(steps)) == len(steps)
    assert all(0 < r["moves"] <= 2 for r in teng.migration_records)
    reasons = [r["reason"] for r in teng.controller.replans]
    assert "variability-drift" in reasons, reasons
    assert teng.placement_applied and jeng.placement_applied
    assert teng.graph_capture_counts == {
        "decode": int(mode == "scan"), "prefill": 0, "migrate": 0}


@pytest.mark.parametrize("mode", PORT)
def test_online_layout_matches_jax(runs, mode):
    jeng, teng = runs["jax"], runs[mode]
    s2e = np.stack([p.slot_to_expert() for p in teng.current_placements])
    want = np.stack([p.slot_to_expert() for p in jeng.current_placements])
    np.testing.assert_array_equal(s2e, want)
    assert (s2e != np.arange(s2e.shape[1])).any()
    np.testing.assert_array_equal(teng.placements.numpy(),
                                  np.asarray(jeng.placements))
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            teng.params["blocks"]["moe"][name].numpy(),
            np.asarray(jeng.params["blocks"]["moe"][name]), err_msg=name,
        )


@pytest.mark.parametrize("mode", PORT)
def test_online_reports_match_jax(runs, mode):
    jeng, teng = runs["jax"], runs[mode]
    ours, ref = teng.latency_report(), jeng.latency_report()
    assert ours.keys() == ref.keys()
    for key in ("replans", "migration_s", "attr_slack_total_s",
                "regret_total_s"):
        assert key in ours, key
    assert ours == {k: pytest.approx(ref[k], rel=1e-12) for k in ref}
    # the registries agree but for the JAX trace counters, which have no
    # counterpart here (captures are graph_capture_counts)
    theirs = jeng.telemetry.registry.snapshot()
    for kind, named in theirs.items():
        if isinstance(named, dict):
            theirs[kind] = {k: v for k, v in named.items()
                            if not k.startswith("jit.trace.")}
    assert teng.telemetry.registry.snapshot() == theirs


def _canonical_events(tel):
    return [json.dumps(ev, sort_keys=True) for ev in tel.events]


def test_online_audit_log_matches_jax_and_replays(runs, tmp_path):
    jeng, teng = runs["jax"], runs["scan"]
    ours = _canonical_events(teng.telemetry)
    audit = [e for e in ours if '"name": "audit.' in e]
    assert any('"audit.init"' in e for e in audit)
    assert sum('"audit.step"' in e for e in audit) > 0
    assert ours == _canonical_events(jeng.telemetry)
    assert _canonical_events(runs["python"].telemetry) == ours
    path = tmp_path / "port_events.jsonl"
    ttelemetry.write_jsonl(teng.telemetry, str(path), scenario="burst")
    result = replay_log(str(path))
    assert result["controllers"] == 1 and result["steps"] > 0
    assert result["mismatches"] == []
    assert result["replans_replayed"] == result["replans_logged"] > 0


def test_telemetry_hub_leaves_tokens_alone(runs):
    on, off = runs["scan"], runs["scan-off"]
    assert _tokens(on) == _tokens(off)
    assert on.migration_records == off.migration_records
    assert off.telemetry.events == [] and on.telemetry.events


# case → (EngineConfig knobs, whether a profile is attached, error, match)
REFUSALS = {
    "online-without-profile": (dict(online=True), False, ValueError,
                               "online=True"),
    "unknown-via": (dict(migration_via="nvlink"), True, ValueError,
                    "migration_via"),
    # replication is ported; the JAX engine's refusal of it under a policy
    # other than gem holds
    "replication": (dict(online=True, placement_policy="eplb",
                         replication=ReplicationConfig(replica_slots=2)),
                    True, ValueError, "replication"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_online_engine_refusals(case):
    knobs, with_profile, error, match = REFUSALS[case]
    _, tcfg = smoke_configs(expert_tp=2)
    params = init_params(tcfg, device="cpu", dtype=torch.float32)
    profile, _ = _profiles(tcore)
    with pytest.raises(error, match=match):
        tserving.ServingEngine(
            params, tcfg, tserving.EngineConfig(**knobs),
            profile=profile if with_profile else None, device="cpu")


def test_online_engine_builds_a_replicated_pool():
    """``replica_slots > 0`` with a profile and the gem policy: the pool
    holds E_v + G·slots rows a layer, each device's extra slots copying
    its own experts, and the controller plans replicated layouts."""
    _, tcfg = smoke_configs(expert_tp=2)
    params = init_params(tcfg, device="cpu", dtype=torch.float32)
    profile, _ = _profiles(tcore)
    eng = tserving.ServingEngine(
        params, tcfg, tserving.EngineConfig(
            online=True, replication=ReplicationConfig(replica_slots=2)),
        profile=profile, num_devices=NUM_DEVICES, device="cpu")
    Ev = tcfg.num_virtual_experts
    S = Ev + NUM_DEVICES * 2
    w = eng.params["blocks"]["moe"]["w_gate"]
    assert tuple(w.shape[:2]) == (tcfg.num_layers, S)
    s2e = eng.current_rplacements[0].slot_to_expert
    for s, e in enumerate(s2e):
        assert torch.equal(w[0, s], params["blocks"]["moe"]["w_gate"][0, e])
    assert tuple(eng.placements.shape) == (tcfg.num_layers, Ev, 16)
    assert eng.controller.replicated
    assert eng.graph_capture_counts["decode"] == 1
