"""The port's ``decode_mode="scan"`` (the decode step over static buffers,
captured as a CUDA graph on the card) against its ``"python"`` mode and
the JAX engine in both of its modes, through GEM's one-shot replan.

Same weights, requests, profile and knobs as ``test_torch_replan.py``;
greedy decoding. On the CPU there is no capture: ``"scan"`` runs the same
static-buffer body eagerly, and ``graph_capture_counts["decode"]`` counts
how many times its static buffers were bound, held to the JAX engine's
``jit_trace_counts`` contract (one per engine, none added by a migration).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from test_torch_bridge import placed_params, smoke_configs  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.kv_cache import PagedKVConfig as JaxPagedKVConfig  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig,
    PagedKVConfig,
    ServingEngine,
    batch_arrivals,
)

torch.set_num_threads(1)

NUM_DEVICES = 4
KNOBS = dict(max_batch=3, max_len=40, other_time_per_step=1e-3)
MODES = ("scan", "python")


def _profile(core):
    fleet = core.DeviceFleet.from_speeds(
        core.setup_speeds("high", NUM_DEVICES), tile=8, tile_time=40e-6,
    )
    return core.profile_fleet(
        core.simulator_measure_fn(fleet), NUM_DEVICES,
        max_tokens=512, tile=8, repeats=5,
    ).profile


def _requests(vocab):
    rng = np.random.default_rng(4)
    lengths = [7, 11, 7, 11]  # few distinct lengths: few JAX prefill traces
    prompts = [rng.integers(0, vocab, size=n) for n in lengths]
    return batch_arrivals(prompts, [9, 6, 8, 7])


def _port_engine(tparams, tcfg, mode, policy="gem", hooks=None):
    eng = ServingEngine(
        tparams, tcfg,
        EngineConfig(**KNOBS, kv=PagedKVConfig(block_size=4),
                     gem=tcore.GEMConfig(trace_length=4, num_restarts=3),
                     placement_policy=policy, decode_mode=mode),
        profile=_profile(tcore), num_devices=NUM_DEVICES, device="cpu",
    )
    if hooks is not None:
        hooks(eng)
    eng.serve(_requests(tcfg.vocab_size))
    return eng


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@pytest.fixture(scope="module")
def engines():
    """The port in both modes and the JAX engine in both modes, each from
    the same weights, through a ``gem`` replan; the port's per-step logits
    are kept."""
    jcfg, tcfg = smoke_configs(expert_tp=2)
    jparams, tparams, _ = placed_params(jcfg, tcfg, seed=9)
    out = {}
    for mode in MODES:
        jeng = JaxServingEngine(
            jparams, jcfg, host_policy(),
            JaxEngineConfig(**KNOBS, kv=JaxPagedKVConfig(block_size=4),
                            gem=jcore.GEMConfig(trace_length=4,
                                                num_restarts=3),
                            decode_mode=mode),
            profile=_profile(jcore), num_devices=NUM_DEVICES,
        )
        jeng.serve(_requests(jcfg.vocab_size))
        out["jax", mode] = jeng
        logits = []

        def keep_logits(eng, logits=logits):
            inner = eng._decode

            def decode(*a, **kw):
                res = inner(*a, **kw)
                logits.append(res[0].clone())
                return res

            eng._decode = decode

        # each port engine permutes its own copy of the pool at the replan
        teng = _port_engine(_clone(tparams), tcfg, mode, hooks=keep_logits)
        teng.step_logits = logits
        out["port", mode] = teng
    return out


@pytest.mark.parametrize("other", [("port", "python"), ("jax", "scan"),
                                   ("jax", "python")], ids="-".join)
def test_scan_matches_every_mode_through_the_replan(engines, other):
    ours, ref = engines["port", "scan"], engines[other]
    assert len(ours.finished) == len(ref.finished) == 4
    assert {r.uid: r.generated for r in ours.finished} == \
        {r.uid: r.generated for r in ref.finished}
    assert ours.step_count == ref.step_count
    # the replan fired mid-run, at the same step, priced the same way
    (rec,) = ours.migration_records
    assert 4 <= rec["step"] < ours.step_count - 1 and rec["moves"] > 0
    assert ours.migration_records == ref.migration_records
    s2e = np.stack([p.slot_to_expert() for p in ours.current_placements])
    assert (s2e != np.arange(s2e.shape[1])).any(axis=1).all()
    np.testing.assert_array_equal(
        s2e, np.stack([p.slot_to_expert() for p in ref.current_placements]))
    np.testing.assert_array_equal(ours.placements.numpy(),
                                  np.asarray(ref.placements))
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            ours.params["blocks"]["moe"][name].numpy(),
            np.asarray(ref.params["blocks"]["moe"][name]), err_msg=name)
    assert ours.sim_step_latencies == ref.sim_step_latencies


def test_scan_logits_are_bit_equal_to_python(engines):
    """Same body, same inputs, same order of operations: bit-equal."""
    ours, ref = engines["port", "scan"], engines["port", "python"]
    assert len(ours.step_logits) == ours.decode_count == ref.decode_count
    for a, b in zip(ours.step_logits, ref.step_logits):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode,want", [("scan", 1), ("python", 0)])
def test_graph_capture_counts_after_the_run(engines, mode, want):
    assert engines["port", mode].graph_capture_counts == {
        "decode": want, "prefill": 0, "migrate": 0}
    # the JAX engine holds the same contract for its traces
    assert engines["jax", mode].jit_trace_counts["decode"] == 1


def _static_addresses(eng):
    moe = eng.params["blocks"]["moe"]
    graph = eng.decode_graph
    return {
        "tables": eng.placements.data_ptr(),
        "tokens": graph.tokens.data_ptr(),
        "cur_len": graph.cur_len.data_ptr(),
        "block_tables": graph.block_tables.data_ptr(),
        **{name: moe[name].data_ptr() for name in ("w_gate", "w_up", "w_down")},
        "k_pool": eng.caches["attn"]["k"].data_ptr(),
        "v_pool": eng.caches["attn"]["v"].data_ptr(),
    }


def test_the_replan_adds_no_build_and_moves_no_static_buffer():
    jcfg, tcfg = smoke_configs(expert_tp=2)
    _, tparams, e2s = placed_params(jcfg, tcfg, seed=9)
    seen = {}

    def hooks(eng):
        seen["start"] = (dict(eng.graph_capture_counts), _static_addresses(eng))
        migrate = eng._migrate

        def watched(*a):
            seen["before"] = (dict(eng.graph_capture_counts),
                              _static_addresses(eng))
            return migrate(*a)

        eng._migrate = watched

    eng = _port_engine(tparams, tcfg, "scan", hooks=hooks)
    assert eng.migration_records and eng.decode_count > 0
    after = (dict(eng.graph_capture_counts), _static_addresses(eng))
    counts = {"decode": 1, "prefill": 0, "migrate": 0}
    assert seen["start"] == seen["before"] == after
    assert after[0] == counts
    # the tables moved in value, not in address
    assert not np.array_equal(eng.placements.numpy(),
                              np.tile(np.arange(e2s.shape[1]), (2, 1)))
    eng.placements = torch.from_numpy(e2s)
    assert (dict(eng.graph_capture_counts), _static_addresses(eng)) == after
    np.testing.assert_array_equal(eng.placements.numpy(), e2s)
    with pytest.raises(ValueError, match="E_v"):
        eng.placements = torch.from_numpy(e2s[:1])


def _no_profile_engine(tparams, tcfg, e2s, mode, num_blocks):
    eng = ServingEngine(
        tparams, tcfg,
        EngineConfig(max_batch=3, max_len=40, prefill_chunk=4,
                     kv=PagedKVConfig(block_size=4, num_blocks=num_blocks),
                     decode_mode=mode),
        device="cpu",
    )
    eng.placements = torch.from_numpy(e2s)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n)
               for n in (6, 9, 13, 6, 9)]
    eng.serve(batch_arrivals(prompts, [8, 5, 10, 7, 6]))
    return eng


@pytest.mark.parametrize("num_blocks", [None, 9], ids=["roomy", "preempting"])
def test_scan_matches_python_under_an_installed_placement(num_blocks):
    """No profile: a non-identity placement installed by assignment, with
    chunked prefill and (at 9 KV blocks) preemption."""
    jcfg, tcfg = smoke_configs(expert_tp=2)
    _, tparams, e2s = placed_params(jcfg, tcfg, seed=5)
    runs = {mode: _no_profile_engine(tparams, tcfg, e2s, mode, num_blocks)
            for mode in MODES}
    scan, python = runs["scan"], runs["python"]
    assert len(scan.finished) == 5
    assert [(r.uid, r.generated, r.preemptions) for r in scan.finished] == \
        [(r.uid, r.generated, r.preemptions) for r in python.finished]
    assert (scan.preemption_count > 0) == (num_blocks is not None)
    assert scan.graph_capture_counts["decode"] == 1


def test_rebinding_a_weight_rebuilds_and_is_counted():
    """Replacing a weight tensor after the capture binds the graph again
    (never replays stale pointers) and counts the build."""
    jcfg, tcfg = smoke_configs(expert_tp=2)
    _, tparams, e2s = placed_params(jcfg, tcfg, seed=5)
    tokens = {}
    for mode in MODES:
        eng = ServingEngine(tparams if mode == "python" else _clone(tparams),
                            tcfg, EngineConfig(max_batch=2, max_len=40,
                                               decode_mode=mode),
                            device="cpu")
        eng.placements = torch.from_numpy(e2s)
        eng.submit(np.arange(5), max_new_tokens=3)
        eng.step()
        if mode == "scan":
            moe = eng.params["blocks"]["moe"]
            moe["w_up"] = moe["w_up"].clone()
        eng.run()
        tokens[mode] = eng.finished[0].generated
        if mode == "scan":
            assert eng.graph_capture_counts["decode"] == 2
    assert tokens["scan"] == tokens["python"]


def test_unknown_decode_mode_raises():
    _, tcfg = smoke_configs(expert_tp=2)
    from repro_torch.models import init_params

    params = init_params(tcfg, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="decode_mode"):
        ServingEngine(params, tcfg, EngineConfig(decode_mode="eager"),
                      device="cpu")


# ------------------------------------------------------------ host-sync guard
FORBIDDEN = {
    "_local_scalar_dense": torch.ops.aten._local_scalar_dense.default,
    "bincount": torch.ops.aten.bincount.default,
    "nonzero": torch.ops.aten.nonzero.default,
    "lift_fresh": torch.ops.aten.lift_fresh.default,
}


class NoHostSync(TorchDispatchMode):
    """Fails on the ops that read a device value back to the host (a sync,
    illegal in a capture) or build a tensor from host data (a copy that a
    capture would bake in)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in FORBIDDEN.values():
            raise AssertionError(f"host sync or host data in the step: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("op", sorted(FORBIDDEN))
def test_the_guard_catches(op):
    x = torch.tensor([0, 2, 1])
    call = {
        "_local_scalar_dense": lambda: x[0].item(),
        "bincount": lambda: torch.bincount(x),
        "nonzero": lambda: torch.nonzero(x),
        "lift_fresh": lambda: torch.tensor([1, 2]),
    }[op]
    with pytest.raises(AssertionError, match=op):
        with NoHostSync():
            call()


def test_the_static_body_holds_no_host_sync(engines):
    """The whole "scan" call, staging and body, after a run (so that the
    one-time set-up is done) under the guard, with live rows."""
    eng = engines["port", "scan"]
    graph = eng.decode_graph
    cur_len = np.array([5, 9, 0], np.int32)
    tables = np.zeros((3, graph.n_max), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :3] = [3, 4, 5]
    with NoHostSync():
        logits, _, aux = eng._decode(
            eng.params, eng.caches, cur_len, np.array([[3], [7], [0]]),
            eng.config, eng.placements, block_tables=tables)
    assert logits.shape == (3, eng.config.padded_vocab)
    assert bool(torch.isfinite(logits[:, :eng.config.vocab_size]).all())
    assert aux.expert_counts.shape == (2, eng.config.num_experts)
    assert graph.builds == 1


# ------------------------------------------------------------- launch counts
def test_launches_recorded_at_capture_count_on_each_replay(monkeypatch):
    """A wrapper's count during a capture goes to the capture's tally (the
    kernel is recorded, not launched); each replay adds the tally."""
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    launches.reset()
    launches.count("moe_ffn")
    capturing[0] = True
    with pytest.raises(RuntimeError, match="recording"):
        launches.count("moe_ffn")
    with launches.recording() as tally:
        for _ in range(3):
            launches.count("moe_ffn")
        launches.count("topk_router_stats")
    capturing[0] = False
    assert tally == {"moe_ffn": 3, "topk_router_stats": 1, "topk_router": 0}
    assert launches.LAUNCHES["moe_ffn"] == 1  # a capture launches nothing
    launches.replayed(tally)
    launches.replayed(tally)
    assert launches.LAUNCHES == {"moe_ffn": 7, "topk_router_stats": 2,
                                 "topk_router": 0}
    launches.reset()
