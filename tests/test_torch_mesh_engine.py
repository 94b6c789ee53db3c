"""The port's serving engine under a live (2, 2) policy across four
``gloo`` ranks on the CPU, against the JAX engine on a forced 4-device
host mesh of the same shape (in a subprocess), on Mixtral's smoke config
with the same weights (JAX's ``init_params``, handed over as numpy and
sharded by ``params_from_numpy(..., policy=...)``):

* the online engine of ``tests/test_scan_decode.py:_run_engine`` with
  ``migration_via="collective"``, whose budgeted batches move rows between
  ranks mid-run: the port's ``"scan"`` and ``"python"`` give JAX's mesh
  tokens (``tests/test_scan_decode.py:117-133``), every rank the same;
  every rank's router tables equal the controller's and each other's; the
  measured records equal JAX's (``cross_rows``, ``payload_bytes``);
* the one-shot replicated retarget of ``tests/test_collective.py:420-478``
  (one replica slot a device), under ``"host"`` and ``"collective"``:
  equal tokens, JAX's tokens, and the two-phase install's
  ``cross_rows == moves`` with ``payload_bytes = cross_rows ×`` one slot's
  bytes; and under ``"collective"`` with three replica slots a device,
  whose 10-slot pool shards 5 a rank: a shard of odd size, at least E_v,
  the size of a whole pool the axis does not divide.

GEM plans over 2 devices, so that placement device d is model rank d. The
JAX engines run ``moe_backend="einsum"``, as the single-card engine parity
tests do: its routing selects as the kernels do, and the tokens are the
comparison."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import ranks, run_jax  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.online as tonline  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.replication import ReplicationConfig  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.sharding import ShardingPolicy  # noqa: E402

torch.set_num_threads(1)

ARCH = "mixtral-8x7b"
SHAPE = (2, 2)
NUM_DEVICES = 2  # = the model axis


def _cfg(get_config):
    return dataclasses.replace(get_config(ARCH), decode_capacity_factor=4.0)


def _profile(core):
    fleet = core.DeviceFleet.from_speeds(
        core.setup_speeds("high", NUM_DEVICES), tile=1, tile_time=50e-6,
        base=10e-6)
    return core.profile_fleet(
        core.simulator_measure_fn(fleet, seed=0), NUM_DEVICES, max_tokens=64,
        tile=1, repeats=5).profile


def _online_knobs(core, online, mode):
    return dict(
        max_batch=4, max_len=96, decode_mode=mode,
        gem=core.GEMConfig(trace_length=8, num_restarts=4),
        other_time_per_step=1e-4, online=True,
        drift=online.DriftConfig(min_steps=4, threshold=3.0),
        migration=online.MigrationConfig(max_moves_per_step=2,
                                         base_overhead=0.0),
        replan_cooldown=8, payback_horizon=100_000,
        migration_via="collective",
    )


# (via, replica slots a device): 4 + 2·1 = 6 slots shard 3 a rank; 4 + 2·3
# = 10 shard 5, an odd shard of at least E_v = 4 rows
REPLICATED = {"host": ("host", 1), "collective": ("collective", 1),
              "collective_odd": ("collective", 3)}


def _replicated_knobs(core, via):
    return dict(
        max_batch=4, max_len=96, decode_mode="python",
        gem=core.GEMConfig(trace_length=8, num_restarts=4),
        other_time_per_step=1e-4, placement_policy="gem",
        migration_via=via,
    )


def _submit(eng, vocab_size, seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        eng.submit(rng.integers(0, vocab_size, size=8), 20)


def _summary(eng):
    recs = [{k: r[k] for k in ("step", "via", "moves", "cross_rows",
                               "payload_bytes", "local_rows", "rounds")
             if k in r} for r in eng.migration_records]
    return {"tokens": {r.uid: list(r.generated) for r in eng.finished},
            "records": recs, "tables": np.asarray(eng.placements.cpu()
                                                  if hasattr(eng.placements, "cpu")
                                                  else eng.placements),
            "applied": eng.placement_applied}


# ------------------------------------------------------------ the port side
def _rank(mesh, tree):
    policy = ShardingPolicy(mesh=mesh)
    cfg = _cfg(get_smoke_config)
    profile = _profile(tcore)
    out = {}
    for mode in ("scan", "python"):
        params = params_from_numpy(tree, cfg, "cpu", torch.float32,
                                   policy=policy)
        eng = ServingEngine(params, cfg,
                            EngineConfig(**_online_knobs(tcore, tonline, mode)),
                            policy=policy, profile=profile,
                            num_devices=NUM_DEVICES)
        _submit(eng, cfg.vocab_size, 17)
        eng.run(max_steps=120)
        out[mode] = _summary(eng)
        out[mode]["controller_tables"] = eng.controller.expert_to_slot_tables()
        out[mode]["stored_slots"] = int(eng.params["blocks"]["moe"][
            "w_gate"].shape[1])
        out[mode]["kv_rows"] = int(eng.caches["attn"]["k"].shape[1])
        out[mode]["paged"] = eng.paged
        out[mode]["captures"] = eng.graph_capture_counts
    for key, (via, slots) in REPLICATED.items():
        params = params_from_numpy(tree, cfg, "cpu", torch.float32,
                                   policy=policy)
        knobs = _replicated_knobs(tcore, via)
        knobs["replication"] = ReplicationConfig(replica_slots=slots)
        eng = ServingEngine(params, cfg, EngineConfig(**knobs),
                            policy=policy, profile=profile,
                            num_devices=NUM_DEVICES)
        _submit(eng, cfg.vocab_size, 5)
        eng.run(max_steps=120)
        out[key] = _summary(eng)
        out[key]["stored_slots"] = int(eng.params["blocks"]["moe"][
            "w_gate"].shape[1])
    return out


# ------------------------------------------------------------- the JAX side
def jax_engines(payload):
    import jax
    import jax.numpy as jnp

    import repro.core as jcore
    import repro.online as jonline
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.models import init_params
    from repro.serving import EngineConfig as JEngineConfig
    from repro.serving import ServingEngine as JServingEngine
    from repro.sharding.policy import ShardingPolicy as JaxPolicy
    from repro.replication import ReplicationConfig as JReplicationConfig

    cfg = _cfg(jax_smoke)
    mesh = make_host_mesh(*SHAPE)
    policy = JaxPolicy(mesh=mesh)
    params, _ = init_params(cfg, jax.random.PRNGKey(0), policy, jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    profile = _profile(jcore)
    out = {"tree": tree}
    for mode in ("scan", "python"):
        params, _ = init_params(cfg, jax.random.PRNGKey(0), policy,
                                jnp.float32)
        eng = JServingEngine(params, cfg, policy,
                             JEngineConfig(**_online_knobs(jcore, jonline, mode)),
                             profile=profile, num_devices=NUM_DEVICES)
        _submit(eng, cfg.vocab_size, 17)
        eng.run(max_steps=120)
        out[mode] = _summary(eng)
    for key, (via, slots) in REPLICATED.items():
        params, _ = init_params(cfg, jax.random.PRNGKey(0), policy,
                                jnp.float32)
        knobs = _replicated_knobs(jcore, via)
        knobs["replication"] = JReplicationConfig(replica_slots=slots)
        eng = JServingEngine(params, cfg, policy, JEngineConfig(**knobs),
                             profile=profile, num_devices=NUM_DEVICES)
        _submit(eng, cfg.vocab_size, 5)
        eng.run(max_steps=120)
        out[key] = _summary(eng)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_engine")
    jax_out = run_jax("test_torch_mesh_engine:jax_engines", {}, tmp)
    port = ranks(_rank, *SHAPE, tmp, jax_out["tree"])
    return port, jax_out


@pytest.mark.parametrize("mode", ["scan", "python"])
def test_online_collective_engine_tokens_match_jax_mesh(results, mode):
    port, jax_out = results
    want = jax_out[mode]
    assert want["records"] and want["tokens"]
    assert jax_out["scan"]["tokens"] == jax_out["python"]["tokens"]
    for res in port:
        got = res[mode]
        assert got["tokens"] == want["tokens"]
        assert got["tokens"] == res["python"]["tokens"]  # scan ≡ python
        assert got["records"] == want["records"]
        assert all("cross_rows" in r and r["via"] == "collective"
                   for r in got["records"])


@pytest.mark.parametrize("mode", ["scan", "python"])
def test_online_engine_tables_agree_on_every_rank(results, mode):
    port, jax_out = results
    first = port[0][mode]["tables"]
    np.testing.assert_array_equal(first, jax_out[mode]["tables"])
    for res in port:
        np.testing.assert_array_equal(res[mode]["tables"], first)
        np.testing.assert_array_equal(res[mode]["tables"],
                                      res[mode]["controller_tables"])


def test_engine_layout_under_the_mesh(results):
    """Each rank stores its half of the 4-slot pool and its 2 of the 4
    decode rows, in a dense cache (``kv_mode="auto"`` under a mesh); the
    replicated pool (4 + 2 slots) shards 3 a rank. One binding of the
    static buffers under ``"scan"`` (the CPU runs the body eagerly)."""
    port, _ = results
    for res in port:
        for mode in ("scan", "python"):
            assert res[mode]["stored_slots"] == 2
            assert res[mode]["kv_rows"] == 2 and not res[mode]["paged"]
        assert res["scan"]["captures"] == {"decode": 1, "prefill": 0,
                                           "migrate": 0}
        assert res["host"]["stored_slots"] == res["collective"][
            "stored_slots"] == 3


def test_replicated_retarget_host_equals_collective_and_jax(results):
    port, jax_out = results
    cfg = _cfg(get_smoke_config)
    expert_bytes = 3 * cfg.d_model * (cfg.expert_d_ff // cfg.expert_tp) * 4
    assert jax_out["host"]["tokens"] == jax_out["collective"]["tokens"]
    for res in port:
        assert res["host"]["applied"] and res["collective"]["applied"]
        assert res["host"]["tokens"] == res["collective"]["tokens"]
        assert res["host"]["tokens"] == jax_out["host"]["tokens"]
        assert res["collective"]["records"] == jax_out["collective"]["records"]
        assert res["host"]["records"] == jax_out["host"]["records"]
        np.testing.assert_array_equal(res["collective"]["tables"],
                                      jax_out["collective"]["tables"])
        measured = [r for r in res["collective"]["records"]
                    if "cross_rows" in r]
        assert measured
        for r in measured:
            assert r["cross_rows"] == r["moves"]
            assert r["payload_bytes"] == r["cross_rows"] * expert_bytes


def test_replicated_pool_with_an_odd_shard_of_at_least_e_v_slots(results):
    """Three replica slots a device: S = 4 + 2·3 = 10 shards 5 a rank, a
    row count that is odd and not below E_v = 4. The engine serves the
    10-slot pool (the dispatch, the migration executable and the shed
    capacity all take S from the engine, not from the rows a rank
    stores): JAX's tokens, records and tables, every rank alike, and the
    install's measured records."""
    port, jax_out = results
    cfg = _cfg(get_smoke_config)
    expert_bytes = 3 * cfg.d_model * (cfg.expert_d_ff // cfg.expert_tp) * 4
    want = jax_out["collective_odd"]
    assert want["tokens"] and want["applied"]
    assert np.asarray(want["tables"]).max() >= 5  # slots past one shard
    for res in port:
        got = res["collective_odd"]
        assert got["stored_slots"] == 5
        assert got["applied"]
        assert got["tokens"] == want["tokens"]
        assert got["records"] == want["records"]
        np.testing.assert_array_equal(got["tables"], want["tables"])
        np.testing.assert_array_equal(got["tables"],
                                      port[0]["collective_odd"]["tables"])
        measured = [r for r in got["records"] if "cross_rows" in r]
        assert measured
        for r in measured:
            assert r["cross_rows"] == r["moves"]
            assert r["payload_bytes"] == r["cross_rows"] * expert_bytes
