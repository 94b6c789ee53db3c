"""The collective row exchange under FSDP: Mixtral smoke's online engine
of ``tests/test_torch_mesh_engine.py`` (``migration_via="collective"``,
budgeted batches that swap rows between the model ranks mid-run) at
(2, 2) under the FSDP decode policy (``fsdp=True``, ``batch_axes=()``,
the cache's rows over ``data``), across four ``gloo`` ranks on the CPU,
against JAX's engine under the same policy on a forced 4-device host
mesh (in a subprocess), on the same weights.

The model axis divides the 4-slot pool, so each rank holds 2 slots, and
under FSDP its half of each slot's ``d_model``: a swap moves that block
of the rows within the rank's data row. The port's ``"scan"`` and
``"python"`` give JAX's tokens on every rank; the records
(``cross_rows``, ``payload_bytes``: a slot's whole row, both data rows'
blocks) equal JAX's; the router tables equal JAX's and the controller's
on every rank; and each rank's expert rows after the last batch are its
block of JAX's final rows, bit for bit (a swap copies rows)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_mesh_engine as base  # noqa: E402
from test_torch_mesh import MeshAt, ranks, run_jax  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.online as tonline  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.sharding import ShardingPolicy, param_specs, take_shard  # noqa: E402

torch.set_num_threads(1)

SHAPE = (2, 2)
EXPERTS = ("w_gate", "w_up", "w_down")


def _policy(mesh):
    return ShardingPolicy(mesh=mesh, batch_axes=(),
                          cache_batch_axes=("data",), fsdp=True)


# ------------------------------------------------------------ the port side
def _rank(mesh, tree):
    policy = _policy(mesh)
    cfg = base._cfg(get_smoke_config)
    profile = base._profile(tcore)
    out = {}
    for mode in ("scan", "python"):
        params = params_from_numpy(tree, cfg, "cpu", torch.float32,
                                   policy=policy)
        eng = ServingEngine(
            params, cfg,
            EngineConfig(**base._online_knobs(tcore, tonline, mode)),
            policy=policy, profile=profile, num_devices=base.NUM_DEVICES)
        base._submit(eng, cfg.vocab_size, 17)
        eng.run(max_steps=120)
        out[mode] = base._summary(eng)
        out[mode]["controller_tables"] = eng.controller.expert_to_slot_tables()
        out[mode]["rows"] = {n: eng.params["blocks"]["moe"][n].numpy().copy()
                             for n in EXPERTS}
        out[mode]["kv_rows"] = int(eng.caches["attn"]["k"].shape[1])
    return out


# ------------------------------------------------------------- the JAX side
def jax_fsdp_collective(payload):
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

    cfg = base._cfg(jax_smoke)
    mesh = make_host_mesh(*SHAPE)
    policy = JaxPolicy(mesh=mesh, batch_axes=(), cache_batch_axes=("data",),
                       fsdp=True)
    profile = base._profile(jcore)
    out = {}
    for mode in ("scan", "python"):
        params, _ = init_params(cfg, jax.random.PRNGKey(0), policy,
                                jnp.float32)
        out["tree"] = jax.tree.map(np.asarray, params)
        eng = JServingEngine(
            params, cfg, policy,
            JEngineConfig(**base._online_knobs(jcore, jonline, mode)),
            profile=profile, num_devices=base.NUM_DEVICES)
        base._submit(eng, cfg.vocab_size, 17)
        eng.run(max_steps=120)
        out[mode] = base._summary(eng)
        out[mode]["rows"] = {n: np.asarray(eng.params["blocks"]["moe"][n])
                             for n in EXPERTS}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_fsdp_collective")
    jax_out = run_jax("test_torch_mesh_fsdp_collective:jax_fsdp_collective",
                      {}, tmp)
    return ranks(_rank, *SHAPE, tmp, jax_out["tree"]), jax_out


@pytest.mark.parametrize("mode", ["scan", "python"])
def test_fsdp_collective_engine_matches_jax(results, mode):
    port, jax_out = results
    want = jax_out[mode]
    assert want["records"] and want["tokens"] and want["applied"]
    cfg = base._cfg(get_smoke_config)
    row_bytes = 3 * cfg.d_model * (cfg.expert_d_ff // cfg.expert_tp) * 4
    for res in port:
        got = res[mode]
        assert got["tokens"] == want["tokens"]
        assert got["records"] == want["records"]
        measured = [r for r in got["records"] if "cross_rows" in r]
        assert measured and all(r["via"] == "collective" for r in measured)
        for r in measured:
            assert r["payload_bytes"] == r["cross_rows"] * row_bytes
        np.testing.assert_array_equal(got["tables"], want["tables"])
        np.testing.assert_array_equal(got["tables"], got["controller_tables"])


@pytest.mark.parametrize("mode", ["scan", "python"])
def test_fsdp_rows_after_the_swaps_are_jax_rows(results, mode):
    port, jax_out = results
    cfg = base._cfg(get_smoke_config)
    moved = False
    for rank, res in enumerate(port):
        mesh = MeshAt(SHAPE, rank)
        specs = param_specs(jax_out["tree"], _policy(mesh), cfg)
        assert res[mode]["kv_rows"] == 2  # the cache's rows over data
        for name in EXPERTS:
            spec = specs["blocks"]["moe"][name]
            assert "data" in spec and "model" in spec
            want = take_shard(jax_out[mode]["rows"][name], spec, mesh)
            got = res[mode]["rows"][name]
            assert got.shape == want.shape, (rank, name)
            assert np.array_equal(got, want), (rank, name)
            start = take_shard(jax_out["tree"]["blocks"]["moe"][name], spec,
                               mesh)
            moved |= not np.array_equal(got, start)
    assert moved
