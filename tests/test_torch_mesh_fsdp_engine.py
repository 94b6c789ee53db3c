"""FSDP serving: ``policy_for``'s decode policy for a model past 6 GB a
model-axis shard (``fsdp=True``, the activations replicated with
``batch_axes=()``, the dense KV cache's rows over ``data`` with
``cache_batch_axes=("data",)``) across four ``gloo`` ranks on the CPU,
against JAX's mesh path under the same policy on a forced 4-device host
mesh of the same shape (in a subprocess), at (4, 1) and (2, 2), on the
same numpy weights (JAX's ``init_params``, each rank keeping its ZeRO
block through ``params_from_numpy(..., policy=...)``):

* ``decode_step`` and ``prefill`` of granite smoke (fp32, 4 rows, random
  caches handed over whole to JAX and as the rank's rows and positions to
  the port) against JAX's jitted ones with the parameters and the cache
  placed by JAX's own specs: logits within ``rtol = atol = 1e-5``, the
  tolerance of ``tests/test_torch_mesh_attention.py``, the rank's rows of
  the cache within the same, every rank's logits bit-equal;
* the serving engine (granite smoke, 4 requests, decode capacity factor
  0.5: one slot's row a step, so that assignments drop) in ``"python"``
  and ``"scan"``: JAX's engine's tokens on every rank, and the same
  dropped-token count. Every rank runs every row as one dispatch group,
  as JAX's replicated batch does; a group a data rank (one row, never a
  drop) would change the tokens. Each rank holds its rows of the cache
  (4/d of them) and its ZeRO block of the expert stacks.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import MeshAt, ranks, run_jax  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import decode_step, prefill  # noqa: E402
from repro_torch.models.model import decode_cache_rows  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    ShardingPolicy,
    kv_shard,
    shard_range,
)
from repro_torch.telemetry import Telemetry  # noqa: E402

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"
SHAPES = [(4, 1), (2, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)
B, MAX_LEN = 4, 32
LENS = [0, 7, 15, 31]
PROMPTS = (8, 10)
REQUESTS, NEW = (8, 10, 8, 10), 8
# one slot's row a step for 4 rows of top-2 over 8 experts
DECODE_CF = 0.5


def _cfg(get_config):
    return dataclasses.replace(get_config(ARCH),
                               decode_capacity_factor=DECODE_CF)


def _policy(mesh):
    return ShardingPolicy(mesh=mesh, batch_axes=(),
                          cache_batch_axes=("data",), fsdp=True)


def _knobs(mode):
    return dict(max_batch=B, max_len=MAX_LEN, decode_mode=mode,
                placement_policy="linear", other_time_per_step=1e-4)


def _submit(eng, vocab_size):
    rng = np.random.default_rng(3)
    for P in REQUESTS:
        eng.submit(rng.integers(0, vocab_size, size=P), NEW)


def _inputs():
    cfg = _cfg(get_smoke_config)
    rng = np.random.default_rng(11)
    shape = (cfg.num_layers, B, MAX_LEN, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": rng.standard_normal(shape).astype(np.float32),
        "v": rng.standard_normal(shape).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
        "prompts": {P: rng.integers(0, cfg.vocab_size, (1, P)).astype(
            np.int32) for P in PROMPTS},
    }


INPUTS = _inputs()


def _cache_block(policy, cfg):
    """(rows, positions) of the global dense cache that the rank holds."""
    rows = decode_cache_rows(policy, B) or slice(None)
    axes = kv_shard(policy)
    pos = (slice(None) if axes is None
           else shard_range(MAX_LEN, axes, policy.mesh))
    return rows, pos


# ------------------------------------------------------------ the port side
def _rank(mesh, tree):
    cfg = _cfg(get_smoke_config)
    policy = _policy(mesh)
    Ev = cfg.num_virtual_experts
    params = params_from_numpy(tree, cfg, "cpu", torch.float32, policy=policy)
    rows, pos = _cache_block(policy, cfg)
    out = {"decode": [], "prefill": {}}
    with torch.no_grad():
        for cur in LENS:
            caches = {"attn": {n: torch.from_numpy(
                INPUTS[n][:, rows, pos].copy()) for n in ("k", "v")}}
            logits, caches, _ = decode_step(
                params, caches, torch.tensor(cur, dtype=torch.int32),
                torch.from_numpy(INPUTS["tokens"]), cfg, policy=policy,
                num_slots=Ev)
            out["decode"].append({"logits": logits.numpy(), **{
                n: caches["attn"][n].numpy() for n in ("k", "v")}})
        for P, toks in INPUTS["prompts"].items():
            logits, _ = prefill(params, torch.from_numpy(toks), cfg,
                                policy=policy, num_slots=Ev)
            out["prefill"][P] = logits.numpy()
    for mode in ("python", "scan"):
        params = params_from_numpy(tree, cfg, "cpu", torch.float32,
                                   policy=policy)
        eng = ServingEngine(params, cfg, EngineConfig(**_knobs(mode)),
                            policy=policy, telemetry=Telemetry())
        _submit(eng, cfg.vocab_size)
        eng.run(max_steps=200)
        out[mode] = {
            "tokens": {r.uid: list(r.generated) for r in eng.finished},
            "dropped": eng.telemetry.counter("dispatch.dropped_tokens").value,
            "cache": tuple(eng.caches["attn"]["k"].shape),
            "experts": tuple(eng.params["blocks"]["moe"]["w_gate"].shape),
            "paged": eng.paged,
        }
    return out


# ------------------------------------------------------------- the JAX side
def jax_fsdp_serving(payload):
    """JAX's jitted ``decode_step``/``prefill`` and its engine under the
    FSDP decode policy on each mesh shape (in a subprocess with 4 forced
    host devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.models.model import decode_step as jax_decode
    from repro.models.model import init_params as jax_init
    from repro.models.model import prefill as jax_prefill
    from repro.serving import EngineConfig as JEngineConfig
    from repro.serving import ServingEngine as JServingEngine
    from repro.sharding.policy import ShardingPolicy as JaxPolicy
    from repro.telemetry import Telemetry as JTelemetry

    assert jax.device_count() == 4
    cfg = _cfg(jax_smoke)
    out = {}
    for shape in SHAPES:
        mesh = make_host_mesh(*shape)
        policy = JaxPolicy(mesh=mesh, batch_axes=(),
                           cache_batch_axes=("data",), fsdp=True)
        params, specs = jax_init(cfg, jax.random.PRNGKey(1), policy,
                                 jnp.float32)
        res = {"tree": jax.tree.map(np.asarray, params), "decode": [],
               "prefill": {}}
        kv_spec = P(None, policy.cache_batch, policy.kv_seq, None, None)
        decode = jax.jit(lambda p, c, n, t: jax_decode(
            p, c, n, t, cfg, policy, decode_mode="python"))
        pre = jax.jit(lambda p, t: jax_prefill(p, {"tokens": t}, cfg, policy,
                                                stack_mode="python"))
        with mesh:
            for cur in LENS:
                caches = {"attn": {n: jax.device_put(
                    jnp.asarray(payload[n]), NamedSharding(mesh, kv_spec))
                    for n in ("k", "v")}}
                logits, new, _ = decode(params, caches, jnp.int32(cur),
                                        jnp.asarray(payload["tokens"]))
                res["decode"].append({"logits": np.asarray(logits), **{
                    n: np.asarray(new["attn"][n]) for n in ("k", "v")}})
            for S, toks in payload["prompts"].items():
                logits, _ = pre(params, jnp.asarray(toks))
                res["prefill"][S] = np.asarray(logits)
        eng = JServingEngine(params, cfg, policy,
                             JEngineConfig(**_knobs("scan")),
                             telemetry=JTelemetry())
        _submit(eng, cfg.vocab_size)
        eng.run(max_steps=200)
        res["tokens"] = {r.uid: list(r.generated) for r in eng.finished}
        res["dropped"] = eng.telemetry.counter(
            "dispatch.dropped_tokens").value
        out[shape] = res
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_fsdp_engine")
    jax_out = run_jax("test_torch_mesh_fsdp_engine:jax_fsdp_serving",
                      INPUTS, tmp)
    with ThreadPoolExecutor(2) as pool:
        futures = {shape: pool.submit(ranks, _rank, *shape,
                                      tmp / f"{shape[0]}x{shape[1]}",
                                      jax_out[shape]["tree"])
                   for shape in SHAPES}
        return {s: f.result() for s, f in futures.items()}, jax_out


@pytest.mark.parametrize("shape", SHAPES, ids=["4x1", "2x2"])
def test_fsdp_decode_step_matches_jax(results, shape):
    port, jax_out = results
    cfg = _cfg(get_smoke_config)
    want = jax_out[shape]
    for rank, res in enumerate(port[shape]):
        rows, pos = _cache_block(_policy(MeshAt(shape, rank)), cfg)
        for step, cur in enumerate(LENS):
            g, w = res["decode"][step], want["decode"][step]
            assert np.isfinite(g["logits"]).all(), (rank, cur)
            np.testing.assert_allclose(g["logits"], w["logits"], **TOL,
                                       err_msg=f"rank {rank} len {cur}")
            assert np.array_equal(
                g["logits"], port[shape][0]["decode"][step]["logits"])
            for n in ("k", "v"):
                assert g[n].shape[1] == B // shape[0], (rank, n)
                np.testing.assert_allclose(
                    g[n], w[n][:, rows, pos], **TOL,
                    err_msg=f"rank {rank} len {cur} cache {n}")
        for P in PROMPTS:
            np.testing.assert_allclose(res["prefill"][P], want["prefill"][P],
                                       **TOL, err_msg=f"rank {rank} {P}")


@pytest.mark.parametrize("mode", ["python", "scan"])
@pytest.mark.parametrize("shape", SHAPES, ids=["4x1", "2x2"])
def test_fsdp_engine_tokens_match_jax_engine(results, shape, mode):
    port, jax_out = results
    want = jax_out[shape]
    assert len(want["tokens"]) == len(REQUESTS)
    assert want["dropped"] > 0  # one dispatch group, and it drops
    for res in port[shape]:
        assert res[mode]["tokens"] == want["tokens"]
        assert res[mode]["dropped"] == want["dropped"]


@pytest.mark.parametrize("shape", SHAPES, ids=["4x1", "2x2"])
def test_fsdp_engine_holds_its_cache_rows_and_zero_block(results, shape):
    cfg = _cfg(get_smoke_config)
    data, model = shape
    Fv = cfg.expert_d_ff // cfg.expert_tp
    for res in results[0][shape]:
        for mode in ("python", "scan"):
            got = res[mode]
            assert not got["paged"]
            assert got["cache"] == (cfg.num_layers, B // data,
                                    MAX_LEN // model, cfg.num_kv_heads,
                                    cfg.head_dim)
            assert got["experts"] == (cfg.num_layers,
                                      cfg.num_virtual_experts // model,
                                      cfg.d_model // data, Fv)
