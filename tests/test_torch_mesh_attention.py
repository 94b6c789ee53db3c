"""The model-axis layout's decode and prefill across ``gloo`` ranks on the
CPU against JAX's mesh path on a forced 4-device host mesh of the same
shape (in a subprocess): ``decode_step`` and ``prefill`` of the port's
ranks, each holding its shards (``params_from_numpy(..., policy=...)``)
and its block of the dense KV cache, against JAX's jitted ``decode_step``
and ``prefill`` with the parameters and the cache placed by JAX's own
specs, on the same numpy weights (random q/k/v biases and q/k norm
scales, so that they count) and caches.

* decode on the dense cache with the write position at every rank's
  first and last position (granite smoke at (1, 4): KV·hd = 32, so each
  rank holds half a KV head's columns), where every position a rank holds
  lies past ``cur_len`` (no NaN from its empty partial softmax);
* the window ring through a wrap (Mixtral smoke, window 32: a 32-slot
  ring over 4 ranks, lengths past 32);
* ``qkv_bias`` (qwen1.5 smoke) and ``qk_norm`` (qwen3 smoke);
* at (2, 2), the batch over ``data`` with the KV sequence over ``model``,
  and ``policy_for``'s long-context decode (a global batch of 1 under 2
  data ranks: the batch replicated, the KV sequence over
  ``("data", "model")``);
* prefill with S % 4 = 0 (sequence-parallel: each rank's cache is its
  block of positions) and with S % 4 ≠ 0 (JAX's fallback to M = 1 at
  (1, 4): every rank holds every position).

Logits and caches within ``rtol = atol = 1e-5`` (fp32, the mesh MoE
layer's tolerance in ``tests/test_torch_mesh_moe.py``): the row-parallel
``wo``, the gathered logits and the partial-softmax combine add in other
orders than JAX's GSPMD does. Every rank returns the same logits, bit for
bit.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import MeshAt, ranks, run_jax  # noqa: E402
from repro_torch.bridge import params_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import policy_for  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.models.model import data_rows  # noqa: E402
from repro_torch.sharding import ShardingPolicy, kv_shard, shard_range  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, MAX_LEN = 2, 32
# name: (arch, mesh shape, long-context policy, decode lengths)
S_LOC = MAX_LEN // 4
EDGES = [c for r in range(4) for c in (r * S_LOC, r * S_LOC + S_LOC - 1)]
CASES = {
    "granite": ("granite-moe-3b-a800m", (1, 4), False, EDGES),
    "mixtral_ring": ("mixtral-8x7b", (1, 4), False, [5, 31, 32, 40, 63]),
    "qwen15_bias": ("qwen1.5-4b", (1, 4), False, [3, 16]),
    "qwen3_norm": ("qwen3-32b", (1, 4), False, [3, 16]),
    "granite_2x2": ("granite-moe-3b-a800m", (2, 2), False, [0, 15, 16, 31]),
    "granite_long": ("granite-moe-3b-a800m", (2, 2), True, [0, 7, 8, 31]),
}
PROMPTS = (16, 14)  # S % 4 == 0 (sequence-parallel) and its fallback


def _batch(name):
    return 1 if CASES[name][2] else B


def _inputs(name, seed):
    arch = CASES[name][0]
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    tree = state_to_numpy(init_params(cfg, seed=seed, device="cpu",
                                      dtype=torch.float32))
    attn = tree["blocks"]["attn"]
    for k in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if k in attn:
            attn[k] = (rng.standard_normal(attn[k].shape) * 0.1).astype(
                np.float32)
    L, b = cfg.num_layers, _batch(name)
    S = min(cfg.sliding_window, MAX_LEN * 2) if cfg.sliding_window else \
        MAX_LEN
    shape = (L, b, S, cfg.num_kv_heads, cfg.head_dim)
    return {
        "params": tree,
        "k": rng.standard_normal(shape).astype(np.float32),
        "v": rng.standard_normal(shape).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32),
        "prompts": {P: rng.integers(0, cfg.vocab_size, (b, P)).astype(
            np.int32) for P in PROMPTS},
    }


INPUTS = {name: _inputs(name, seed) for seed, name in enumerate(CASES)}


def _policy(mesh, name):
    if CASES[name][2]:
        return policy_for(mesh, step_kind="decode", global_batch=1)
    return ShardingPolicy(mesh=mesh)


def _cache_block(policy, cfg, batch, S):
    """(rows, positions) of the global dense cache that the rank holds."""
    rows = data_rows(policy, batch) or slice(None)
    axes = kv_shard(policy)
    pos = slice(None) if axes is None else shard_range(S, axes, policy.mesh)
    return rows, pos


# ------------------------------------------------------------ the port side
def _rank(mesh, names):
    out = {}
    for name in names:
        cfg = get_smoke_config(CASES[name][0])
        inp = INPUTS[name]
        policy = _policy(mesh, name)
        params = params_from_numpy(inp["params"], cfg, "cpu", torch.float32,
                                   policy=policy)
        b = _batch(name)
        rows, pos = _cache_block(policy, cfg, b, inp["k"].shape[2])
        res = {"decode": []}
        with torch.no_grad():
            for cur in CASES[name][3]:
                caches = {"attn": {
                    n: torch.from_numpy(inp[n][:, rows, pos].copy())
                    for n in ("k", "v")}}
                logits, caches, _ = decode_step(
                    params, caches, torch.tensor(cur, dtype=torch.int32),
                    torch.from_numpy(inp["tokens"]), cfg, policy=policy,
                    num_slots=cfg.num_virtual_experts if cfg.is_moe else None)
                res["decode"].append({
                    "logits": logits.numpy(),
                    **{n: caches["attn"][n].numpy() for n in ("k", "v")}})
            res["prefill"] = {}
            for P, toks in inp["prompts"].items():
                logits, caches = prefill(
                    params, torch.from_numpy(toks), cfg, policy=policy,
                    num_slots=cfg.num_virtual_experts if cfg.is_moe else None)
                res["prefill"][P] = {
                    "logits": logits.numpy(),
                    **{n: caches["attn"][n].numpy() for n in ("k", "v")}}
        out[name] = res
    return out


# ------------------------------------------------------------- the JAX side
def jax_attention(payload):
    """JAX's jitted ``decode_step`` and ``prefill`` on its mesh (in a
    subprocess with 4 forced host devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.mesh import make_host_mesh, policy_for as jax_policy_for
    from repro.models.model import decode_step as jax_decode
    from repro.models.model import init_params as jax_init
    from repro.models.model import prefill as jax_prefill
    from repro.sharding.policy import ShardingPolicy as JaxPolicy

    assert jax.device_count() == 4
    out = {}
    for name, (arch, shape, long_ctx, lens) in payload["cases"].items():
        inp = payload["inputs"][name]
        cfg = jax_smoke(arch)
        mesh = make_host_mesh(*shape)
        policy = (jax_policy_for(mesh, step_kind="decode", global_batch=1)
                  if long_ctx else JaxPolicy(mesh=mesh))
        _, specs = jax_init(cfg, jax.random.PRNGKey(0), policy, jnp.float32)

        def put(a, spec):
            # a pool the axis does not divide is replicated, as JAX's
            # own tests hand it over
            ok = all(a.shape[i] % mesh.shape[ax] == 0
                     for i, ax in enumerate(spec) if isinstance(ax, str))
            return jax.device_put(jnp.asarray(a),
                                  NamedSharding(mesh, spec if ok else P()))

        params = jax.tree.map(put, inp["params"], specs)
        kv_spec = P(None, policy.cache_batch, policy.kv_seq, None, None)
        decode = jax.jit(lambda p, c, n, t: jax_decode(
            p, c, n, t, cfg, policy, decode_mode="python"))
        pre = jax.jit(lambda p, t: jax_prefill(p, {"tokens": t}, cfg, policy,
                                                stack_mode="python"))
        res = {"decode": [], "prefill": {}}
        with mesh:
            for cur in lens:
                caches = {"attn": {n: put(inp[n], kv_spec)
                                   for n in ("k", "v")}}
                logits, new, _ = decode(params, caches, jnp.int32(cur),
                                        jnp.asarray(inp["tokens"]))
                res["decode"].append({
                    "logits": np.asarray(logits),
                    **{n: np.asarray(new["attn"][n]) for n in ("k", "v")}})
            for S, toks in inp["prompts"].items():
                logits, caches = pre(params, jnp.asarray(toks))
                res["prefill"][S] = {
                    "logits": np.asarray(logits),
                    **{n: np.asarray(caches["attn"][n]) for n in ("k", "v")}}
        out[name] = res
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_attention")
    with ThreadPoolExecutor(1) as pool:  # JAX runs beside the ranks
        jax_out = pool.submit(run_jax, "test_torch_mesh_attention:"
                              "jax_attention",
                              {"cases": CASES, "inputs": INPUTS}, tmp)
        port = {}
        for shape in sorted({c[1] for c in CASES.values()}):
            names = [n for n, c in CASES.items() if c[1] == shape]
            port[shape] = ranks(_rank, *shape, tmp, names)
        return port, jax_out.result()


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_jax_mesh_path(results, name):
    port, jax_out = results
    arch, shape, _, lens = CASES[name]
    cfg = get_smoke_config(arch)
    want = jax_out[name]["decode"]
    for rank, res in enumerate(port[shape]):
        got = res[name]["decode"]
        policy = _policy(MeshAt(shape, rank), name)
        rows, pos = _cache_block(policy, cfg, _batch(name),
                                 INPUTS[name]["k"].shape[2])
        for step, cur in enumerate(lens):
            g, w = got[step], want[step]
            assert np.isfinite(g["logits"]).all(), (rank, cur)
            np.testing.assert_allclose(g["logits"], w["logits"], **TOL,
                                       err_msg=f"rank {rank} len {cur}")
            assert np.array_equal(g["logits"],
                                  port[shape][0][name]["decode"][step][
                                      "logits"]), (rank, cur)
            for n in ("k", "v"):
                np.testing.assert_allclose(
                    g[n], w[n][:, rows, pos], **TOL,
                    err_msg=f"rank {rank} len {cur} cache {n}")


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax_mesh_path(results, name):
    port, jax_out = results
    shape = CASES[name][1]
    for rank, res in enumerate(port[shape]):
        mesh = MeshAt(shape, rank)
        for P in PROMPTS:
            g, w = res[name]["prefill"][P], jax_out[name]["prefill"][P]
            np.testing.assert_allclose(g["logits"], w["logits"], **TOL,
                                       err_msg=f"rank {rank} prompt {P}")
            m = shape[1]
            block = (slice(None) if P % m else
                     shard_range(P, "model", mesh))
            for n in ("k", "v"):
                want = w[n][..., block, :, :]
                assert g[n].shape == want.shape, (rank, P, n)
                np.testing.assert_allclose(
                    g[n], want, **TOL, err_msg=f"rank {rank} prompt {P} {n}")
