"""The SSM and hybrid families under JAX's mesh layout across ``gloo``
ranks on the CPU, against JAX's mesh path on a forced 4-device host mesh
of the same shape (in a subprocess): ``decode_step`` and ``prefill`` of
mamba2's and zamba2's smoke configs, each rank holding its shards
(``params_from_numpy(..., policy=...)``: the SSD heads, zamba2's shared
attention and MLP, the tied vocabulary over ``model``) and its block of
the dense caches (the SSM state's heads, ``conv_x``'s channels, the
shared block's K/V positions, the rows over ``data``), against JAX's
jitted ``decode_step`` and ``prefill`` with the parameters and the caches
placed by JAX's own specs, on the same numpy weights (random ``dt_bias``,
``D``, ``gate_norm`` and conv biases, so that they count) and caches.

* at (1, 4) and (2, 2) (the decode batch over ``data``);
* prefill with S % 4 = 0 (sequence-parallel: each mamba block gathers the
  rank's rows and reduce-scatters its out-projection) and S % 4 ≠ 0
  (every rank runs every row);
* JAX's mesh path in ``"python"`` (``decode_mode``, ``stack_mode``): the
  reference's own ``"scan"`` parts from it for zamba2 (ROADMAP C1).

Logits, the SSM states and the K/V caches within ``rtol = atol = 1e-5``
(fp32, ``tests/test_torch_mesh_attention.py``'s): ``out_proj``'s row
partials are summed in fp32 in rank order, and the gathered logits and
the partial-softmax combine add in other orders than JAX's GSPMD does.
Every rank returns the same logits, bit for bit. Each rank's cache
shapes are JAX's ``NamedSharding.shard_shape`` of
``repro.launch.specs.cache_specs`` at the rank's shape.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import MeshAt, ranks, run_jax  # noqa: E402
from repro_torch.bridge import params_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    init_decode_cache,
    init_params,
    prefill,
)
from repro_torch.models.model import data_rows  # noqa: E402
from repro_torch.sharding import ShardingPolicy, kv_shard, shard_range  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, MAX_LEN = 2, 32
ARCHS = ("mamba2-1.3b", "zamba2-1.2b")
SHAPES = [(1, 4), (2, 2)]
LENS = (0, 9, 31)  # decode positions (zamba2's K/V write index)
PROMPTS = (16, 14)  # S % 4 == 0 (sequence-parallel) and its fallback


def _inputs(arch, seed):
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    tree = state_to_numpy(init_params(cfg, seed=seed, device="cpu",
                                      dtype=torch.float32))
    ssm = tree["blocks"]["ssm"]
    for k in ("dt_bias", "D", "gate_norm", "conv_x_b", "conv_b_b",
              "conv_c_b"):
        ssm[k] = (ssm[k] + rng.standard_normal(ssm[k].shape) * 0.1).astype(
            np.float32)
    caches = {
        key: {name: (rng.standard_normal(t.shape) * 0.5).astype(np.float32)
              for name, t in sub.items()}
        for key, sub in init_decode_cache(cfg, B, MAX_LEN, device="meta",
                                          dtype=torch.float32).items()}
    return {
        "params": tree, "caches": caches,
        "tokens": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
        "prompts": {P: rng.integers(0, cfg.vocab_size, (B, P)).astype(
            np.int32) for P in PROMPTS},
    }


INPUTS = {arch: _inputs(arch, seed) for seed, arch in enumerate(ARCHS)}


def rank_block(name, t, policy, cfg):
    """The block of a global cache leaf (numpy) that the rank holds: its
    rows, and the state's heads and ``conv_x``'s channels over ``model``
    (the K/V panels: their positions over ``kv_seq``)."""
    mesh = policy.mesh
    rows = data_rows(policy, B) or slice(None)
    lead = {"state": 4, "conv_x": 3, "conv_b": 3, "conv_c": 3,
            "k": 4, "v": 4}[name]
    batch_dim = t.ndim - lead
    t = t[(slice(None),) * batch_dim + (rows,)]
    m = mesh.size("model")
    if name == "state":
        per = t.shape[batch_dim + 1] // m
        lo = mesh.index("model") * per
        return t[(slice(None),) * (batch_dim + 1) + (slice(lo, lo + per),)]
    if name == "conv_x":
        per = t.shape[-1] // m
        lo = mesh.index("model") * per
        return t[..., lo:lo + per]
    if name in ("k", "v"):
        pos = shard_range(t.shape[batch_dim + 1], kv_shard(policy), mesh)
        return t[(slice(None),) * (batch_dim + 1) + (pos,)]
    return t


# ------------------------------------------------------------ the port side
def _rank(mesh):
    policy = ShardingPolicy(mesh=mesh)
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        inp = INPUTS[arch]
        params = params_from_numpy(inp["params"], cfg, "cpu", torch.float32,
                                   policy=policy)
        res = {"decode": [], "prefill": {}}
        with torch.no_grad():
            for cur in LENS:
                caches = {key: {name: torch.from_numpy(np.array(
                    rank_block(name, t, policy, cfg)))
                    for name, t in sub.items()}
                    for key, sub in inp["caches"].items()}
                logits, caches, _ = decode_step(
                    params, caches, torch.tensor(cur, dtype=torch.int32),
                    torch.from_numpy(inp["tokens"]), cfg, policy=policy)
                res["decode"].append({"logits": logits.numpy(),
                                      "caches": state_to_numpy(caches)})
            for P, toks in inp["prompts"].items():
                logits, caches = prefill(params, torch.from_numpy(toks), cfg,
                                         policy=policy)
                res["prefill"][P] = {"logits": logits.numpy(),
                                     "caches": state_to_numpy(caches)}
        res["empty_cache"] = {
            key: {name: tuple(t.shape) for name, t in sub.items()}
            for key, sub in init_decode_cache(
                cfg, B if data_rows(policy, B) is None else B // 2, MAX_LEN,
                device="meta", policy=policy).items()}
        out[arch] = res
    return out


# ------------------------------------------------------------- the JAX side
def jax_ssm(payload):
    """JAX's jitted ``decode_step`` and ``prefill`` on its mesh, and the
    shard shapes of its cache specs (in a subprocess with 4 forced host
    devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.launch.specs import cache_specs as jax_cache_specs
    from repro.models.model import decode_step as jax_decode
    from repro.models.model import init_params as jax_init
    from repro.models.model import prefill as jax_prefill
    from repro.sharding.policy import ShardingPolicy as JaxPolicy

    assert jax.device_count() == 4
    out = {}
    for shape in payload["shapes"]:
        mesh = make_host_mesh(*shape)
        policy = JaxPolicy(mesh=mesh)
        for arch in payload["archs"]:
            inp = payload["inputs"][arch]
            cfg = jax_smoke(arch)
            _, specs = jax_init(cfg, jax.random.PRNGKey(0), policy,
                                jnp.float32)

            def put(a, spec):
                return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

            params = jax.tree.map(put, inp["params"], specs)
            shapes, cspecs = jax_cache_specs(cfg, policy, B, MAX_LEN,
                                             jnp.float32)
            decode = jax.jit(lambda p, c, n, t, cfg=cfg: jax_decode(
                p, c, n, t, cfg, policy, decode_mode="python"))
            pre = jax.jit(lambda p, t, cfg=cfg: jax_prefill(
                p, {"tokens": t}, cfg, policy, stack_mode="python"))
            res = {"decode": [], "prefill": {}, "cache_shards": jax.tree.map(
                lambda s: tuple(s.sharding.shard_shape(s.shape)), shapes)}
            with mesh:
                for cur in payload["lens"]:
                    caches = jax.tree.map(put, inp["caches"], cspecs)
                    logits, new, _ = decode(params, caches, jnp.int32(cur),
                                            jnp.asarray(inp["tokens"]))
                    res["decode"].append({
                        "logits": np.asarray(logits),
                        "caches": jax.tree.map(np.asarray, new)})
                for P, toks in inp["prompts"].items():
                    logits, caches = pre(params, jnp.asarray(toks))
                    res["prefill"][P] = {
                        "logits": np.asarray(logits),
                        "caches": jax.tree.map(np.asarray, caches)}
            out[(shape, arch)] = res
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ssm")
    with ThreadPoolExecutor(1) as pool:  # JAX runs beside the ranks
        jax_out = pool.submit(run_jax, "test_torch_mesh_ssm:jax_ssm",
                              {"shapes": SHAPES, "archs": ARCHS,
                               "lens": LENS, "inputs": INPUTS}, tmp)
        port = {shape: ranks(_rank, *shape, tmp) for shape in SHAPES}
        return port, jax_out.result()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif v is not None:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_mesh_path(results, arch, shape):
    port, jax_out = results
    cfg = get_smoke_config(arch)
    want = jax_out[(shape, arch)]["decode"]
    for rank, res in enumerate(port[shape]):
        policy = ShardingPolicy(mesh=MeshAt(shape, rank))
        for step, cur in enumerate(LENS):
            g, w = res[arch]["decode"][step], want[step]
            assert np.isfinite(g["logits"]).all(), (rank, cur)
            np.testing.assert_allclose(g["logits"], w["logits"], **TOL,
                                       err_msg=f"rank {rank} len {cur}")
            assert np.array_equal(
                g["logits"], port[shape][0][arch]["decode"][step]["logits"])
            got = dict(_leaves(g["caches"]))
            for path, t in _leaves(w["caches"]):
                block = rank_block(path.split("/")[-1], t, policy, cfg)
                np.testing.assert_allclose(
                    got[path], block, **TOL,
                    err_msg=f"rank {rank} len {cur} cache {path}")


@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax_mesh_path(results, arch, shape):
    """Logits whole on every rank; the SSM caches the rank's heads (and
    ``conv_x``'s channels) of the whole prompt's, every row (the prefill
    runs the whole batch on every rank); the shared block's K/V the
    rank's block of positions where the prompt splits over ``model``."""
    port, jax_out = results
    m = shape[1]
    for rank, res in enumerate(port[shape]):
        mesh = MeshAt(shape, rank)
        for P in PROMPTS:
            g = res[arch]["prefill"][P]
            w = jax_out[(shape, arch)]["prefill"][P]
            np.testing.assert_allclose(g["logits"], w["logits"], **TOL,
                                       err_msg=f"rank {rank} prompt {P}")
            got = dict(_leaves(g["caches"]))
            for path, t in _leaves(w["caches"]):
                name = path.split("/")[-1]
                if name == "state":
                    per = t.shape[-3] // m
                    t = t[..., mesh.index("model") * per:, :, :][..., :per,
                                                               :, :]
                elif name == "conv_x":
                    per = t.shape[-1] // m
                    t = t[..., mesh.index("model") * per:][..., :per]
                elif name in ("k", "v") and P % m == 0:
                    t = t[..., shard_range(P, "model", mesh), :, :]
                assert got[path].shape == t.shape, (rank, P, path)
                np.testing.assert_allclose(
                    got[path], t, **TOL,
                    err_msg=f"rank {rank} prompt {P} cache {path}")


@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_are_jax_cache_specs_shards(results, arch, shape):
    port, jax_out = results
    want = dict(_leaves(jax_out[(shape, arch)]["cache_shards"]))
    for res in port[shape]:
        got = dict(_leaves(res[arch]["empty_cache"]))
        assert got == want
