"""The port's model-axis layout against JAX's specs, in this process (no
ranks but the embedding test's): ``sharding.param_specs``, what
``bridge.params_from_numpy`` and ``models.init_params`` keep on each rank,
the dense KV cache's block, the vocabulary-parallel embedding and the
refusal of a dim the axis does not divide.

* ``param_specs`` of every family's smoke tree (the SSM and hybrid ones
  included) equals the specs JAX's ``init_params`` returns under a policy
  over a mesh of the same shape, leaf for leaf, plain and under FSDP
  (``data`` entries included), with one documented divergence: a pool
  the model axis does not divide is whole over ``model`` (``ev6``; its
  ``data`` entry stays).
* Each rank's leaves from ``params_from_numpy`` are ``np.split`` of JAX's
  global leaf by JAX's spec (bit for bit, fp32), and ``init_params``
  under the policy keeps leaves of the same shapes and bytes.
* The vocabulary-parallel lookup on 4 ``gloo`` ranks is bit-equal to the
  whole table's, tied (vocabulary rows) and untied (``d_model`` columns),
  in fp32 and bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import MeshAt, ranks  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.sharding.policy import ShardingPolicy as JaxPolicy  # noqa: E402
from repro.sharding.policy import host_policy as jax_host_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import policy_for  # noqa: E402
from repro_torch.models import init_decode_cache, init_params  # noqa: E402
from repro_torch.models.layers import embed_tokens  # noqa: E402
from repro_torch.models.attention import sequence_shards  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    ShardingPolicy,
    kv_shard,
    param_specs,
    take_shard,
)

torch.set_num_threads(1)

SHAPES = [(1, 4), (2, 2)]
# name: (arch, config overrides); ev6's 6 experts do not divide 4 ranks
CASES = {a: (a, {}) for a in ARCHS}
CASES["ev6"] = ("granite-moe-3b-a800m", dict(num_experts=6))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax(case, shape, fsdp=False):
    """JAX's numpy params (host draw) and its specs under a policy over a
    stand-in mesh of ``shape``, both flattened by path."""
    arch, overrides = CASES[case]
    cfg = dataclasses.replace(jax_smoke(arch), **overrides)
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0), jax_host_policy(),
                                jnp.float32)
    _, specs = jax_init_params(cfg, jax.random.PRNGKey(0),
                               JaxPolicy(mesh=MeshAt(shape, 0), fsdp=fsdp),
                               jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return tree, {k: tuple(v) for k, v in _flat(specs).items()}


def _expected(path, jspec, case, model):
    """JAX's spec, with the port's divergence for a pool the model axis
    does not divide: whole over ``model``."""
    arch, overrides = CASES[case]
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    spec = tuple(jspec)
    expert = path.split("/")[-1] in ("w_gate", "w_up", "w_down") and \
        "/moe/" in f"/{path}"
    if expert and cfg.num_virtual_experts % model:
        return tuple(None if a == "model" else a for a in spec)
    return spec


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_param_specs_equal_jax_specs(case, shape, fsdp):
    tree, jspecs = _jax(case, shape, fsdp)
    arch, overrides = CASES[case]
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    specs = _flat(param_specs(
        tree, ShardingPolicy(mesh=MeshAt(shape, 0), fsdp=fsdp), cfg))
    assert specs.keys() == jspecs.keys()
    for path, jspec in jspecs.items():
        assert specs[path] == _expected(path, jspec, case, shape[1]), path
    if not fsdp:  # the spec names "model" wherever JAX's does
        named = {p for p, s in jspecs.items() if "model" in s}
        assert {p for p, s in specs.items() if "model" in s} <= named


def _split(arr, spec, shape, rank):
    """``np.split`` of a global leaf by a spec at one rank."""
    mesh = MeshAt(shape, rank)
    for dim, axes in enumerate(spec):
        if axes is not None:
            arr = np.split(arr, mesh.size(axes), axis=dim)[mesh.index(axes)]
    return arr


@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_each_ranks_leaves_are_jax_leaves_split_by_jax_specs(case, shape):
    tree, jspecs = _jax(case, shape)
    arch, overrides = CASES[case]
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    flat = _flat(tree)
    for rank in range(shape[0] * shape[1]):
        policy = ShardingPolicy(mesh=MeshAt(shape, rank))
        mine = _flat(params_from_numpy(tree, cfg, "cpu", torch.float32,
                                       policy=policy))
        drawn = _flat(init_params(cfg, seed=0, device="cpu",
                                  dtype=torch.float32, policy=policy))
        assert mine.keys() == flat.keys() == drawn.keys()
        for path, arr in flat.items():
            want = _split(arr, _expected(path, jspecs[path], case, shape[1]),
                          shape, rank)
            assert np.array_equal(mine[path].numpy(), want), (rank, path)
            # a rank's drawn leaf: the same shape and bytes as its shard
            assert tuple(drawn[path].shape) == want.shape, (rank, path)
            assert drawn[path].nbytes == want.nbytes, (rank, path)


@pytest.mark.parametrize("shape,batch,cut", [((1, 4), 4, 4), ((2, 2), 4, 2),
                                             ((2, 2), 1, 4)],
                         ids=["1x4", "2x2", "2x2-long-context"])
def test_dense_cache_holds_the_ranks_block_of_positions(shape, batch, cut):
    """The dense cache's bytes a rank: 1/m of one process's over
    ``model``; with a global batch under the data extent (``policy_for``'s
    long-context decode) 1/(d·m) over ``("data", "model")``."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    policy = policy_for(MeshAt(shape, 0), step_kind="decode",
                        global_batch=batch)
    one = init_decode_cache(cfg, batch, 32, device="meta")
    mine = init_decode_cache(cfg, batch, 32, device="meta", policy=policy)
    for name in ("k", "v"):
        assert mine["attn"][name].shape[2] == 32 // cut
        assert mine["attn"][name].numel() * cut == one["attn"][name].numel()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_one_predicate_keeps_the_ssm_and_hybrid_families_whole(arch):
    """No family is kept whole under a mesh any more (the name is the
    test's history: the SSM and hybrid families once were). Every
    family's ``param_specs`` name ``model`` (the SSD heads among them for
    the SSM families), its dense KV cache (where it has one) and its SSM
    state are cut over the axis, and its sequence splits; without a mesh
    nothing is."""
    cfg = get_smoke_config(arch)
    policy = ShardingPolicy(mesh=MeshAt((1, 4), 0))
    specs = _flat(param_specs(init_params(cfg, device="meta"), policy, cfg))
    named = {p for p, spec in specs.items() if spec and "model" in spec}
    assert "embed" in named, named
    if cfg.ssm_state:
        assert {"blocks/ssm/wz", "blocks/ssm/out_proj",
                "blocks/ssm/A_log"} <= named, named
        assert "blocks/ssm/wb" not in named
    assert kv_shard(policy) == ("model",)
    assert kv_shard(None) is None
    assert sequence_shards(policy, 16) == 4
    assert sequence_shards(None, 16) == 1
    one = init_decode_cache(cfg, 2, 32, device="meta")
    mine = init_decode_cache(cfg, 2, 32, device="meta", policy=policy)
    for key, sub in one.items():
        for name, t in sub.items():
            cut = 4 if name in ("k", "v", "state", "conv_x") else 1
            assert mine[key][name].numel() * cut == t.numel(), (key, name)


def test_a_dim_the_axis_does_not_divide_raises():
    """Three model ranks divide none of granite smoke's 128-row vocabulary
    or 64-wide projections: the conversion names the leaf; a KV sequence
    of 30 positions does not split over 4 ranks."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    tree, _ = _jax("granite-moe-3b-a800m", (1, 4))
    named = r"^(embed|blocks/attn/w[qkvo]): dim \d of size \d+ does not " \
        r"shard over 'model' \(3 ranks\)$"
    with pytest.raises(ValueError, match=named):
        params_from_numpy(tree, cfg, "cpu", torch.float32,
                          policy=ShardingPolicy(mesh=MeshAt((1, 3), 0)))
    with pytest.raises(ValueError, match="^embed: dim 0 of size 128"):
        init_params(cfg, device="meta", dtype=torch.float32,
                    policy=ShardingPolicy(mesh=MeshAt((1, 3), 0)))
    with pytest.raises(ValueError, match="KV cache"):
        init_decode_cache(cfg, 2, 30, device="meta",
                          policy=ShardingPolicy(mesh=MeshAt((1, 4), 0)))


# ----------------------------------------------- the vocabulary-parallel lookup
def _lookup(mesh, tables, ids):
    policy = ShardingPolicy(mesh=mesh)
    out = {}
    for arch, table in tables.items():
        cfg = get_smoke_config(arch)
        tree = {"embed": table}
        spec = param_specs(tree, policy, cfg)["embed"] if cfg.tie_embeddings \
            else (None, "model")
        for dtype in (torch.float32, torch.bfloat16):
            whole = torch.from_numpy(table).to(dtype)
            mine = take_shard(whole, spec, mesh).contiguous()
            got = embed_tokens(torch.from_numpy(ids), mine, cfg, policy)
            out[(arch, str(dtype))] = (got.float().numpy(),
                                       whole[torch.from_numpy(ids)].float()
                                       .numpy())
    return out


def test_vocabulary_parallel_lookup_is_the_whole_lookup(tmp_path):
    rng = np.random.default_rng(1)
    tables, V = {}, 128
    for arch in ("granite-moe-3b-a800m", "qwen3-32b"):  # tied, untied
        cfg = get_smoke_config(arch)
        assert cfg.padded_vocab == V
        tables[arch] = rng.standard_normal((V, cfg.d_model)).astype(np.float32)
    ids = np.concatenate([np.arange(V), rng.integers(0, V, 64)]).reshape(
        3, 64)
    for res in ranks(_lookup, 1, 4, tmp_path, tables, ids):
        for key, (got, want) in res.items():
            assert np.array_equal(got, want), key
