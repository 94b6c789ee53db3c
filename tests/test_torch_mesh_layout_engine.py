"""The port's serving engine under the model-axis layout across four
``gloo`` ranks on the CPU against JAX's engine on a forced 4-device host
mesh of the same shape (in a subprocess), on the same weights (JAX's
``init_params``, handed over as numpy and sharded by
``params_from_numpy(..., policy=...)``): granite smoke (a KV head split
over the model ranks at (1, 4)), Mixtral smoke (its 32-slot window ring
sharded over ``model``, wrapping: prompts plus new tokens pass 32) and
qwen3 smoke (dense: the tensor-parallel MLP and ``qk_norm``), each in
``"python"`` and ``"scan"`` (eager on the CPU), with the linear placement.
Prompts of 8 and 10 tokens: 8 prefills sequence-parallel on every shape,
10 falls back to every rank running every row at (1, 4) and runs
sequence-parallel at (2, 2).

Greedy tokens must equal JAX's mesh engine's, on every rank and in both
modes; each rank's dense cache holds its block of positions (``kv_mode=
"auto"`` is dense under a mesh, as JAX's). qwen3 also runs with
``kv_mode="paged"``: the pool whole on every rank, as JAX's. This file
runs (1, 4); ``test_torch_mesh_layout_engine_2x2.py`` runs (2, 2) with
these helpers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import ranks, run_jax  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.sharding import ShardingPolicy  # noqa: E402

torch.set_num_threads(1)

# arch: (max_len, new tokens a request)
ARCHS = {"granite-moe-3b-a800m": (32, 8), "mixtral-8x7b": (64, 30),
         "qwen3-32b": (32, 8)}
PROMPTS = (8, 10, 8, 10)
SHAPE = (1, 4)
# the paged pool is whole on every rank (JAX: "the paged pool is
# unsharded"); under a mesh it is asked for, not the default
PAGED = "qwen3-32b"


def _knobs(arch, mode, kv_mode="auto"):
    return dict(max_batch=4, max_len=ARCHS[arch][0], decode_mode=mode,
                placement_policy="linear", other_time_per_step=1e-4,
                kv_mode=kv_mode)


def _submit(eng, vocab_size, new_tokens, seed):
    rng = np.random.default_rng(seed)
    for P in PROMPTS:
        eng.submit(rng.integers(0, vocab_size, size=P), new_tokens)


def _tokens(eng):
    return {r.uid: list(r.generated) for r in eng.finished}


# ------------------------------------------------------------ the port side
def rank_engines(mesh, trees):
    policy = ShardingPolicy(mesh=mesh)
    out = {}
    for arch, tree in trees.items():
        cfg = get_smoke_config(arch)
        for mode in ("scan", "python"):
            params = params_from_numpy(tree, cfg, "cpu", torch.float32,
                                       policy=policy)
            eng = ServingEngine(params, cfg,
                                EngineConfig(**_knobs(arch, mode)),
                                policy=policy)
            _submit(eng, cfg.vocab_size, ARCHS[arch][1], 3)
            eng.run(max_steps=200)
            out[(arch, mode)] = {
                "tokens": _tokens(eng),
                "cache": tuple(eng.caches["attn"]["k"].shape),
                "paged": eng.paged,
            }
    cfg = get_smoke_config(PAGED)
    params = params_from_numpy(trees[PAGED], cfg, "cpu", torch.float32,
                               policy=policy)
    eng = ServingEngine(params, cfg,
                        EngineConfig(**_knobs(PAGED, "python", "paged")),
                        policy=policy)
    _submit(eng, cfg.vocab_size, ARCHS[PAGED][1], 3)
    eng.run(max_steps=200)
    out["paged"] = {"tokens": _tokens(eng), "paged": eng.paged}
    return out


# ------------------------------------------------------------- the JAX side
def jax_engines(payload):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.models import init_params
    from repro.serving import EngineConfig as JEngineConfig
    from repro.serving import ServingEngine as JServingEngine
    from repro.sharding.policy import ShardingPolicy as JaxPolicy

    assert jax.device_count() == 4
    mesh = make_host_mesh(*payload["shape"])
    policy = JaxPolicy(mesh=mesh)
    out = {"trees": {}, "tokens": {}}
    for arch in ARCHS:
        cfg = jax_smoke(arch)
        params, _ = init_params(cfg, jax.random.PRNGKey(1), policy,
                                jnp.float32)
        out["trees"][arch] = jax.tree.map(np.asarray, params)
        eng = JServingEngine(params, cfg, policy,
                             JEngineConfig(**_knobs(arch, "scan")))
        _submit(eng, cfg.vocab_size, ARCHS[arch][1], 3)
        eng.run(max_steps=200)
        out["tokens"][arch] = _tokens(eng)
    cfg = jax_smoke(PAGED)
    params, _ = init_params(cfg, jax.random.PRNGKey(1), policy, jnp.float32)
    eng = JServingEngine(params, cfg, policy,
                         JEngineConfig(**_knobs(PAGED, "scan", "paged")))
    _submit(eng, cfg.vocab_size, ARCHS[PAGED][1], 3)
    eng.run(max_steps=200)
    out["paged_tokens"] = _tokens(eng)
    return out


def run_both(shape, tmp):
    jax_out = run_jax(f"{__name__}:jax_engines", {"shape": shape}, tmp)
    port = ranks(rank_engines, *shape, tmp, jax_out["trees"])
    return port, jax_out


def check_tokens(port, jax_out, arch, mode):
    want = jax_out["tokens"][arch]
    assert len(want) == len(PROMPTS)
    assert all(len(t) == ARCHS[arch][1] for t in want.values())
    for res in port:
        assert res[(arch, mode)]["tokens"] == want


def check_paged(port, jax_out):
    """``kv_mode="paged"`` under the mesh: the whole pool on every rank,
    the projections sharded; JAX's paged mesh engine's tokens."""
    assert jax_out["paged_tokens"]
    for res in port:
        assert res["paged"]["paged"]
        assert res["paged"]["tokens"] == jax_out["paged_tokens"]


def check_cache(port, arch, shape):
    """The rank's rows of the batch and its block of the positions."""
    cfg = get_smoke_config(arch)
    max_len = ARCHS[arch][0]
    S = min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len
    data, model = shape
    for res in port:
        for mode in ("scan", "python"):
            got = res[(arch, mode)]
            assert not got["paged"]
            assert got["cache"] == (cfg.num_layers, 4 // data, S // model,
                                    cfg.num_kv_heads, cfg.head_dim)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(SHAPE, tmp_path_factory.mktemp("mesh_layout_engine"))


@pytest.mark.parametrize("mode", ["scan", "python"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_tokens_match_jax_mesh_engine(results, arch, mode):
    check_tokens(*results, arch, mode)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_holds_the_ranks_block_of_the_cache(results, arch):
    check_cache(results[0], arch, SHAPE)


def test_paged_engine_matches_jax_mesh_engine(results):
    check_paged(*results)
