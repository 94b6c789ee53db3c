"""The port's serving engine for the SSM and hybrid families under JAX's
mesh layout across four ``gloo`` ranks on the CPU, against JAX's engine on
a forced 4-device host mesh of the same shape (in a subprocess), on the
same weights (JAX's ``init_params``, handed over as numpy and sharded by
``params_from_numpy(..., policy=...)``): mamba2's and zamba2's smoke
configs, the port in ``"python"`` and ``"scan"`` (eager on the CPU), the
dense cache (``kv_mode="dense"``, the SSM families' only one). Prompts of
8 and 10 tokens: 8 prefills sequence-parallel on every shape, 10 falls
back to every rank running every row at (1, 4).

Greedy tokens must equal JAX's mesh engine's on every rank and in both
modes (zamba2 against JAX ``decode_mode="python"``: the reference's own
``"scan"`` parts from it, ROADMAP C1); each rank's cache holds its rows
over ``data``, its heads of the SSM state and its channels of
``conv_x``, and (zamba2) its block of the shared block's K/V positions.
This file runs (1, 4); ``test_torch_mesh_ssm_engine_2x2.py`` runs (2, 2)
with these helpers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import ranks, run_jax  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.sharding import ShardingPolicy  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("mamba2-1.3b", "zamba2-1.2b")
MAX_LEN, NEW = 32, 8
PROMPTS = (8, 10, 8, 10)
SHAPE = (1, 4)


def _knobs(mode):
    return dict(max_batch=4, max_len=MAX_LEN, decode_mode=mode,
                placement_policy="linear", other_time_per_step=1e-4,
                kv_mode="dense")


def _submit(eng, vocab_size, seed):
    rng = np.random.default_rng(seed)
    for P in PROMPTS:
        eng.submit(rng.integers(0, vocab_size, size=P), NEW)


def _tokens(eng):
    return {r.uid: list(r.generated) for r in eng.finished}


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


# ------------------------------------------------------------ the port side
def rank_engines(mesh, trees):
    policy = ShardingPolicy(mesh=mesh)
    out = {}
    for arch, tree in trees.items():
        cfg = get_smoke_config(arch)
        for mode in ("scan", "python"):
            params = params_from_numpy(tree, cfg, "cpu", torch.float32,
                                       policy=policy)
            eng = ServingEngine(params, cfg, EngineConfig(**_knobs(mode)),
                                policy=policy)
            _submit(eng, cfg.vocab_size, 3)
            eng.run(max_steps=200)
            out[(arch, mode)] = {"tokens": _tokens(eng),
                                 "cache": _shapes(eng.caches)}
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
        mode = "python" if cfg.is_hybrid else "scan"
        eng = JServingEngine(params, cfg, policy,
                             JEngineConfig(**_knobs(mode)))
        _submit(eng, cfg.vocab_size, 3)
        eng.run(max_steps=200)
        out["tokens"][arch] = _tokens(eng)
    return out


def run_both(shape, tmp):
    jax_out = run_jax(f"{__name__}:jax_engines", {"shape": shape}, tmp)
    port = ranks(rank_engines, *shape, tmp, jax_out["trees"])
    return port, jax_out


def check_tokens(port, jax_out, arch, mode):
    want = jax_out["tokens"][arch]
    assert len(want) == len(PROMPTS)
    assert all(len(t) == NEW for t in want.values())
    for res in port:
        assert res[(arch, mode)]["tokens"] == want


def check_cache(port, arch, shape):
    """The rank's rows of the batch, its heads and channels, and its
    block of the K/V positions."""
    cfg = get_smoke_config(arch)
    data, model = shape
    b, nh, di = 4 // data, cfg.ssm_heads // model, cfg.d_inner // model
    ssm = {"state": (b, nh, cfg.ssm_head_dim, cfg.ssm_state),
           "conv_x": (b, cfg.ssm_conv - 1, di),
           "conv_b": (b, cfg.ssm_conv - 1, cfg.ssm_state),
           "conv_c": (b, cfg.ssm_conv - 1, cfg.ssm_state)}
    if cfg.is_hybrid:
        stages = cfg.num_layers // cfg.attn_every
        kv = (stages, b, MAX_LEN // model, cfg.num_kv_heads, cfg.head_dim)
        want = {"ssm_staged": {k: (stages, cfg.attn_every, *v)
                               for k, v in ssm.items()},
                "attn": {"k": kv, "v": kv}}
    else:
        want = {"ssm": {k: (cfg.num_layers, *v) for k, v in ssm.items()}}
    for res in port:
        for mode in ("scan", "python"):
            assert res[(arch, mode)]["cache"] == want


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(SHAPE, tmp_path_factory.mktemp("mesh_ssm_engine"))


@pytest.mark.parametrize("mode", ["scan", "python"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax_mesh_engine(results, arch, mode):
    check_tokens(*results, arch, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_holds_the_ranks_block_of_the_cache(results, arch):
    check_cache(results[0], arch, SHAPE)
