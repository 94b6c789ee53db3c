"""Every model family of the port against the JAX package's, at smoke size
with fp32 weights from the JAX ``init_params`` (through
``params_from_numpy``): the gated MLP (SwiGLU and GeGLU), the SSD block
(chunked prefill at a ragged length, then step-by-step decode with the
cache), the vision frontend's patch embedding, and each smoke config's
prefill followed by greedy decode steps on the dense cache.

MoE configs run under a non-identity placement. zamba2 (the hybrid family)
is held against JAX ``decode_mode="python"`` only: the reference's own
``"scan"`` and ``"python"`` disagree on it
(``tests/test_scan_decode.py::test_decode_mode_parity_all_families
[zamba2-1.2b]``), and the port's step is the unrolled one.

Tolerances (fp32 on both sides, different summation orders): logits and
caches within rtol = atol = 1e-4; greedy tokens and expert counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_bridge import placement, smoke_configs  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_decode_cache as jax_init_decode_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.layers import gated_mlp as jax_gated_mlp  # noqa: E402
from repro.models.model import _embed_input as jax_embed_input  # noqa: E402
from repro.models.moe import apply_placement as jax_apply_placement  # noqa: E402
from repro.models.ssm import SSMCache  # noqa: E402
from repro.models.ssm import ssm_decode as jax_ssm_decode  # noqa: E402
from repro.models.ssm import ssm_train as jax_ssm_train  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import decode_step, init_decode_cache, init_params, prefill  # noqa: E402
from repro_torch.models.layers import gated_mlp  # noqa: E402
from repro_torch.models.model import _embed_input  # noqa: E402
from repro_torch.models.ssm import ssm_cache_zeros, ssm_decode, ssm_train  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
NEW_ARCHS = ["qwen1.5-4b", "qwen2.5-14b", "qwen3-32b", "gemma-7b",
             "mamba2-1.3b", "zamba2-1.2b", "musicgen-medium", "internvl2-76b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _both_params(jcfg, tcfg, seed=0):
    """JAX fp32 params (MoE: under a non-identity placement), the port's
    copy, and the (L, E_v) expert→slot tables (None without MoE)."""
    params, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed), host_policy(),
                                jnp.float32)
    e2s = None
    if jcfg.is_moe:
        s2e, e2s = placement(jcfg.num_layers,
                             jcfg.num_experts * jcfg.expert_tp, seed=seed + 3)
        blocks = dict(params["blocks"])
        blocks["moe"] = jax_apply_placement(blocks["moe"], jnp.asarray(s2e))
        params = {**params, "blocks": blocks}
    return params, params_from_numpy(_np(params), tcfg, "cpu"), e2s


def test_registry_holds_every_jax_config():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name, ref in JAX_ARCHS.items():
        ours = get_config(name)
        for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                      "d_ff", "vocab_size", "head_dim", "sliding_window",
                      "mlp_activation", "ssm_state", "attn_every", "frontend",
                      "num_patches", "tie_embeddings", "qkv_bias", "qk_norm"):
            assert getattr(ours, field) == getattr(ref, field), (name, field)
        for prop in ("d_inner", "ssm_heads", "is_ssm", "is_hybrid",
                     "padded_vocab", "sub_quadratic"):
            assert getattr(ours, prop) == getattr(ref, prop), (name, prop)
        assert ours.param_count() == ref.param_count(), name


@pytest.mark.parametrize("module", [
    "gemma_7b", "internvl2_76b", "mamba2_1_3b", "musicgen_medium",
    "qwen1_5_4b", "qwen2_5_14b", "qwen3_32b", "zamba2_1_2b"])
def test_config_file_is_a_verbatim_copy(module):
    """The eight configs without TPU-only fields are copied byte for
    byte (granite's and mixtral's drop their Pallas tile sizes)."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "src"
    ours = (root / "repro_torch" / "configs" / f"{module}.py").read_bytes()
    assert ours == (root / "repro" / "configs" / f"{module}.py").read_bytes()


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_gated_mlp_matches_jax(activation):
    rng = np.random.default_rng(1)
    D, F = 48, 80
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    p = {"w_gate": rng.standard_normal((D, F)).astype(np.float32) / 7,
         "w_up": rng.standard_normal((D, F)).astype(np.float32) / 7,
         "w_down": rng.standard_normal((F, D)).astype(np.float32) / 9}
    want = jax_gated_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                         activation=activation, policy=host_policy())
    got = gated_mlp(torch.from_numpy(x),
                    {k: torch.from_numpy(v) for k, v in p.items()},
                    activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        gated_mlp(torch.from_numpy(x),
                  {k: torch.from_numpy(v) for k, v in p.items()},
                  activation="relu")


def _ssm_layer(arch):
    jcfg, tcfg = smoke_configs(arch)
    jparams, tparams, _ = _both_params(jcfg, tcfg, seed=4)
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"]["ssm"])
    tp = {k: v[0] for k, v in tparams["blocks"]["ssm"].items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("S", [45, 64], ids=["ragged", "whole-chunks"])
def test_ssm_train_then_decode_matches_jax(S):
    """S = 45 with chunk 32: the chunk size drops to 15 (three chunks), as
    in the JAX version; then six decode steps from the prefill's cache."""
    jcfg, tcfg, jp, tp = _ssm_layer("mamba2-1.3b")
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jy, jc = jax_ssm_train(jnp.asarray(x), jp, jcfg, host_policy(),
                           return_cache=True)
    ty, tc = ssm_train(torch.from_numpy(x), tp, tcfg, return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name, want in zip(("state", "conv_x", "conv_b", "conv_c"), jc.tree()):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(want), **TOL,
                                   err_msg=name)
    cache = ssm_cache_zeros(tcfg, 2, (), dtype=torch.float32, device="cpu")
    for name in cache:
        cache[name].copy_(torch.from_numpy(np.array(getattr(jc, name))))
    for step in range(6):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jax_ssm_decode(jnp.asarray(xt), jp, jc, jcfg, host_policy())
        ty = ssm_decode(torch.from_numpy(xt), tp, cache, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL,
                                   err_msg=f"step {step}")
        for name in cache:
            np.testing.assert_allclose(
                cache[name].numpy(), np.asarray(getattr(jc, name)), **TOL,
                err_msg=f"step {step} {name}")


def test_ssm_cache_zeros_matches_jax_shapes():
    jcfg, tcfg = smoke_configs("zamba2-1.2b")
    want = SSMCache.zeros(3, jcfg, jnp.float32, extra_leading=(2, 5))
    got = ssm_cache_zeros(tcfg, 3, (2, 5), dtype=torch.float32, device="cpu")
    for name, w in zip(("state", "conv_x", "conv_b", "conv_c"), want.tree()):
        assert tuple(got[name].shape) == w.shape, name
    assert got["state"].dtype == torch.float32


def test_embed_input_prepends_vision_patches():
    jcfg, tcfg = smoke_configs("internvl2-76b")
    jparams, tparams, _ = _both_params(jcfg, tcfg)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 6)).astype(np.int32)
    patches = rng.standard_normal((2, jcfg.num_patches, jcfg.d_model))
    patches = patches.astype(np.float32)
    want = jax_embed_input(jparams, {"tokens": jnp.asarray(tokens),
                                     "patches": jnp.asarray(patches)},
                           jcfg, host_policy())
    got = _embed_input(tparams, torch.from_numpy(tokens), tcfg,
                       torch.from_numpy(patches))
    assert tuple(got.shape) == (2, jcfg.num_patches + 6, jcfg.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a config without the vision frontend ignores patches, as JAX does
    jcfg2, tcfg2 = smoke_configs("qwen1.5-4b")
    _, tparams2, _ = _both_params(jcfg2, tcfg2)
    got2 = _embed_input(tparams2, torch.from_numpy(tokens), tcfg2,
                        torch.from_numpy(patches))
    assert tuple(got2.shape) == (2, 6, jcfg2.d_model)


MAX_LEN = 24
PROMPT = 8
STEPS = 6


def _install(jcaches, new):
    """The JAX engine's ``_write_slot`` for a whole batch: the prefill's
    K/V padded to the panel length, the SSM parts as they are."""
    out = {}
    for key, tree in jcaches.items():
        out[key] = {}
        for part, pool in tree.items():
            got = np.asarray(new[key][part])
            if key == "attn":
                pad = pool.shape[-3] - got.shape[-3]
                got = np.pad(got, [(0, 0)] * (got.ndim - 3)
                             + [(0, pad), (0, 0), (0, 0)])
            assert got.shape == pool.shape, (key, part)
            out[key][part] = got
    return out


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_prefill_then_dense_decode_matches_jax(arch):
    jcfg, tcfg = smoke_configs(arch)
    jparams, tparams, e2s = _both_params(jcfg, tcfg, seed=2)
    policy = host_policy()
    rng = np.random.default_rng(13)
    B = 2
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, PROMPT)).astype(np.int32)
    batch, patches = {"tokens": jnp.asarray(tokens)}, None
    if jcfg.frontend == "vision":
        patches = rng.standard_normal((B, jcfg.num_patches, jcfg.d_model))
        patches = patches.astype(np.float32)
        batch["patches"] = jnp.asarray(patches)
    jtab = None if e2s is None else jnp.asarray(e2s)
    ttab = None if e2s is None else torch.from_numpy(e2s)
    jl, jc = jax_prefill(jparams, batch, jcfg, policy, jtab,
                         stack_mode="python")
    tl, tc = prefill(tparams, torch.from_numpy(tokens), tcfg, ttab,
                     patches=None if patches is None
                     else torch.from_numpy(patches))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc.keys() == {k for k, v in jc.items()}
    for key, tree in jc.items():
        if tree is None:
            assert tc[key] is None
            continue
        for part, want in tree.items():
            np.testing.assert_allclose(tc[key][part].numpy(),
                                       np.asarray(want), **TOL,
                                       err_msg=f"{key}.{part}")

    jcaches = _np(jax_init_decode_cache(jcfg, B, MAX_LEN, policy,
                                        dtype=jnp.float32))
    filled = _install(jcaches, jc)
    tcaches = init_decode_cache(tcfg, B, MAX_LEN, device="cpu",
                                dtype=torch.float32)
    assert tcaches.keys() == filled.keys()
    for key, tree in filled.items():
        assert tcaches[key].keys() == tree.keys()
        for part, arr in tree.items():
            tcaches[key][part].copy_(torch.tensor(arr))
    jcaches = jax.tree.map(jnp.asarray, filled)

    cur = tokens.shape[1] + (jcfg.num_patches if patches is not None else 0)
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    assert np.array_equal(tl.numpy().argmax(-1), nxt)
    for step in range(STEPS):
        jl, jcaches, jaux = jax_decode_step(
            jparams, jcaches, jnp.asarray(cur, jnp.int32),
            jnp.asarray(nxt[:, None]), jcfg, policy, jtab,
            decode_mode="python")
        tl, tcaches, taux = decode_step(
            tparams, tcaches, torch.tensor(cur, dtype=torch.int32),
            torch.from_numpy(nxt[:, None]), tcfg, ttab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        want = np.asarray(jl).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), want)
        if jcfg.is_moe:
            np.testing.assert_array_equal(taux.expert_counts.numpy(),
                                          np.asarray(jaux.expert_counts))
        else:
            assert taux is None and jaux is None
        nxt, cur = want, cur + 1
    for key, tree in _np(jcaches).items():
        for part, want in tree.items():
            np.testing.assert_allclose(tcaches[key][part].numpy(), want,
                                       **TOL, err_msg=f"{key}.{part}")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_every_family_inits_and_steps_on_its_own(arch):
    """The port's own seeded init, at smoke size in bf16: prefill and two
    dense decode steps give finite logits of the padded vocab."""
    _, tcfg = smoke_configs(arch)
    params = init_params(tcfg, seed=3, device="cpu", dtype=torch.bfloat16)
    tokens = torch.arange(6, dtype=torch.int32)[None] % tcfg.vocab_size
    patches = None
    if tcfg.frontend == "vision":
        patches = torch.zeros((1, tcfg.num_patches, tcfg.d_model),
                              dtype=torch.bfloat16)
    logits, _ = prefill(params, tokens, tcfg, patches=patches)
    caches = init_decode_cache(tcfg, 1, 32, device="cpu",
                               dtype=torch.bfloat16)
    tok = logits.argmax(-1).int()[:, None]
    for cur in (6, 7):
        logits, caches, aux = decode_step(
            params, caches, torch.tensor(cur, dtype=torch.int32), tok, tcfg)
        assert logits.shape == (1, tcfg.padded_vocab)
        assert bool(torch.isfinite(logits[:, :tcfg.vocab_size]).all())
        assert aux is None
        tok = logits.argmax(-1).int()[:, None]


# the granite smoke weights of the parent commit (seed 0, CPU), sha256 over
# each leaf's name and bytes in sorted order
GRANITE_SMOKE_SHA256 = {
    "float32": "bf9d8916cecb16f2f5a998ffdae6a2fa550e235f915bac54276a507ab53c4e60",
    "bfloat16": "d0720b30e14991583bcce4edd49ff18be6b2d0054d5e9a75f8bf4adb0cd7344b",
}


def _sha256(params):
    import hashlib

    def leaves(t, prefix=""):
        for k in sorted(t):
            if isinstance(t[k], dict):
                yield from leaves(t[k], f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", t[k]

    h = hashlib.sha256()
    for name, w in leaves(params):
        h.update(name.encode())
        h.update(w.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("dtype", sorted(GRANITE_SMOKE_SHA256))
@pytest.mark.parametrize("whole_draw_bytes", [None, 0],
                         ids=["whole", "one-layer-at-a-time"])
def test_granite_weights_keep_their_bits(monkeypatch, dtype, whole_draw_bytes):
    """Drawing a stack one layer at a time (as Mixtral-width weights are)
    gives granite smoke the bits it had when every weight was drawn whole
    in fp32 and cast: on the CPU a layer holds a multiple of 16 values."""
    from repro_torch.models import layers

    if whole_draw_bytes is not None:
        monkeypatch.setattr(layers, "WHOLE_DRAW_BYTES", whole_draw_bytes)
    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = init_params(cfg, seed=0, device="cpu",
                         dtype=getattr(torch, dtype))
    assert _sha256(params) == GRANITE_SMOKE_SHA256[dtype]


def test_gem_planes_refuse_a_config_without_moe():
    """online, replication, shed and auto_slots need a MoE config: the
    port refuses a dense one with the JAX engine's messages."""
    import repro.core as jcore
    import repro.replication as jrep
    import repro.serving as jserving
    import repro_torch.core as tcore
    import repro_torch.replication as trep
    import repro_torch.serving as tserving

    jcfg, tcfg = smoke_configs("qwen3-32b")
    jparams, tparams, _ = _both_params(jcfg, tcfg)
    cases = {
        "online": lambda s, r: dict(online=True),
        "replication": lambda s, r: dict(
            replication=r.ReplicationConfig(replica_slots=1)),
        "shed": lambda s, r: dict(shed=s.ShedConfig(enabled=True)),
        "auto_slots": lambda s, r: dict(
            replication=r.ReplicationConfig(auto_slots=True),
            hbm_budget_bytes=1e9),
    }
    for case, knobs in cases.items():
        messages = []
        for core, rep, serving in ((jcore, jrep, jserving),
                                   (tcore, trep, tserving)):
            fleet = core.DeviceFleet.from_speeds(
                np.ones(4), tile=8, tile_time=40e-6)
            profile = core.profile_fleet(core.simulator_measure_fn(fleet), 4,
                                         max_tokens=64, tile=8,
                                         repeats=2).profile
            ecfg = serving.EngineConfig(max_batch=2, max_len=32,
                                        **knobs(serving, rep))
            with pytest.raises(ValueError) as err:
                if serving is jserving:
                    serving.ServingEngine(jparams, jcfg, host_policy(), ecfg,
                                          profile=profile, num_devices=4)
                else:
                    serving.ServingEngine(tparams, tcfg, ecfg, profile=profile,
                                          num_devices=4, device="cpu")
            messages.append(str(err.value))
        assert messages[0] == messages[1], case


def _random_like(tree, gen):
    if isinstance(tree, dict):
        return {k: _random_like(v, gen) for k, v in tree.items()}
    return torch.randn(tree.shape, generator=gen, dtype=tree.dtype)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _tree_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.mark.parametrize("arch,paged", [
    ("mixtral-8x7b", False), ("qwen2.5-14b", False), ("mamba2-1.3b", False),
    ("zamba2-1.2b", False), ("granite-moe-3b-a800m", True),
], ids=["ring", "dense", "ssm", "hybrid", "paged"])
def test_the_idle_step_writes_only_what_binding_restores(arch, paged):
    """``DecodeGraph`` binds by running the step with every input at zero
    and restores only the entries :func:`_idle_writes` names. On random
    caches, that step changes no other entry (on the paged cache it writes
    only the null block, block 0), and it does change something, so the
    check is not vacuous. Bit-exact."""
    from repro_torch.models import init_paged_decode_cache
    from repro_torch.models.model import _idle_writes

    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=2, device="cpu", dtype=torch.float32)
    B = 3
    gen = torch.Generator().manual_seed(5)
    if paged:
        caches = _random_like(init_paged_decode_cache(
            cfg, 9, 4, device="cpu", dtype=torch.float32), gen)
        cur_len = torch.zeros(B, dtype=torch.int32)
        tables = torch.zeros((B, 4), dtype=torch.int32)
    else:
        caches = _random_like(init_decode_cache(
            cfg, B, 40, device="cpu", dtype=torch.float32), gen)
        cur_len, tables = torch.tensor(0, dtype=torch.int32), None
    before = _clone_tree(caches)
    written = _idle_writes(caches, paged=paged)
    saved = [t.clone() for t in written]
    decode_step(params, caches, cur_len, torch.zeros((B, 1), dtype=torch.int32),
                cfg, block_tables=tables)
    changed = [n for (n, t), (_, o) in zip(_tree_leaves(caches),
                                           _tree_leaves(before))
               if not torch.equal(t, o)]
    assert changed
    for t, old in zip(written, saved):
        t.copy_(old)
    for (name, t), (_, old) in zip(_tree_leaves(caches), _tree_leaves(before)):
        if paged:  # the null block is free for the idle step to write
            t, old = t[:, 1:], old[:, 1:]
        assert torch.equal(t, old), name
