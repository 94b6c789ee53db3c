"""The port's optimizer and train step against the JAX package's, on the
CPU: the learning-rate schedule, one AdamW update leaf by leaf (fp32 and
bf16 leaves, moments already warm), int8 gradient compression with its
error-feedback residual, accumulation over 4 microbatches against one
batch, and three train steps of a MoE smoke config under a non-identity
placement.

Tolerances: the schedule within 1e-6 relative (both in float32, numpy's
cos against XLA's); updated fp32 parameters and moments within 1e-6
relative + 1e-7 absolute (one update, different fused orders); bf16
parameters within one bf16 rounding; compressed gradients and residuals
within 1e-6 of the leaf's max (the same rounding of the same values);
train-step losses within 1e-5 relative, grad norms within 1e-4, expert
counts equal. After three steps the parameters and moments are held in
relative Frobenius norm per leaf: within 1e-4, or 5e-3 with int8
compression. Not element by element: Adam divides each coordinate by
its own gradient scale, so a coordinate whose gradient is at rounding level
moves by up to the learning rate either way (one or two of 98,304 in the
expert weights), and a value on a quantization boundary takes the
neighbouring int8 level.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_bridge import placed_params, smoke_configs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro.training import (  # noqa: E402
    DataConfig,
    SyntheticTokenStream,
)
from repro.training import init_train_state as jax_init_train_state  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.training.optimizer import _lr as jax_lr  # noqa: E402
from repro.training.optimizer import adamw_update as jax_adamw_update  # noqa: E402
from repro.training.optimizer import compress_grads as jax_compress_grads  # noqa: E402
from repro_torch.bridge import params_from_numpy, state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    adamw_update,
    compress_grads,
    init_train_state,
    make_train_step,
)
from repro_torch.training.optimizer import _lr  # noqa: E402

torch.set_num_threads(1)

OPT = dict(learning_rate=2e-3, warmup_steps=3, total_steps=12,
           weight_decay=0.1, grad_clip=0.5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        a.dtype.name == "bfloat16" else a


def _tree_arrays(seed):
    """A nested params tree (fp32 leaves and one bf16 leaf), grads and warm
    moments, as numpy."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"a": r(5, 3), "blocks": {"w": r(2, 4, 6), "ln": r(4)},
              "half": r(3, 8)}
    grads = {"a": r(5, 3), "blocks": {"w": r(2, 4, 6, scale=3.0),
                                      "ln": r(4)}, "half": r(3, 8)}
    mu = jax.tree.map(lambda p: r(*p.shape, scale=0.1), params)
    nu = jax.tree.map(lambda p: np.abs(r(*p.shape, scale=0.1)), params)
    return params, grads, mu, nu


def test_lr_schedule_matches_jax():
    for cfg_kw in (OPT, dict(OPT, warmup_steps=0, total_steps=5),
                   dict(OPT, min_lr_ratio=0.0)):
        ours, ref = AdamWConfig(**cfg_kw), JaxAdamWConfig(**cfg_kw)
        for step in range(0, cfg_kw["total_steps"] + 4):
            want = float(jax_lr(ref, jnp.asarray(step, jnp.int32)))
            assert _lr(ours, step) == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("step", [0, 2, 7])
def test_one_adamw_update_matches_jax(step):
    params, grads, mu, nu = _tree_arrays(seed=step)
    jparams = dict(params, half=jnp.asarray(params["half"], jnp.bfloat16))
    jstate = {"mu": mu, "nu": nu, "step": jnp.asarray(step, jnp.int32)}
    jp, js, jm = jax_adamw_update(
        jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, jstate), JaxAdamWConfig(**OPT))
    tparams = state_from_numpy(_np(jparams), "cpu")
    assert tparams["half"].dtype == torch.bfloat16
    tstate = state_from_numpy({"opt": jax.tree.map(np.asarray, jstate)},
                              "cpu")["opt"]
    assert tstate["step"].device.type == "cpu"
    tgrads = state_from_numpy(grads, "cpu")
    _, ts, tm = adamw_update(tparams, tgrads, tstate, AdamWConfig(**OPT))
    assert int(ts["step"]) == step + 1 == int(js["step"])
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    got, want = state_to_numpy(tparams), _np(jp)
    for name in ("a", "blocks", "half"):
        for g, w in zip(jax.tree.leaves(got[name]), jax.tree.leaves(want[name])):
            if name == "half":  # bf16: no decay (kind "V"), one rounding
                np.testing.assert_allclose(g, _f32(w), rtol=2 ** -7, atol=0)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    for moment in ("mu", "nu"):
        for g, w in zip(jax.tree.leaves(state_to_numpy(ts[moment])),
                        jax.tree.leaves(_np(js[moment]))):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_compress_grads_and_residual_match_jax():
    _, grads, res, _ = _tree_arrays(seed=11)
    jd, jr = jax_compress_grads(jax.tree.map(jnp.asarray, grads),
                                jax.tree.map(jnp.asarray, res), bits=8)
    tres = state_from_numpy(res, "cpu")
    td, tr = compress_grads(state_from_numpy(grads, "cpu"), tres, bits=8)
    assert tr is tres  # the residual is updated in place
    for got, want in ((td, jd), (tr, jr)):
        for g, w in zip(jax.tree.leaves(state_to_numpy(got)),
                        jax.tree.leaves(_np(want))):
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * scale)
    # the dequantized values sit on 255 levels per leaf
    for g in jax.tree.leaves(state_to_numpy(td)):
        assert len(np.unique(g)) <= 255


def _batch(cfg, n, seq, seed=0):
    data = SyntheticTokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=seq, global_batch=n,
                                           seed=seed))
    return next(data)


def test_accumulation_of_four_matches_one_batch_and_jax():
    """gemma smoke (the JAX test's config): 4 microbatches of 2 against one
    batch of 8, and against JAX's ``lax.scan`` accumulation."""
    jcfg, tcfg = smoke_configs("gemma-7b")
    params, _ = jax_init_params(jcfg, jax.random.PRNGKey(0), host_policy(),
                                jnp.float32)
    opt_kw = dict(learning_rate=1e-3, grad_clip=1e9)
    batch = _batch(jcfg, 8, 16)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    states, metrics = [], []
    for accum in (1, 4):
        tstate = init_train_state(params_from_numpy(_np(params), tcfg, "cpu"),
                                  AdamWConfig(**opt_kw))
        step = make_train_step(tcfg, AdamWConfig(**opt_kw), accum_steps=accum,
                               remat=False)
        tstate, m = step(tstate, tb)
        states.append(state_to_numpy(tstate))
        metrics.append(m)
    assert float(metrics[0]["loss"]) == pytest.approx(
        float(metrics[1]["loss"]), rel=1e-5)
    for a, b in zip(jax.tree.leaves(states[0]["params"]),
                    jax.tree.leaves(states[1]["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    jstep = jax.jit(jax_make_train_step(jcfg, host_policy(),
                                        JaxAdamWConfig(**opt_kw),
                                        accum_steps=4, remat=False))
    js, jm = jstep(jax_init_train_state(params, JaxAdamWConfig(**opt_kw)),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(metrics[1]["loss"]) == pytest.approx(float(jm["loss"]),
                                                      rel=1e-5)
    assert float(metrics[1]["grad_norm"]) == pytest.approx(
        float(jm["grad_norm"]), rel=1e-4)
    for a, b in zip(jax.tree.leaves(states[1]["params"]),
                    jax.tree.leaves(_np(js["params"]))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
def test_three_train_steps_track_jax(compress):
    """granite smoke under a non-identity placement, capacity factor 2.0
    (the launchers'), three steps of 2 × 16 tokens: losses, grad norms,
    expert counts, dropped shares and the parameters after the third step
    against JAX's jitted ``make_train_step`` (Pallas in interpret mode)."""
    jcfg, tcfg = smoke_configs(capacity_factor=2.0)
    jcfg = dataclasses.replace(jcfg, moe_backend="pallas")
    jparams, tparams, e2s = placed_params(jcfg, tcfg, seed=1)
    opt_kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3,
                  compress=compress)
    jstep = jax.jit(jax_make_train_step(jcfg, host_policy(),
                                        JaxAdamWConfig(**opt_kw), remat=True))
    tstep = make_train_step(tcfg, AdamWConfig(**opt_kw), remat=True)
    js = jax_init_train_state(jparams, JaxAdamWConfig(**opt_kw))
    ts = init_train_state(tparams, AdamWConfig(**opt_kw))
    assert ("ef_residual" in ts) == compress
    data = SyntheticTokenStream(DataConfig(vocab_size=jcfg.vocab_size,
                                           seq_len=16, global_batch=2))
    losses = []
    for _, batch in zip(range(3), data):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.asarray(e2s))
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in batch.items()},
                       torch.from_numpy(e2s))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        np.testing.assert_array_equal(tm["expert_counts"].numpy(),
                                      np.asarray(jm["expert_counts"]))
        assert float(tm["moe_dropped"]) == pytest.approx(
            float(jm["moe_dropped"]), rel=1e-6, abs=1e-9)
        losses.append(float(tm["loss"]))
    assert int(ts["opt"]["step"]) == 3
    got, want = state_to_numpy(ts), _np(js)
    assert sorted(got) == sorted(want)
    tol = 5e-3 if compress else 1e-4
    # the residual is held in test_compress_grads_and_residual_match_jax:
    # over steps, an element of a leaf's max on a rounding boundary moves
    # the leaf's scale, and with it every level of that leaf
    got.pop("ef_residual", None)
    want.pop("ef_residual", None)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.isfinite(g).all()
        err = np.linalg.norm(g - w) / max(float(np.linalg.norm(w)), 1e-30)
        assert err <= tol
    assert np.isfinite(losses).all()
