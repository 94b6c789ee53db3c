"""The port's training path against the JAX package's, on the CPU.

* The kernels' ``torch.autograd.Function``s (:mod:`repro_torch.kernels.
  autograd`) against ``jax.grad`` through the ``custom_vjp``s of
  ``repro/kernels/sharded.py`` (``mesh=None``, Pallas in interpret mode):
  the grouped FFN's four input gradients, and the router's logits gradient
  under cotangents on the gates and on ``probs_sum`` (the aux loss's path),
  with tied rows.
* ``loss_fn`` — loss, ``expert_counts`` and every gradient leaf — for the
  MoE smoke configs (the other eight in ``test_torch_train_families.py``)
  against the JAX ``loss_fn`` on the same weights
  (the JAX ``init_params``, through the bridge) and batch, MoE configs
  under a non-identity placement and JAX's ``moe_backend="pallas"``, with
  recomputation (``remat``) on and off on both sides. zamba2 is held
  against JAX ``stack_mode="python"``: the reference's own ``"scan"`` and
  ``"python"`` disagree on the hybrid family (ROADMAP C1), and the port's
  stack is the unrolled one.

Tolerances (fp32 on both sides, different summation orders): the loss
within 1e-5 relative; each gradient leaf within 1e-4 of that leaf's max
|g|; integer counts equal. In bfloat16 (the FFN alone) each gradient
within 2e-2 of its max |g|: both sides round the same fp32 math to bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_bridge import placement, smoke_configs  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.kernels.sharded import moe_ffn_sharded, topk_router_sharded  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.model import loss_fn as jax_loss_fn  # noqa: E402
from repro.models.moe import apply_placement as jax_apply_placement  # noqa: E402
from repro.models.ssm import ssm_train as jax_ssm_train  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.autograd import MoEFFN, TopKRouter  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models.ssm import ssm_train  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
# The reference's SSD backward (``repro/models/ssm.py``'s
# ``jnp.where(tri, jnp.exp(seg), 0.0)``) is NaN once a chunk's summed decay
# above the diagonal passes e^88: exp overflows where the mask drops it and
# its gradient is 0 · inf. At the smoke configs' 16-token chunks that
# happens for every seed; at 4-token chunks it does not, so the SSD
# families are compared at ssm_chunk = 4 on both sides (four chunks: the
# carried state's path is exercised too), and the port's finite gradient
# where the reference overflows is held against a sequential recurrence.
SSD_ARCHS = ("mamba2-1.3b", "zamba2-1.2b")
SSD_CHUNK = 4
GRAD_TOL = 1e-4  # of each leaf's max |g|


def assert_grad_close(got, want, tol=GRAD_TOL, name=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    assert np.isfinite(want).all() and np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: max err {err} > {tol} × {scale}"


# ------------------------------------------------------------ the Functions
def _ffn_arrays(S, C, D, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, C, D)).astype(np.float32)
    x[:, -1] = 0.0  # a pad row
    ws = [rng.standard_normal(s).astype(np.float32) * 0.3
          for s in ((S, D, F), (S, D, F), (S, F, D))]
    cot = rng.standard_normal((S, C, D)).astype(np.float32)
    return [x, *ws], cot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 5, 16, 24), (3, 9, 32, 8)],
                         ids=["ragged", "narrow-F"])
def test_moe_ffn_backward_matches_jax_custom_vjp(shape, dtype):
    args, cot = _ffn_arrays(*shape, seed=sum(shape))
    jdt = getattr(jnp, dtype)

    def jax_obj(x, wg, wu, wd):
        y = moe_ffn_sharded(x[None], wg, wu, wd, mesh=None, data_spec=None,
                            expert_spec=None, interpret=True)[0]
        return jnp.sum(y.astype(jnp.float32) * cot)

    want = jax.grad(jax_obj, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a).astype(jdt) for a in args))
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
          for a in args]
    y = MoEFFN.apply(*ts)
    got = torch.autograd.grad(y, ts, grad_outputs=torch.from_numpy(cot).to(y.dtype))
    tol = GRAD_TOL if dtype == "float32" else 2e-2
    for name, g, w, t in zip(("dx", "dWg", "dWu", "dWd"), got, want, ts):
        assert g.dtype == t.dtype, name
        assert_grad_close(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                          tol, name)


def test_moe_ffn_op_takes_the_function_only_under_autograd():
    args, _ = _ffn_arrays(2, 3, 8, 8, seed=0)
    ts = [torch.from_numpy(a) for a in args]
    plain = ops.moe_ffn(*ts)
    assert plain.grad_fn is None
    ts[1].requires_grad_(True)
    y = ops.moe_ffn(*ts)
    assert type(y.grad_fn).__name__ == "MoEFFNBackward"
    assert torch.equal(y.detach(), plain)
    with torch.no_grad():
        assert ops.moe_ffn(*ts).grad_fn is None


def _router_logits(T, E, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((T, E)) * 2).astype(np.float32)
    logits[0] = 0.0  # every expert tied: the lowest ids win
    logits[1, : E // 2] = logits[1, 0]  # half the row tied
    return logits, rng


@pytest.mark.parametrize("T, E, k", [(12, 8, 2), (37, 40, 8), (5, 16, 1)])
def test_topk_router_backward_matches_jax_custom_vjp(T, E, k):
    logits, rng = _router_logits(T, E, seed=T + E)
    cg = rng.standard_normal((T, k)).astype(np.float32)
    cp = rng.standard_normal((E,)).astype(np.float32)

    def jax_obj(lg):
        gates, _, psum, _ = topk_router_sharded(
            lg[None], k, mesh=None, data_spec=None, interpret=True)
        return jnp.sum(gates[0] * cg) + jnp.sum(psum * cp)

    want = jax.grad(jax_obj)(jnp.asarray(logits))
    jg, jids, jps, jcnt = topk_router_sharded(
        jnp.asarray(logits)[None], k, mesh=None, data_spec=None,
        interpret=True)
    lg = torch.from_numpy(logits).requires_grad_(True)
    gates, ids, psum, counts = TopKRouter.apply(lg, k)
    assert not ids.requires_grad and not counts.requires_grad
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids[0]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(gates.detach().numpy(), np.asarray(jg[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(psum.detach().numpy(), np.asarray(jps),
                               rtol=1e-6, atol=1e-6)
    (got,) = torch.autograd.grad(
        (gates, psum), lg, grad_outputs=(torch.from_numpy(cg),
                                         torch.from_numpy(cp)))
    assert_grad_close(got.numpy(), np.asarray(want), name="dlogits")
    # the gates' cotangent alone (probs_sum unused) and probs_sum's alone
    (g_only,) = torch.autograd.grad(
        TopKRouter.apply(lg, k)[0], lg, grad_outputs=torch.from_numpy(cg))
    want_g = jax.grad(lambda t: jnp.sum(topk_router_sharded(
        t[None], k, mesh=None, data_spec=None, interpret=True)[0][0] * cg))(
            jnp.asarray(logits))
    if k == 1:  # one gate renormed to 1: its gradient is zero up to rounding
        assert float(np.abs(g_only.numpy()).max()) < 1e-6
        assert float(np.abs(np.asarray(want_g)).max()) < 1e-6
    else:
        assert_grad_close(g_only.numpy(), np.asarray(want_g), name="gates only")
    (p_only,) = torch.autograd.grad(
        TopKRouter.apply(lg, k)[2], lg, grad_outputs=torch.from_numpy(cp))
    want_p = jax.grad(lambda t: jnp.sum(topk_router_sharded(
        t[None], k, mesh=None, data_spec=None, interpret=True)[2] * cp))(
            jnp.asarray(logits))
    assert_grad_close(p_only.numpy(), np.asarray(want_p), name="probs_sum only")


def test_router_without_stats_has_no_backward():
    logits, _ = _router_logits(4, 8, seed=0)
    lg = torch.from_numpy(logits).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="with_stats"):
        ops.topk_router(lg, 2)
    gates, ids = ops.topk_router(lg.detach(), 2)  # serving's path
    assert gates.grad_fn is None


# ---------------------------------------------------------------- loss_fn
B, S = 2, 16


def _batch(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    P = jcfg.num_patches if jcfg.frontend == "vision" else 0
    batch = {
        "tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
        "labels": rng.integers(0, jcfg.vocab_size, (B, P + S)).astype(np.int32),
    }
    if P:
        batch["patches"] = rng.standard_normal(
            (B, P, jcfg.d_model)).astype(np.float32)
        mask = np.ones((B, P + S), np.float32)
        mask[:, :P] = 0.0  # no loss on the patch positions
        batch["loss_mask"] = mask
    return batch


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


_JAX_CACHE = {}


def _jax_reference(arch, remat, backend="pallas"):
    """(JAX config, port config, JAX fp32 params under a non-identity
    placement for MoE, e2s tables or None, batch, JAX (loss, aux, grads)).
    A MoE config runs ``backend`` on both sides (``"pallas"``: JAX's
    kernels against the port's staged plane; ``"dense_ref"``: the
    oracle on both)."""
    key = (arch, remat, backend)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    # the SSD families at 4-token chunks: see test_ssd_backward_is_finite_
    # where_the_reference_overflows
    jcfg, tcfg = smoke_configs(
        arch, **({"ssm_chunk": SSD_CHUNK} if arch in SSD_ARCHS else {}))
    if jcfg.is_moe:
        jcfg = dataclasses.replace(jcfg, moe_backend=backend)
        tcfg = dataclasses.replace(tcfg, moe_backend=backend)
    params, _ = jax_init_params(jcfg, jax.random.PRNGKey(0), host_policy(),
                                jnp.float32)
    e2s = None
    if jcfg.is_moe:
        s2e, e2s = placement(jcfg.num_layers,
                             jcfg.num_experts * jcfg.expert_tp, seed=5)
        blocks = dict(params["blocks"])
        blocks["moe"] = jax_apply_placement(blocks["moe"], jnp.asarray(s2e))
        params = {**params, "blocks": blocks}
    batch = _batch(jcfg)
    mode = "python" if jcfg.is_hybrid else "scan"

    @jax.jit
    def value_and_grad(p, b, tables):
        return jax.value_and_grad(jax_loss_fn, has_aux=True)(
            p, b, jcfg, host_policy(), tables, remat=remat, stack_mode=mode)

    (loss, aux), grads = value_and_grad(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        None if e2s is None else jnp.asarray(e2s))
    out = (jcfg, tcfg, params, e2s, batch,
           (float(loss), jax.tree.map(np.asarray, aux),
            _flat(jax.tree.map(np.asarray, grads))))
    _JAX_CACHE[key] = out
    return out


def check_loss_and_grads(arch, remat, backend="pallas"):
    """The port's loss, aux and every gradient leaf against JAX's."""
    jcfg, tcfg, jparams, e2s, batch, (jloss, jaux, jgrads) = _jax_reference(
        arch, remat, backend)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    names = sorted(_flat(tparams))
    flat = _flat(tparams)
    for t in flat.values():
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = loss_fn(tparams, tb, tcfg,
                        None if e2s is None else torch.from_numpy(e2s),
                        remat=remat)
    grads = torch.autograd.grad(loss, [flat[n] for n in names])
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    assert sorted(jgrads) == names
    for n, g in zip(names, grads):
        assert_grad_close(g.numpy(), jgrads[n], name=n)
    if tcfg.is_moe:
        np.testing.assert_array_equal(aux["expert_counts"].numpy(),
                                      jaux["expert_counts"])
        assert aux["expert_counts"].shape == (tcfg.num_layers,
                                              tcfg.num_experts)
        assert int(aux["dropped_tokens"]) == int(jaux["dropped_tokens"])
        np.testing.assert_allclose(float(aux["aux_loss"]),
                                   float(jaux["aux_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(aux["dropped"]),
                                   float(jaux["dropped"]), rtol=1e-6)
    else:
        assert aux == {}
    # the pad vocabulary gets no gradient (written in place in the port,
    # jnp.where in the reference)
    head = "embed" if tcfg.tie_embeddings else "lm_head"
    g_head = grads[names.index(head)]
    pad = g_head[tcfg.vocab_size:] if tcfg.tie_embeddings else \
        g_head[:, tcfg.vocab_size:]
    assert pad.numel() == 0 or not bool(pad.any())


MOE_ARCHS = sorted(a for a, c in JAX_ARCHS.items() if c.is_moe)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    check_loss_and_grads(arch, remat)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_jax_under_the_oracle(arch):
    """``moe_backend="dense_ref"`` on both sides: every expert on every
    token, nothing dropped, the same loss, counts and gradients."""
    check_loss_and_grads(arch, True, "dense_ref")
    assert int(_jax_reference(arch, True, "dense_ref")[-1][1][
        "dropped_tokens"]) == 0


def _gate_plan(case):
    """(router with gates requiring grad, plan, k): granite smoke under a
    placement at capacity factor 1.25 (``single``), or mixtral smoke with
    every token on experts 0 and 1, which have a second copy on replica
    slots 16 and 17 (an (E_v, 16) split table, 15/16 of the tokens on the
    first copy), at capacity factor 1.0 with the shed pass on (``shed``)."""
    from repro_torch.models.dispatch import build_dispatch, route

    arch = "granite-moe-3b-a800m" if case == "single" else "mixtral-8x7b"
    _, tcfg = smoke_configs(arch)
    rng = np.random.default_rng(2)
    Ng, E, k = 64, tcfg.num_experts, tcfg.experts_per_token
    Ev = tcfg.num_virtual_experts
    xg = torch.from_numpy(rng.standard_normal((1, Ng, tcfg.d_model)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((tcfg.d_model, E)).astype(
        np.float32))
    router = route(xg, w, tcfg)
    gates = router.gates.detach().requires_grad_(True)
    if case == "single":
        router = dataclasses.replace(router, gates=gates)
        _, e2s = placement(1, Ev, seed=9)
        plan = build_dispatch(router, torch.from_numpy(e2s[0]), tcfg,
                              capacity_factor=1.25)
    else:
        hot = torch.tensor([0, 1], dtype=router.ids.dtype)[:k]
        router = dataclasses.replace(
            router, gates=gates, ids=hot.expand(1, Ng, k).contiguous())
        table = np.tile(np.arange(Ev, dtype=np.int32)[:, None], (1, 16))
        table[0] = [0] * 15 + [Ev]
        table[1] = [1] * 15 + [Ev + 1]
        plan = build_dispatch(router, torch.from_numpy(table), tcfg,
                              capacity_factor=1.0, num_slots=Ev + 2,
                              shed_enable=torch.ones((), dtype=torch.int32))
        assert int(plan.shed_tokens) > 0
    return gates, plan, tcfg


@pytest.mark.parametrize("case", ["single", "shed"])
def test_dropped_assignments_get_no_gradient(case):
    """The gates reach the plan through the ``dispatch_gate[gidx, slot,
    pos] = a_gates`` index-puts (the capacity pass, and the shed pass's
    re-seating); dropped assignments are written into the sink slot, which
    is sliced off, so their gates take no gradient (JAX's ``mode="drop"``),
    and every other gate takes the cotangent of the row it landed on."""
    gates, plan, tcfg = _gate_plan(case)
    assert int(plan.dropped_tokens) > 0
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tuple(plan.dispatch_gate.shape)).astype(np.float32))
    (g,) = torch.autograd.grad((plan.dispatch_gate * cot).sum(), gates)
    S, C = plan.num_slots, plan.capacity
    Ng, k = gates.shape[1:]
    rows = plan.assign_row.reshape(Ng, k, tcfg.expert_tp)
    want = torch.cat([cot.reshape(-1), torch.zeros(1)])[rows].sum(-1)
    dropped = rows == S * C
    assert bool(dropped.any())
    torch.testing.assert_close(g[0], want, rtol=0, atol=0)
    assert not bool(g[0][dropped.all(-1)].any())


def _ssd_sequential(x, p, cfg):
    """The SSD block as its recurrence, token by token, in float64: h_t =
    exp(dt_t·A)·h_{t−1} + dt_t·(x_t ⊗ B_t), y_t = C_t·h_t + D·x_t, then the
    silu(z) gate, the per-head RMS norm and the output projection."""
    F = torch.nn.functional
    d = {k: v.double() for k, v in p.items()}
    x = x.double()
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim

    def conv(t, w, b):
        pad = F.pad(t, (0, 0, w.shape[0] - 1, 0))
        return sum(pad[:, i:i + t.shape[1]] * w[i]
                   for i in range(w.shape[0])) + b

    z = x @ d["wz"]
    xs = F.silu(conv(x @ d["wx"], d["conv_x_w"], d["conv_x_b"]))
    Bp = F.silu(conv(x @ d["wb"], d["conv_b_w"], d["conv_b_b"]))
    Cp = F.silu(conv(x @ d["wc"], d["conv_c_w"], d["conv_c_b"]))
    dt = F.softplus(x @ d["wdt"] + d["dt_bias"])
    A = -torch.exp(d["A_log"])
    Bsz, S = x.shape[:2]
    xh = xs.reshape(Bsz, S, nh, hd)
    h = x.new_zeros((Bsz, nh, hd, cfg.ssm_state))
    ys = []
    for t in range(S):
        h = (torch.exp(dt[:, t] * A)[:, :, None, None] * h
             + (dt[:, t, :, None] * xh[:, t])[..., None] * Bp[:, t, None, None])
        ys.append(torch.einsum("bn,bhpn->bhp", Cp[:, t], h)
                  + d["D"][None, :, None] * xh[:, t])
    y = torch.stack(ys, 1).reshape(Bsz, S, nh * hd) * F.silu(z)
    yh = y.reshape(Bsz, S, nh, hd)
    yh = yh * torch.rsqrt((yh * yh).mean(-1, keepdim=True) + cfg.norm_eps)
    return (yh.reshape(Bsz, S, nh * hd) * (1.0 + d["gate_norm"])) @ d["out_proj"]


def test_ssd_backward_is_finite_where_the_reference_overflows():
    """mamba2 smoke's SSD block over 16 tokens, one 16-token chunk: the
    reference's gradient is NaN (ROADMAP C), the port's is finite and
    equals the float64 recurrence's; the forwards agree."""
    jcfg, tcfg = smoke_configs("mamba2-1.3b")
    params, _ = jax_init_params(jcfg, jax.random.PRNGKey(0), host_policy(),
                                jnp.float32)
    jp = jax.tree.map(lambda t: t[0], params["blocks"]["ssm"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)

    def jax_obj(xx, pp):
        return jnp.sum(jax_ssm_train(xx, pp, jcfg, host_policy())[0] * cot)

    jy = jax_ssm_train(jnp.asarray(x), jp, jcfg, host_policy())[0]
    jgx, jgp = jax.grad(jax_obj, argnums=(0, 1))(jnp.asarray(x), jp)
    assert not np.isfinite(np.asarray(jgx)).all()  # the reference overflows

    tp = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True)
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    names = sorted(tp)
    ty = ssm_train(tx, tp, tcfg)[0]
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-4)
    got = torch.autograd.grad(ty, [tx] + [tp[n] for n in names],
                              grad_outputs=torch.from_numpy(cot))
    ry = _ssd_sequential(tx, tp, tcfg)
    np.testing.assert_allclose(ty.detach().numpy(), ry.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    want = torch.autograd.grad(ry, [tx] + [tp[n] for n in names],
                               grad_outputs=torch.from_numpy(cot).double())
    for n, g, w in zip(["x"] + names, got, want):
        assert_grad_close(g.numpy(), w.numpy(), name=n)
