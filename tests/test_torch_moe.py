"""The port's MoE layer against the JAX one, stage by stage, on granite
smoke under a non-identity placement (fp32, CPU: the plain kernel
versions on the port's side)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_bridge import placed_params, smoke_configs  # noqa: E402
from repro.models import dispatch as jdispatch  # noqa: E402
from repro.models.moe import moe_layer as jax_moe_layer  # noqa: E402
from repro.models.moe import moe_layer_dense_ref as jax_dense_ref  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.models import dispatch as tdispatch  # noqa: E402
from repro_torch.models.moe import moe_layer, moe_layer_dense_ref  # noqa: E402

torch.set_num_threads(1)


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


@pytest.fixture(scope="module", params=[1, 2], ids=["tp1", "tp2"])
def setup(request):
    jcfg, tcfg = smoke_configs(expert_tp=request.param)
    jparams, tparams, e2s = placed_params(jcfg, tcfg, seed=request.param)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    return (jcfg, tcfg, _layer0(jparams["blocks"]["moe"]),
            _layer0(tparams["blocks"]["moe"]), e2s[0], x)


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_dispatch_plan_and_layer_match_jax(setup, cf, backend):
    jcfg, tcfg, jp, tp, e2s, x = setup
    policy = host_policy()
    D = jcfg.d_model
    xg_j = jnp.asarray(x).reshape(1, -1, D)
    xg_t = torch.from_numpy(x).reshape(1, -1, D)
    Ev = jcfg.num_experts * jcfg.expert_tp

    jr = jdispatch.route(xg_j, jp["router"], jcfg, policy, backend=backend)
    tr = tdispatch.route(xg_t, tp["router"], tcfg)
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))
    np.testing.assert_array_equal(
        tr.expert_counts.numpy(), np.asarray(jr.expert_counts)
    )
    np.testing.assert_allclose(tr.gates.numpy(), np.asarray(jr.gates),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tr.aux_loss), float(jr.aux_loss),
                               rtol=1e-5)

    jplan = jdispatch.build_dispatch(
        jr, jnp.asarray(e2s), jcfg, policy, capacity_factor=cf,
        num_slots=Ev,
    )
    tplan = tdispatch.build_dispatch(
        tr, torch.from_numpy(e2s), tcfg, capacity_factor=cf, num_slots=Ev
    )
    for name in ("dispatch_idx", "dropped_tokens", "overflow_tokens",
                 "shed_tokens", "shed_delta"):
        np.testing.assert_array_equal(
            getattr(tplan, name).numpy(), np.asarray(getattr(jplan, name)),
            err_msg=name,
        )
    np.testing.assert_allclose(tplan.dispatch_gate.numpy(),
                               np.asarray(jplan.dispatch_gate), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(tplan.dropped), float(jplan.dropped),
                               rtol=1e-6)
    if cf == 0.5:
        assert int(tplan.dropped_tokens) > 0  # the drop path is exercised

    yj, auxj = jax_moe_layer(jnp.asarray(x), jp, jnp.asarray(e2s), jcfg,
                             policy, capacity_factor=cf, backend=backend)
    yt, auxt = moe_layer(torch.from_numpy(x), tp, torch.from_numpy(e2s),
                         tcfg, capacity_factor=cf)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(auxt["expert_counts"].numpy(),
                                  np.asarray(auxj["expert_counts"]))
    np.testing.assert_array_equal(auxt["dropped_tokens"].numpy(),
                                  np.asarray(auxj["dropped_tokens"]))


def test_dense_mix_matches_dense_ref(setup):
    jcfg, tcfg, jp, tp, e2s, x = setup
    # placed weights + their table reproduce the identity-placement oracle
    s2e = np.argsort(e2s)
    jp_id = dict(jp, **{n: jp[n][np.argsort(s2e)] for n in
                        ("w_gate", "w_up", "w_down")})
    want = np.asarray(jax_dense_ref(jnp.asarray(x), jp_id, jcfg))
    tp_id = {k: (v[torch.from_numpy(np.argsort(s2e))]
                 if k != "router" else v) for k, v in tp.items()}
    got_ref = moe_layer_dense_ref(torch.from_numpy(x), tp_id, tcfg)
    np.testing.assert_allclose(got_ref.numpy(), want, rtol=1e-5, atol=1e-5)
    xg = torch.from_numpy(x).reshape(1, -1, tcfg.d_model)
    router = tdispatch.route(xg, tp["router"], tcfg)
    got = tdispatch.dense_mix(xg, tp, router, torch.from_numpy(e2s), tcfg)
    np.testing.assert_allclose(got.reshape(x.shape).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_rank_in_group_is_stable():
    slots = torch.tensor([3, 1, 3, 0, 1, 3, 3], dtype=torch.int32)
    pos, sizes = tdispatch._rank_in_group(slots, 5)
    assert pos.tolist() == [0, 0, 1, 0, 1, 2, 3]
    assert sizes.tolist() == [1, 2, 0, 4, 0]
    jpos, _ = jdispatch._rank_in_group(jnp.asarray(slots.numpy()), 5)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def test_two_d_replica_table_of_single_copies_gives_the_one_d_plan(setup):
    """A 2-D replica table that broadcasts each expert's one slot over its
    columns gives the 1-D table's plan, and the JAX plan, field for
    field."""
    jcfg, tcfg, jp, tp, e2s, x = setup
    xg = torch.from_numpy(x).reshape(1, -1, tcfg.d_model)
    router = tdispatch.route(xg, tp["router"], tcfg)
    table = np.repeat(e2s[:, None], 2, axis=1)
    plan2 = tdispatch.build_dispatch(router, torch.from_numpy(table), tcfg,
                                     capacity_factor=0.5)
    plan1 = tdispatch.build_dispatch(router, torch.from_numpy(e2s), tcfg,
                                     capacity_factor=0.5)
    jr = jdispatch.route(jnp.asarray(x).reshape(1, -1, jcfg.d_model),
                         jp["router"], jcfg, host_policy(), backend="einsum")
    jplan = jdispatch.build_dispatch(jr, jnp.asarray(table), jcfg,
                                     host_policy(), capacity_factor=0.5)
    assert int(plan2.dropped_tokens) > 0
    for name in ("dispatch_idx", "dispatch_gate", "assign_row",
                 "dropped_tokens", "overflow_tokens", "shed_tokens",
                 "shed_delta"):
        assert torch.equal(getattr(plan2, name), getattr(plan1, name)), name
    for name in ("dispatch_idx", "dropped_tokens", "overflow_tokens"):
        np.testing.assert_array_equal(getattr(plan2, name).numpy(),
                                      np.asarray(getattr(jplan, name)))


@pytest.mark.parametrize("num_tokens", [1, 7, 8, 128])
@pytest.mark.parametrize("cf", [0.0, 0.3, 1.25, 2.0])
@pytest.mark.parametrize("expert_tp", [1, 2])
def test_slot_capacity_matches_jax(num_tokens, cf, expert_tp):
    jcfg, tcfg = smoke_configs(expert_tp=expert_tp)
    Ev = jcfg.num_experts * expert_tp
    for slots, replicated in ((Ev, False), (Ev + 4, True)):
        assert tdispatch.slot_capacity(
            num_tokens, tcfg, capacity_factor=cf, num_slots=slots,
            replicated=replicated,
        ) == jdispatch.slot_capacity(
            num_tokens, jcfg, capacity_factor=cf, num_slots=slots,
            replicated=replicated,
        )
