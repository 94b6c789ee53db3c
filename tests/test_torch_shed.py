"""The port's replica split and capacity-overflow shed pass against the JAX
``build_dispatch``, on the cases of ``tests/test_shed.py`` (mixtral smoke,
experts 0 and 1 forced hot, a 15/16 share skew toward copy 0), and the
MoE layer's output with the pass on.

Both packages get the same routing decision (the port's router, checked
equal to JAX's, on numpy-seeded activations). Every :class:`DispatchPlan`
field must equal JAX's: ``dispatch_idx``, the counts and ``shed_delta``
exactly and ``dispatch_gate`` bit for bit (fp32). The port's own
``assign_row``, which ``combine`` gathers with, must point every kept or
re-seated assignment at the row that holds it, so a shed row cannot read
the zero sink.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_bridge import smoke_configs  # noqa: E402
from test_torch_graph import NoHostSync  # noqa: E402
from repro.models import dispatch as jdispatch  # noqa: E402
from repro.models.moe import moe_layer as jax_moe_layer  # noqa: E402
from repro.replication import ReplicatedPlacement as JaxReplicatedPlacement  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.models import dispatch as tdispatch  # noqa: E402
from repro_torch.models.moe import apply_placement, moe_layer  # noqa: E402

torch.set_num_threads(1)

ARCH = "mixtral-8x7b"
FIELDS = ("dispatch_idx", "dispatch_gate", "dropped", "dropped_tokens",
          "overflow_tokens", "shed_tokens", "shed_delta")


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = smoke_configs(ARCH)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 16, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((jcfg.d_model, jcfg.num_experts)).astype(np.float32)
    jr = jdispatch.route(jnp.asarray(x), jnp.asarray(w), jcfg, host_policy(),
                         backend="einsum")
    tr = tdispatch.route(torch.from_numpy(x), torch.from_numpy(w), tcfg)
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))
    # one routing decision for both sides: the port's gates, bit for bit
    jr = dataclasses.replace(jr, gates=jnp.asarray(tr.gates.numpy()))
    return jcfg, tcfg, jr, tr


def _skewed_table(Ev):
    """tests/test_shed.py's table: experts 0 and 1 get a second copy on a
    replica slot with a 15/16 share skew toward copy 0."""
    P = 16
    table = np.tile(np.arange(Ev, dtype=np.int32)[:, None], (1, P))
    table[0] = [0] * (P - 1) + [Ev]
    table[1] = [1] * (P - 1) + [Ev + 1]
    return table, Ev + 2


def _routing(jr, tr, ids=None, perm=None):
    """Both routers with ``ids`` forced and tokens permuted by ``perm``."""
    gates = tr.gates.numpy()
    ids = tr.ids.numpy() if ids is None else ids
    if perm is not None:
        gates, ids = gates[:, perm], ids[:, perm]
    jr = dataclasses.replace(jr, ids=jnp.asarray(ids), gates=jnp.asarray(gates))
    tr = dataclasses.replace(tr, ids=torch.from_numpy(np.ascontiguousarray(ids)),
                             gates=torch.from_numpy(np.ascontiguousarray(gates)))
    return jr, tr


def _hot(tr, k):
    """Every token routed to experts (0, 1): expert 0 overflows hard."""
    Gd, Ng, _ = tr.ids.shape
    return np.tile(np.array([[0, 1]], np.int32)[None], (Gd, Ng, 1))[..., :k]


def _random_replicated_table(Ev, G, slots, seed):
    """A replicated layout with copies shuffled over the devices, speed
    shares from a skewed fleet, and its (E_v, 16) split table."""
    rng = np.random.default_rng(seed)
    s2e = np.concatenate([np.arange(Ev), rng.integers(0, 2, size=G * slots)])
    s2e = rng.permutation(s2e).astype(np.int32)
    rp = JaxReplicatedPlacement(s2e, G, Ev)
    shares = np.zeros(len(s2e))
    for e in range(Ev):
        where = np.nonzero(s2e == e)[0]
        w = rng.uniform(0.2, 1.0, size=len(where))
        shares[where] = w / w.sum()
    rp.shares = shares
    return rp.replica_table(16), len(s2e)


def _case(name, jcfg, jr, tr):
    """(JAX router, port router, table, S, capacity factor) of a case."""
    Ev = jcfg.num_experts * jcfg.expert_tp
    k = jcfg.experts_per_token
    hot = _hot(tr, k)
    skewed, S = _skewed_table(Ev)
    if name == "skewed":
        return (*_routing(jr, tr, hot), skewed, S, 1.0)
    if name == "skewed-cf2":  # enough free rows to rescue every overflow
        return (*_routing(jr, tr, hot), skewed, S, 2.0)
    if name == "permuted":
        perm = np.random.default_rng(7).permutation(tr.ids.shape[1])
        return (*_routing(jr, tr, hot, perm), skewed, S, 1.0)
    if name == "budget0-broadcast":
        table = np.tile(np.arange(Ev, dtype=np.int32)[:, None], (1, 16))
        return (*_routing(jr, tr, hot), table, Ev, 1.0)
    if name == "router-random-table":  # the router's own ids, cf 0.5
        table, S = _random_replicated_table(Ev, 4, 2, seed=3)
        return (*_routing(jr, tr), table, S, 0.5)
    raise KeyError(name)


CASES = ["skewed", "skewed-cf2", "permuted", "budget0-broadcast",
         "router-random-table"]
SHED = {"absent": None, "off": 0, "on": 1}


def _assert_rows_hold_assignments(plan, tr, tp):
    """``assign_row`` of each assignment names a row that holds its token
    with its gate, or the sink when it was dropped."""
    Gd, Ng, k = tr.ids.shape
    S, C = plan.num_slots, plan.capacity
    rows = plan.assign_row.numpy()
    idx = plan.dispatch_idx.reshape(Gd, -1).numpy()
    gate = plan.dispatch_gate.reshape(Gd, -1).numpy()
    tok = np.repeat(np.arange(Ng), k * tp)
    a_gate = np.repeat(tr.gates.reshape(Gd, -1).numpy(), tp, axis=1)
    kept = rows < S * C
    assert int(kept.sum()) == Gd * Ng * k * tp - int(plan.dropped_tokens)
    for g in range(Gd):
        r = rows[g, kept[g]]
        assert len(set(r.tolist())) == len(r)  # no two share a row
        np.testing.assert_array_equal(idx[g, r], tok[kept[g]])
        np.testing.assert_array_equal(gate[g, r], a_gate[g, kept[g]])


@pytest.mark.parametrize("shed", sorted(SHED))
@pytest.mark.parametrize("case", CASES)
def test_dispatch_plan_matches_jax(setup, case, shed):
    jcfg, tcfg, jr0, tr0 = setup
    jr, tr, table, S, cf = _case(case, jcfg, jr0, tr0)
    flag = SHED[shed]
    jplan = jdispatch.build_dispatch(
        jr, jnp.asarray(table), jcfg, host_policy(), capacity_factor=cf,
        num_slots=S, shed_enable=None if flag is None else jnp.asarray(flag))
    enable = None if flag is None else torch.full((), flag, dtype=torch.int32)
    ttable = torch.from_numpy(table)
    with NoHostSync():  # nothing reads a value back to the host
        tplan = tdispatch.build_dispatch(
            tr, ttable, tcfg, capacity_factor=cf, num_slots=S,
            shed_enable=enable)
    for name in FIELDS:
        got, want = getattr(tplan, name).numpy(), np.asarray(getattr(jplan, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    _assert_rows_hold_assignments(tplan, tr, tcfg.expert_tp)
    assert int(tplan.dropped_tokens) == (int(tplan.overflow_tokens)
                                         - int(tplan.shed_tokens))
    delta = tplan.shed_delta.numpy()
    assert delta.sum() == 0 and delta[delta > 0].sum() == int(tplan.shed_tokens)
    sheds = int(tplan.shed_tokens)
    if shed != "on" or case == "budget0-broadcast":
        assert sheds == 0
    elif case != "router-random-table":
        assert sheds > 0  # the case exercises the pass
    if shed == "on" and case == "skewed-cf2":
        assert int(tplan.dropped_tokens) == 0 < int(tplan.overflow_tokens)


@pytest.mark.parametrize("case", CASES)
def test_shed_off_is_bit_equal_to_the_pass_absent(setup, case):
    jcfg, tcfg, jr0, tr0 = setup
    _, tr, table, S, cf = _case(case, jcfg, jr0, tr0)
    plans = [tdispatch.build_dispatch(
        tr, torch.from_numpy(table), tcfg, capacity_factor=cf, num_slots=S,
        shed_enable=flag) for flag in (None, torch.zeros((), dtype=torch.int32))]
    for name in FIELDS + ("assign_row",):
        assert torch.equal(getattr(plans[0], name), getattr(plans[1], name)), name


def test_duplicate_columns_count_once():
    """A table row naming one slot in several columns has one live copy:
    the waterfall must not count its free rows twice."""
    _, tcfg = smoke_configs(ARCH)
    Ev = tcfg.num_experts
    table = np.tile(np.arange(Ev, dtype=np.int32)[:, None], (1, 8))
    # 12 assignments of expert 0: 10 on slot 0, 2 on the replica slot Ev,
    # which is named twice
    table[0] = [0, 0, 0, 0, 0, 0, Ev, Ev]
    ids = np.zeros((1, 12, 2), np.int32)
    ids[..., 1] = 1
    gates = np.full((1, 12, 2), 0.5, np.float32)
    zeros = torch.zeros(Ev)
    router = tdispatch.RouterOutput(
        gates=torch.from_numpy(gates), ids=torch.from_numpy(ids),
        expert_counts=zeros.int(), density=zeros, probs_mean=zeros,
        aux_loss=zeros.sum())
    plan = tdispatch.build_dispatch(router, torch.from_numpy(table), tcfg,
                                    capacity_factor=1.0, num_slots=Ev + 1,
                                    shed_enable=torch.ones((), dtype=torch.int32))
    C = plan.capacity
    held = (plan.dispatch_idx[0] < 12).sum(dim=1)
    assert int(held[0]) == int(held[Ev]) == C  # both copies full
    assert int(plan.shed_tokens) == C - 2 > 0  # the replica's free rows, once
    assert int(plan.dropped_tokens) == int(plan.overflow_tokens) - (C - 2)


def _replicated_layer(jcfg, tcfg):
    """Layer 0 of a seeded mixtral smoke layer with a zeroed router (every
    token ties onto experts 0 and 1), its pool expanded by copies of those
    experts, and the skewed split table."""
    rng = np.random.default_rng(5)
    D, Ev = jcfg.d_model, jcfg.num_experts * jcfg.expert_tp
    F = jcfg.expert_d_ff // jcfg.expert_tp
    p = {"router": np.zeros((D, jcfg.num_experts), np.float32),
         "w_gate": rng.standard_normal((Ev, D, F)).astype(np.float32) / 8,
         "w_up": rng.standard_normal((Ev, D, F)).astype(np.float32) / 8,
         "w_down": rng.standard_normal((Ev, F, D)).astype(np.float32) / 11}
    table, S = _skewed_table(Ev)
    s2e = np.concatenate([np.arange(Ev), [0, 1]]).astype(np.int32)
    tp = apply_placement(
        {k: torch.from_numpy(v)[None] for k, v in p.items()},
        torch.from_numpy(s2e)[None])
    tp = {k: v[0].contiguous() for k, v in tp.items()}
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    return jp, tp, table, x


def test_moe_layer_with_shed_matches_jax():
    jcfg, tcfg = smoke_configs(ARCH)
    jp, tp, table, x = _replicated_layer(jcfg, tcfg)
    yj, auxj = jax_moe_layer(jnp.asarray(x), jp, jnp.asarray(table), jcfg,
                             host_policy(), capacity_factor=1.0,
                             backend="einsum", shed_enable=jnp.asarray(1))
    yt, auxt = moe_layer(torch.from_numpy(x), tp, torch.from_numpy(table),
                         tcfg, capacity_factor=1.0,
                         shed_enable=torch.ones((), dtype=torch.int32))
    assert int(auxt.shed_tokens) > 0
    for name in ("expert_counts", "dropped_tokens", "overflow_tokens",
                 "shed_tokens", "shed_delta"):
        np.testing.assert_array_equal(getattr(auxt, name).numpy(),
                                      np.asarray(getattr(auxj, name)), err_msg=name)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)
    # the re-seated rows count: without the pass those tokens lose an expert
    y_absent, aux_absent = moe_layer(torch.from_numpy(x), tp,
                                     torch.from_numpy(table), tcfg,
                                     capacity_factor=1.0)
    assert int(aux_absent.dropped_tokens) > int(auxt.dropped_tokens)
    assert not torch.allclose(y_absent, yt)


def test_moe_layer_shed_off_is_bit_equal_to_absent():
    jcfg, tcfg = smoke_configs(ARCH)
    _, tp, table, x = _replicated_layer(jcfg, tcfg)
    outs = [moe_layer(torch.from_numpy(x), tp, torch.from_numpy(table), tcfg,
                      capacity_factor=1.0, shed_enable=flag)
            for flag in (None, torch.zeros((), dtype=torch.int32))]
    assert torch.equal(outs[0][0], outs[1][0])
    for name in ("dropped_tokens", "overflow_tokens", "shed_tokens", "shed_delta"):
        assert torch.equal(getattr(outs[0][1], name), getattr(outs[1][1], name))
