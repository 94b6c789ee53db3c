"""The port's sharded data plane across ``gloo`` ranks on the CPU against
JAX's mesh path: ``kernels/sharded.py``'s ``topk_router_sharded`` and
``moe_ffn_sharded`` and ``models/moe.py``'s ``moe_layer`` under a policy,
at (1, 4) and (2, 2), under a non-identity placement, with drops, and with
an E_v the model axis does not divide (6 slots on 4 ranks: the dead-slot
pad). It mirrors ``tests/test_moe_mesh_parity.py``: the JAX side runs
``backend="pallas"`` (its kernels in interpret mode under ``shard_map``)
on a forced 4-device host mesh of the same shape, in a subprocess
(:func:`test_torch_mesh.run_jax`).

Integers must be equal (ids, counts, drops, overflow); floats use the
single-card parity tests' tolerance for fp32, ``rtol=1e-5, atol=1e-6``
(``atol=1e-5`` for the layer output, as ``tests/test_torch_moe.py``:
its sums run in another order), and ``probs_sum`` too: JAX sums the
per-shard partials over axis 0 and the port in rank order, the same
order, but each shard's own sum runs in its framework's order. At (1, 4)
the port's layer is bit-equal to its single-process layer: the same
route and dispatch, and K1 per expert does not depend on which other
experts share the call.

The capacity-free oracle (``backend="dense_ref"``) runs on the same
ranks against JAX's ``moe_layer(..., backend="dense_ref")`` on the same
mesh: each rank mixes its share of the slots and the partials are summed
over ``model`` (``models/dispatch.py::dense_mix``), so ``y`` is held to
the layer's tolerance, not to one process's bits; counts are equal and
nothing drops.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import ranks, run_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import sharded as tsharded  # noqa: E402
from repro_torch.models.moe import moe_layer  # noqa: E402
from repro_torch.sharding import ShardingPolicy, local_expert_slots  # noqa: E402

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"
# granite's 80/16 ratio scaled to 20 virtual experts (5 a rank at model 4,
# expert_tp 2 partial sums), and 6 experts that 4 ranks do not divide
CASES = {
    "ev20": dict(num_experts=10, expert_tp=2, experts_per_token=4,
                 expert_d_ff=64),
    "ev6": dict(num_experts=6, experts_per_token=2),
}
SHAPES = [(1, 4), (2, 2)]
CF = 1.0  # capacity that drops assignments
B, T, C = 4, 6, 3


def _cfg(name, get_config=get_smoke_config):
    return dataclasses.replace(get_config(ARCH), **CASES[name])


def _inputs(name, seed):
    cfg = _cfg(name)
    D, E, Ev = cfg.d_model, cfg.num_experts, cfg.num_virtual_experts
    Fv = cfg.expert_d_ff // cfg.expert_tp
    rng = np.random.default_rng(seed)

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    s2e = rng.permutation(Ev).astype(np.int32)  # a non-identity placement
    virt = {"w_gate": normal(Ev, D, Fv, scale=D ** -0.5),
            "w_up": normal(Ev, D, Fv, scale=D ** -0.5),
            "w_down": normal(Ev, Fv, D, scale=cfg.expert_d_ff ** -0.5)}
    p = {k: v[s2e] for k, v in virt.items()}
    p["router"] = normal(D, E, scale=D ** -0.5)
    Gd_max = 2
    return {
        "p": p, "e2s": np.argsort(s2e).astype(np.int32),
        "x": normal(B, T, D, scale=1.0),
        "logits": normal(Gd_max, 5, E, scale=2.0),
        "x_e": normal(Gd_max, Ev, C, D, scale=1.0),
    }


INPUTS = {name: _inputs(name, seed) for seed, name in enumerate(CASES)}


# ------------------------------------------------------------ the port side
def _rank_cases(mesh):
    """Every case on this rank: the sharded router and FFN on the rank's
    groups, and the layer on the whole batch and on the rank's rows."""
    policy = ShardingPolicy(mesh=mesh)
    d = policy.data_axis_size
    out = {}
    for name, inp in INPUTS.items():
        cfg = _cfg(name)
        Ev = cfg.num_virtual_experts
        rows = local_expert_slots(policy, Ev)
        p = {k: torch.from_numpy(v if rows is None or k == "router"
                                 else v[rows]) for k, v in inp["p"].items()}
        e2s = torch.from_numpy(inp["e2s"])
        res = {}
        # router: Gd = d groups, this rank's when they shard
        data_spec, expert_spec = policy.moe_shard_spec(d, Ev)
        logits = torch.from_numpy(inp["logits"][:d])
        g = mesh.index("data") if data_spec is not None else slice(None)
        mine = logits[g:g + 1] if data_spec is not None else logits
        res["router"] = [t.numpy() for t in tsharded.topk_router_sharded(
            mine, cfg.experts_per_token, mesh=mesh, data_spec=data_spec)]
        # FFN: the stored shard, and the whole stack
        pad = None
        if expert_spec is None:
            pad, expert_spec = policy.moe_expert_pad(Ev)
        x_e = torch.from_numpy(inp["x_e"][:d])
        x_e = x_e[g:g + 1] if data_spec is not None else x_e
        whole = [torch.from_numpy(inp["p"][k]) for k in
                 ("w_gate", "w_up", "w_down")]
        res["ffn_whole"] = tsharded.moe_ffn_sharded(
            x_e, *whole, mesh=mesh, data_spec=data_spec,
            expert_spec=expert_spec, pad_expert_to=pad).numpy()
        res["ffn_stored"] = tsharded.moe_ffn_sharded(
            x_e, p["w_gate"], p["w_up"], p["w_down"], mesh=mesh,
            data_spec=data_spec, expert_spec=expert_spec,
            pad_expert_to=pad).numpy()
        # the layer: the whole batch, and this rank's rows
        x = torch.from_numpy(inp["x"])
        y, aux = moe_layer(x, p, e2s, cfg, policy, capacity_factor=CF,
                           num_slots=Ev)
        res["layer"] = (y.numpy(), {f: getattr(aux, f).numpy() for f in
                                    aux.__dataclass_fields__})
        if d > 1:
            rows_d = slice(mesh.index("data") * (B // d),
                           (mesh.index("data") + 1) * (B // d))
            y_l, aux_l = moe_layer(x[rows_d], p, e2s, cfg, policy,
                                   capacity_factor=CF, global_batch=B,
                                   num_slots=Ev)
            res["layer_rows"] = (y_l.numpy(), {f: getattr(aux_l, f).numpy()
                                               for f in aux_l.__dataclass_fields__})
        # the oracle: the whole batch, and this rank's rows
        y, aux = moe_layer(x, p, e2s, cfg, policy, num_slots=Ev,
                           backend="dense_ref")
        res["dense"] = (y.numpy(), {f: getattr(aux, f).numpy() for f in
                                    aux.__dataclass_fields__})
        if d > 1:
            y_l, _ = moe_layer(x[rows_d], p, e2s, cfg, policy, global_batch=B,
                               num_slots=Ev, backend="dense_ref")
            res["dense_rows"] = y_l.numpy()
        out[name] = res
    return out


# ------------------------------------------------------------- the JAX side
def jax_cases(payload):
    """JAX's mesh path on every case and mesh shape (run in a subprocess
    with 4 forced host devices)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.kernels.sharded import moe_ffn_sharded, topk_router_sharded
    from repro.launch.mesh import make_host_mesh
    from repro.models.moe import moe_layer as jax_moe_layer
    from repro.sharding.policy import ShardingPolicy as JaxPolicy

    assert jax.device_count() == 4
    out = {}
    for data, model in payload["shapes"]:
        mesh = make_host_mesh(data, model)
        policy = JaxPolicy(mesh=mesh)
        for name, inp in payload["inputs"].items():
            cfg = _cfg(name, jax_smoke)
            Ev = cfg.num_experts * cfg.expert_tp
            data_spec, expert_spec = policy.moe_shard_spec(data, Ev)
            pad = None
            if expert_spec is None:
                pad, expert_spec = policy.moe_expert_pad(Ev)
            p = {k: jnp.asarray(v) for k, v in inp["p"].items()}
            with mesh:
                router = topk_router_sharded(
                    jnp.asarray(inp["logits"][:data]), cfg.experts_per_token,
                    mesh=mesh, data_spec=data_spec, interpret=True)
                ffn = moe_ffn_sharded(
                    jnp.asarray(inp["x_e"][:data]), p["w_gate"], p["w_up"],
                    p["w_down"], mesh=mesh, data_spec=data_spec,
                    expert_spec=expert_spec, block_c=cfg.pallas_block_c,
                    block_f=cfg.pallas_block_f, interpret=True,
                    pad_expert_to=pad)
                y, aux = jax_moe_layer(
                    jnp.asarray(inp["x"]), p, jnp.asarray(inp["e2s"]), cfg,
                    policy, capacity_factor=CF, backend="pallas")
                yd, auxd = jax_moe_layer(
                    jnp.asarray(inp["x"]), p, jnp.asarray(inp["e2s"]), cfg,
                    policy, backend="dense_ref")
            out[(data, model, name)] = {
                "dense": (np.asarray(yd), {
                    f: np.asarray(getattr(auxd, f)) for f in (
                        "expert_counts", "aux_loss", "dropped",
                        "dropped_tokens", "overflow_tokens", "shed_tokens",
                        "shed_delta")}),
                "router": [np.asarray(t) for t in router],
                "ffn": np.asarray(ffn),
                "layer": (np.asarray(y), {
                    f: np.asarray(getattr(aux, f)) for f in (
                        "expert_counts", "aux_loss", "dropped",
                        "dropped_tokens", "overflow_tokens", "shed_tokens",
                        "shed_delta")}),
            }
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_moe")
    port = {shape: ranks(_rank_cases, *shape, tmp) for shape in SHAPES}
    jax_out = run_jax("test_torch_mesh_moe:jax_cases",
                      {"shapes": SHAPES, "inputs": INPUTS}, tmp)
    return port, jax_out


def _each_rank(results, shape, name):
    port, jax_out = results
    for rank, res in enumerate(port[shape]):
        yield rank, res[name], jax_out[(*shape, name)]


def _group(rank, shape):
    """The dispatch groups a rank holds: its data row's, or all of them."""
    data, model = shape
    return slice(rank // model, rank // model + 1) if data > 1 else slice(None)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_topk_router_sharded_matches_jax(results, shape, name):
    for rank, got, want in _each_rank(results, shape, name):
        gates, ids, psum, counts = got["router"]
        jg, ji, jp, jc = want["router"]
        grp = _group(rank, shape)
        np.testing.assert_array_equal(ids, ji[grp])
        np.testing.assert_allclose(gates, jg[grp], rtol=1e-5, atol=1e-6)
        # the partials gathered over data and summed: global and exact
        np.testing.assert_array_equal(counts, jc)
        np.testing.assert_allclose(psum, jp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weights", ["whole", "stored"])
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_moe_ffn_sharded_matches_jax(results, shape, name, weights):
    for rank, got, want in _each_rank(results, shape, name):
        np.testing.assert_allclose(got[f"ffn_{weights}"],
                                   want["ffn"][_group(rank, shape)],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_moe_layer_matches_jax_mesh_path(results, shape, name):
    data = shape[0]
    for rank, got, want in _each_rank(results, shape, name):
        y, aux = got["layer"]
        jy, jaux = want["layer"]
        np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
        for f in ("expert_counts", "dropped_tokens", "overflow_tokens",
                  "shed_tokens", "shed_delta"):
            np.testing.assert_array_equal(aux[f], jaux[f], err_msg=f)
        np.testing.assert_allclose(aux["dropped"], jaux["dropped"], rtol=1e-6)
        np.testing.assert_allclose(aux["aux_loss"], jaux["aux_loss"],
                                   rtol=1e-5)
        assert int(aux["dropped_tokens"]) > 0  # the drop path is exercised
        if data > 1:  # the model's form: this rank's rows, the global batch
            y_l, aux_l = got["layer_rows"]
            rows = slice(rank // shape[1] * (B // data),
                         (rank // shape[1] + 1) * (B // data))
            np.testing.assert_array_equal(y_l, y[rows])
            for f, v in aux_l.items():
                np.testing.assert_array_equal(v, aux[f], err_msg=f)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_oracle_layer_matches_jax_mesh_path(results, shape, name):
    data = shape[0]
    for rank, got, want in _each_rank(results, shape, name):
        y, aux = got["dense"]
        jy, jaux = want["dense"]
        np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
        for f in ("expert_counts", "dropped_tokens", "overflow_tokens",
                  "shed_tokens", "shed_delta"):
            np.testing.assert_array_equal(aux[f], jaux[f], err_msg=f)
        assert float(aux["dropped"]) == float(jaux["dropped"]) == 0.0
        assert int(aux["overflow_tokens"]) == 0
        assert aux["shed_delta"].shape == (_cfg(name).num_virtual_experts,)
        np.testing.assert_allclose(aux["aux_loss"], jaux["aux_loss"],
                                   rtol=1e-5)
        if data > 1:  # this rank's rows, the global batch
            rows = slice(rank // shape[1] * (B // data),
                         (rank // shape[1] + 1) * (B // data))
            np.testing.assert_array_equal(got["dense_rows"], y[rows])
    # every rank of a data row holds the same sum, bit for bit
    port, _ = results
    for r in range(4):
        first = port[shape][r - r % shape[1]][name]["dense"][0]
        assert np.array_equal(port[shape][r][name]["dense"][0], first)


def test_groups_change_the_drops_as_in_jax(results):
    """Capacity is per dispatch group: (2, 2) drops differently from
    (1, 4), on both sides alike."""
    port, jax_out = results
    differ = []
    for name in CASES:
        drops = {shape: int(port[shape][0][name]["layer"][1]["dropped_tokens"])
                 for shape in SHAPES}
        differ.append(drops[(1, 4)] != drops[(2, 2)])
        assert drops == {shape: int(jax_out[(*shape, name)]["layer"][1][
            "dropped_tokens"]) for shape in SHAPES}
    assert any(differ)


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_by_four_layer_is_bit_equal_to_one_process(results, name):
    port, _ = results
    inp, cfg = INPUTS[name], _cfg(name)
    p = {k: torch.from_numpy(v) for k, v in inp["p"].items()}
    y, aux = moe_layer(torch.from_numpy(inp["x"]), p,
                       torch.from_numpy(inp["e2s"]), cfg, capacity_factor=CF)
    for res in port[(1, 4)]:
        got_y, got_aux = res[name]["layer"]
        assert np.array_equal(got_y, y.numpy())
        for f in aux.__dataclass_fields__:
            assert np.array_equal(got_aux[f], getattr(aux, f).numpy()), f
