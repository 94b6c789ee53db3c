"""Gradients through the port's sharded MoE layer on ``gloo`` ranks on the
CPU against ``jax.grad`` through JAX's mesh path: the backwards of
``kernels/sharded.py`` (K1's, with ``dx`` gathered over ``model``; K2's,
with the statistics' cotangent kept on each rank) and of the gather over
``data`` in ``models/moe.py``.

The loss is ``sum(y * y) + aux_loss`` of ``moe_layer``, as JAX's own mesh
gradient tests take it (``tests/test_moe_mesh_parity.py``), on the
``ev20`` and ``ev6`` cases of ``tests/test_torch_mesh_moe.py`` (a
non-identity placement; capacity factor 1.0, so assignments drop; 6
experts on 4 model ranks go through the dead-slot pad) at (1, 4) and
(2, 2). JAX runs ``backend="pallas"`` on a forced 4-device host mesh of
the same shape. Each rank's gradients are summed as the train step sums
them (``training/train_step.py``): over ``data`` for every leaf and for
``dx``, and over ``model`` too for a whole-stored pool. Then ``dx`` and
the router's gradient equal JAX's, and each rank's expert gradients equal
the rows of JAX's that it holds, within ``rtol=2e-4, atol=2e-4`` (JAX's
tolerance for its mesh gradients). The layer on each rank's own rows
(``global_batch``, as training runs it) gives the same gradients. A rank
whose stored shard holds only dead pad slots gets zero weight gradients.

The capacity-free oracle (``backend="dense_ref"`` on both sides) is held
the same way: each rank mixes its share of the slots, the tokens and
gates enter that region through ``sum_grads_over`` and the partials leave
it through ``sum_over`` (``models/dispatch.py::dense_mix``).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import ranks, run_jax  # noqa: E402
from test_torch_mesh_moe import B, CASES, CF, INPUTS, SHAPES, _cfg  # noqa: E402
from repro_torch.models.moe import moe_layer  # noqa: E402
from repro_torch.sharding import ShardingPolicy, local_expert_slots  # noqa: E402

torch.set_num_threads(1)

RTOL = ATOL = 2e-4
NAMES = ("router", "w_gate", "w_up", "w_down")


def _leaves(p):
    return {k: v.clone().requires_grad_(True) for k, v in p.items()}


def _summed(mesh, x, leaves, whole_pool):
    """The gradients summed over the ranks that hold a leaf alike."""
    out = {"dx": mesh.all_reduce(x.grad, "data").numpy()}
    for k, t in leaves.items():
        axes = ("data", "model") if (whole_pool and k != "router"
                                     and mesh.size("model") > 1) else "data"
        out[k] = mesh.all_reduce(t.grad, axes).numpy()
    return out


def _rank_grads(mesh):
    out = _backend_grads(mesh, None)
    for name, res in _backend_grads(mesh, "dense_ref").items():
        out[name].update({f"{form}:dense_ref": g for form, g in res.items()})
    return out


def _backend_grads(mesh, backend):
    policy = ShardingPolicy(mesh=mesh)
    d = policy.data_axis_size
    out = {}
    for name, inp in INPUTS.items():
        cfg = _cfg(name)
        Ev = cfg.num_virtual_experts
        sl = local_expert_slots(policy, Ev)
        p = {k: torch.from_numpy(v if sl is None or k == "router" else v[sl])
             for k, v in inp["p"].items()}
        e2s = torch.from_numpy(inp["e2s"])
        x = torch.from_numpy(inp["x"])
        res = {}
        # the whole batch on every rank (the layer gathers y over data,
        # and every rank's loss is the whole loss)
        xw, lv = x.clone().requires_grad_(True), _leaves(p)
        y, aux = moe_layer(xw, lv, e2s, cfg, policy, capacity_factor=CF,
                           num_slots=Ev, backend=backend)
        (torch.sum(y * y) + aux.aux_loss).backward()
        res["whole"] = _summed(mesh, xw, lv, sl is None)
        if d > 1:  # the training form: this rank's rows, global_batch = B
            r = mesh.index("data")
            rows = slice(r * (B // d), (r + 1) * (B // d))
            xr, lv = x.clone().requires_grad_(True), _leaves(p)
            y, aux = moe_layer(xr[rows], lv, e2s, cfg, policy,
                               capacity_factor=CF, num_slots=Ev,
                               global_batch=B, backend=backend)
            # the rank's share of the loss: its rows' sum of squares and
            # the aux term, whose backward reaches only its own rows
            (torch.sum(y * y) + aux.aux_loss).backward()
            res["rows"] = _summed(mesh, xr, lv, sl is None)
        if sl is None and mesh.size("model") > 1:
            # a stored shard of the zero-padded pool: the last rank's
            # slots are all dead pad slots
            per = -(-Ev // mesh.size("model"))
            lo = mesh.index("model") * per
            padded = {}
            for k, v in inp["p"].items():
                if k == "router":
                    padded[k] = torch.from_numpy(v)
                    continue
                full = np.zeros((per * mesh.size("model"), *v.shape[1:]),
                                np.float32)
                full[:Ev] = v
                padded[k] = torch.from_numpy(full[lo:lo + per])
            lv = _leaves(padded)
            y, aux = moe_layer(x, lv, e2s, cfg, policy, capacity_factor=CF,
                               num_slots=Ev, backend=backend)
            (torch.sum(y * y) + aux.aux_loss).backward()
            res["padded"] = {k: mesh.all_reduce(t.grad, "data").numpy()
                             for k, t in lv.items()}
            res["padded_slots"] = (lo, per)
        out[name] = res
    return out


# ------------------------------------------------------------- the JAX side
def jax_grads(payload):
    """``jax.grad`` of the loss through JAX's mesh path (in a subprocess
    with 4 forced host devices)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
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
            table = jnp.asarray(inp["e2s"])

            for backend in ("pallas", "dense_ref"):
                def loss(x, p, cfg=cfg, table=table, backend=backend):
                    y, aux = jax_moe_layer(x, p, table, cfg, policy,
                                           capacity_factor=CF,
                                           backend=backend)
                    return jnp.sum(y * y) + aux["aux_loss"]

                with mesh:
                    dx, dp = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                        jnp.asarray(inp["x"]),
                        {k: jnp.asarray(v) for k, v in inp["p"].items()})
                key = (data, model, name) if backend == "pallas" else (
                    data, model, name, backend)
                out[key] = {"dx": np.asarray(dx),
                            **{k: np.asarray(v) for k, v in dp.items()}}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_grad")
    with ThreadPoolExecutor(1) as pool:  # JAX runs beside the ranks
        jax_out = pool.submit(run_jax, "test_torch_mesh_grad:jax_grads",
                              {"shapes": SHAPES, "inputs": INPUTS}, tmp)
        port = {shape: ranks(_rank_grads, *shape, tmp) for shape in SHAPES}
        return port, jax_out.result()


def _mine(rank, shape, name, want):
    """The rows of JAX's expert gradient that a rank's stored shard holds."""
    Ev = _cfg(name).num_virtual_experts
    model = shape[1]
    if Ev % model:
        return want  # stored whole
    per = Ev // model
    m = rank % model
    return want[m * per:(m + 1) * per]


# the rows form needs a data axis: with one data rank they are the batch
FORMS = [((1, 4), "whole"), ((2, 2), "whole"), ((2, 2), "rows")]


def _check_grads(results, shape, name, form, backend=None):
    port, jax_out = results
    want = jax_out[(*shape, name) if backend is None else
                   (*shape, name, backend)]
    for rank, res in enumerate(port[shape]):
        got = res[name][form if backend is None else f"{form}:{backend}"]
        np.testing.assert_allclose(got["dx"], want["dx"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {rank} dx")
        np.testing.assert_allclose(got["router"], want["router"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {rank} router")
        for k in NAMES[1:]:
            np.testing.assert_allclose(
                got[k], _mine(rank, shape, name, want[k]), rtol=RTOL,
                atol=ATOL, err_msg=f"rank {rank} {k}")
        assert np.abs(got["w_gate"]).max() > 0  # gradients do flow


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("shape,form", FORMS,
                         ids=[f"{s[0]}x{s[1]}-{f}" for s, f in FORMS])
def test_moe_layer_gradients_match_jax_mesh_path(results, shape, name, form):
    _check_grads(results, shape, name, form)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("shape,form", FORMS,
                         ids=[f"{s[0]}x{s[1]}-{f}" for s, f in FORMS])
def test_oracle_gradients_match_jax_mesh_path(results, shape, name, form):
    _check_grads(results, shape, name, form, "dense_ref")


def _check_dead_pad(results, backend=None):
    port, jax_out = results
    tag = "" if backend is None else f":{backend}"
    want = jax_out[(1, 4, "ev6") if backend is None else
                   (1, 4, "ev6", backend)]
    for rank, res in enumerate(port[(1, 4)]):
        got = res["ev6"]["padded" + tag]
        lo, per = res["ev6"]["padded_slots" + tag]
        live = max(min(per, 6 - lo), 0)
        for k in NAMES[1:]:
            assert not got[k][live:].any(), (rank, k)
            np.testing.assert_allclose(got[k][:live], want[k][lo:lo + live],
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["router"], want["router"], rtol=RTOL,
                                   atol=ATOL)
    assert port[(1, 4)][3]["ev6"]["padded_slots" + tag] == (6, 2)


def test_dead_pad_slots_take_no_gradient(results):
    """ev6 on 4 model ranks: each rank stores 2 slots of the pool padded
    to 8; the last rank's are both dead and get exact zeros, the others
    get JAX's rows."""
    _check_dead_pad(results)


def test_oracle_dead_pad_slots_take_no_gradient(results):
    """The same padded shards under the oracle: ``dense_mix`` mixes only a
    shard's live rows (none on the last rank), so the dead rows' gradients
    are exact zeros and the live ones JAX's ``dense_ref`` rows."""
    _check_dead_pad(results, "dense_ref")
