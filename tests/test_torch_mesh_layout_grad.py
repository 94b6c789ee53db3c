"""The model-axis layout's gradients and training across ``gloo`` ranks on
the CPU against JAX's mesh path on a forced 4-device host mesh of the same
shape (in a subprocess): every leaf's gradient of ``loss_fn`` as the train
step reduces it (``training/train_step.py::_reduce_grads``), against
``jax.grad`` of JAX's jitted ``loss_fn`` with the parameters placed by
JAX's specs (``moe_backend="pallas"``), and three AdamW steps of a dense
family.

Cases: granite smoke (MoE; 4 × 16 tokens, sequence-parallel: the norm
scales applied to each rank's rows, the MoE layer a replicated region
inside the sequence-parallel one, the tied head's gradient over every
rank's rows) at (1, 4) and (2, 2); the same at 4 × 14 tokens, which 4
ranks do not divide (every rank runs every row, the weights gathered);
qwen3 smoke (dense: the column/row-parallel MLP, ``qk_norm``, an untied
head) at (1, 4). A rank's gradient of a leaf sharded over ``model`` is
its block of JAX's; every other leaf's is JAX's whole. Tolerance
``rtol = atol = 2e-4``, JAX's for its mesh gradients
(``tests/test_torch_mesh_grad.py``).

Two faults this test catches (each fails it when put into the port): the
norm scales' gradient taken as the rank's rows' share (then broadcast from
the model axis's first rank, as a whole leaf's is) instead of summed over
every rank's rows; and the MoE region closed by a plain slice, whose
adjoint leaves the expert and router gradients with the rank's rows only.

qwen3's 3 steps at (1, 4): each step's loss within 1e-5 and grad norm
within 1e-4 relative of JAX's jitted mesh train step, each leaf after the
last step (put together from the ranks where sharded) within 1e-4
relative in norm: ``tests/test_torch_mesh_train.py``'s tolerances.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import MeshAt, rank_shard, ranks, run_jax, spec_of  # noqa: E402
from repro_torch.bridge import params_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.model import loss_fn  # noqa: E402
from repro_torch.sharding import ShardingPolicy, param_specs  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    DataConfig,
    SyntheticTokenStream,
    init_train_state,
    make_train_step,
)
from repro_torch.training.train_step import _reduce_grads  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

torch.set_num_threads(1)

RTOL = ATOL = 2e-4
LOSS_RTOL, NORM_RTOL, STATE_RTOL = 1e-5, 1e-4, 1e-4
# name: (arch, mesh shape, tokens a row)
CASES = {
    "granite": ("granite-moe-3b-a800m", (1, 4), 16),
    "granite_2x2": ("granite-moe-3b-a800m", (2, 2), 16),
    "granite_fallback": ("granite-moe-3b-a800m", (1, 4), 14),
    "qwen3": ("qwen3-32b", (1, 4), 16),
}
B, STEPS = 4, 3
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=STEPS)


def _cfg(name, get_config=get_smoke_config):
    return dataclasses.replace(get_config(CASES[name][0]),
                               capacity_factor=2.0)


def _inputs(name, seed):
    cfg = _cfg(name)
    tree = state_to_numpy(init_params(cfg, seed=seed, device="cpu",
                                      dtype=torch.float32))
    rng = np.random.default_rng(seed)
    for key in ("ln1", "ln2"):  # non-zero scales, so that they count
        tree["blocks"][key] = (rng.standard_normal(
            tree["blocks"][key].shape) * 0.1).astype(np.float32)
    tree["final_norm"] = (rng.standard_normal(tree["final_norm"].shape)
                          * 0.1).astype(np.float32)
    e2s = None
    if cfg.is_moe:
        Ev = cfg.num_virtual_experts
        s2e = np.stack([rng.permutation(Ev) for _ in range(cfg.num_layers)])
        tree["blocks"]["moe"] = {
            k: (v if k == "router" else np.take_along_axis(
                v, s2e[:, :, None, None], axis=1))
            for k, v in tree["blocks"]["moe"].items()}
        e2s = np.argsort(s2e, axis=1).astype(np.int32)
    data = SyntheticTokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=CASES[name][2],
                                           global_batch=B, seed=seed))
    return {"params": tree, "e2s": e2s,
            "batches": [next(data) for _ in range(STEPS)]}


INPUTS = {name: _inputs(name, seed) for seed, name in enumerate(CASES)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ------------------------------------------------------------ the port side
def _rank(mesh, names):
    out = {}
    for name in names:
        cfg = _cfg(name)
        inp = INPUTS[name]
        policy = ShardingPolicy(mesh=mesh)
        slots = cfg.num_virtual_experts if cfg.is_moe else None
        e2s = None if inp["e2s"] is None else torch.from_numpy(inp["e2s"])
        params = params_from_numpy(inp["params"], cfg, "cpu", torch.float32,
                                   policy=policy)
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v) for k, v in inp["batches"][0].items()}
        loss, _ = loss_fn(params, batch, cfg, e2s, policy=policy,
                          num_slots=slots)
        grads = torch.autograd.grad(loss, flat)
        grads = _reduce_grads(list(grads), params,
                              param_specs(params, policy, cfg, num_slots=slots),
                              policy)
        res = {"loss": float(loss), "grads": _flat(state_to_numpy(
            unflatten(params, [g.detach() for g in grads])))}
        if name == "qwen3":
            opt = AdamWConfig(**OPT)
            state = init_train_state(params_from_numpy(
                inp["params"], cfg, "cpu", torch.float32, policy=policy), opt)
            step = make_train_step(cfg, opt, policy=policy)
            metrics = []
            for b in inp["batches"]:
                state, m = step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            res["metrics"] = metrics
            res["state"] = _flat(state_to_numpy(state))
        out[name] = res
    return out


# ------------------------------------------------------------- the JAX side
def jax_grads(payload):
    """``jax.grad`` of JAX's jitted mesh ``loss_fn``, and qwen3's three
    train steps (in a subprocess with 4 forced host devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.models.model import init_params as jax_init
    from repro.models.model import loss_fn as jax_loss
    from repro.sharding.policy import ShardingPolicy as JaxPolicy
    from repro.training import (
        AdamWConfig as JaxAdamW,
        init_train_state as jax_init_state,
        make_train_step as jax_make_step,
    )

    assert jax.device_count() == 4
    out = {}
    for name, (arch, shape, _) in payload["cases"].items():
        inp = payload["inputs"][name]
        cfg = dataclasses.replace(_cfg(name, jax_smoke), moe_backend="pallas")
        mesh = make_host_mesh(*shape)
        policy = JaxPolicy(mesh=mesh)
        _, specs = jax_init(cfg, jax.random.PRNGKey(0), policy, jnp.float32)
        params = jax.tree.map(
            lambda a, s: jax.device_put(jnp.asarray(a),
                                        NamedSharding(mesh, s)),
            inp["params"], specs)
        table = None if inp["e2s"] is None else jnp.asarray(inp["e2s"])
        batch = {k: jnp.asarray(v) for k, v in inp["batches"][0].items()}

        def loss(p, cfg=cfg, table=table, batch=batch):
            return jax_loss(p, batch, cfg, policy, table, remat=True)[0]

        with mesh:
            value, grads = jax.jit(jax.value_and_grad(loss))(params)
        res = {"loss": float(value),
               "grads": _flat(jax.tree.map(np.asarray, grads))}
        if name == "qwen3":
            opt = JaxAdamW(**OPT)
            step = jax.jit(jax_make_step(cfg, policy, opt, remat=True))
            state = jax_init_state(jax.tree.map(jnp.asarray, inp["params"]),
                                   opt)
            metrics = []
            with mesh:
                for b in inp["batches"]:
                    state, m = step(state, {k: jnp.asarray(v)
                                            for k, v in b.items()})
                    metrics.append((float(m["loss"]), float(m["grad_norm"])))
            res["metrics"] = metrics
            res["state"] = _flat(jax.tree.map(np.asarray, state))
        out[name] = res
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_layout_grad")
    with ThreadPoolExecutor(1) as pool:  # JAX runs beside the ranks
        jax_out = pool.submit(run_jax, "test_torch_mesh_layout_grad:jax_grads",
                              {"cases": CASES, "inputs": INPUTS}, tmp)
        port = {}
        for shape in sorted({c[1] for c in CASES.values()}):
            names = [n for n, c in CASES.items() if c[1] == shape]
            port[shape] = ranks(_rank, *shape, tmp, names)
        return port, jax_out.result()


def _specs(name, shape):
    return _flat(param_specs(INPUTS[name]["params"],
                             ShardingPolicy(mesh=MeshAt(shape, 0)),
                             _cfg(name)))


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax_mesh_path(results, name):
    port, jax_out = results
    shape = CASES[name][1]
    want = jax_out[name]
    specs = _specs(name, shape)
    for rank, res in enumerate(port[shape]):
        got = res[name]
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
        assert got["grads"].keys() == want["grads"].keys()
        for path, w in want["grads"].items():
            w = rank_shard(np.asarray(w, np.float32), specs[path], shape,
                           rank)
            np.testing.assert_allclose(got["grads"][path], w, rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{name} rank {rank} {path}")
        # the same gradient of every whole leaf on every rank, bit for bit
        for path, g in got["grads"].items():
            if "model" not in (specs[path] or ()):
                assert np.array_equal(g, port[shape][0][name]["grads"][path])


def test_the_norm_scales_and_the_moe_region_take_gradient(results):
    """The gradients the two faults above would drop are not zero here:
    the norm scales' and the router's, on every rank."""
    port, _ = results
    for res in port[(1, 4)]:
        g = res["granite"]["grads"]
        for path in ("blocks/ln1", "blocks/ln2", "final_norm",
                     "blocks/moe/router", "blocks/moe/w_gate"):
            assert np.abs(g[path]).max() > 1e-6, path


def test_dense_family_trains_as_jax_mesh_step(results):
    port, jax_out = results
    want = jax_out["qwen3"]
    shape = CASES["qwen3"][1]
    specs = _specs("qwen3", shape)
    for rank, res in enumerate(port[shape]):
        got = res["qwen3"]
        for (loss, norm), (jl, jn) in zip(got["metrics"], want["metrics"]):
            assert loss == pytest.approx(jl, rel=LOSS_RTOL)
            assert norm == pytest.approx(jn, rel=NORM_RTOL)
        assert got["metrics"] == port[shape][0]["qwen3"]["metrics"]
        for path, w in want["state"].items():
            spec = spec_of(specs, path) or ()
            g = got["state"][path]
            if "model" in spec:  # the ranks' blocks put together
                g = np.concatenate([port[shape][r]["qwen3"]["state"][path]
                                    for r in range(shape[1])],
                                   axis=spec.index("model"))
            w = np.asarray(w, np.float32)
            assert g.shape == w.shape, path
            err = np.linalg.norm(g - w) / max(float(np.linalg.norm(w)), 1e-30)
            assert err <= STATE_RTOL, (rank, path, err)
