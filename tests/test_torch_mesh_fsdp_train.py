"""The port's training step under FSDP (ZeRO-3: parameters, gradients and
AdamW moments stored over ``data`` as well as ``model``) across four
``gloo`` ranks on the CPU, against JAX's ``make_train_step(config,
ShardingPolicy(mesh, fsdp=True), …)`` on a forced 4-device host mesh of
the same shape (``moe_backend="pallas"``: its kernels in interpret mode
under ``shard_map``, their ``custom_vjp`` backwards).

granite's smoke config in fp32, capacity factor 2.0 (assignments drop),
under a seeded non-identity placement, 3 AdamW steps of 16-token rows, at
(2, 2) and (4, 1), from the same numpy weights and batches on both sides:
plain (4 rows), int8 compression (4 rows) and a ``loss_mask`` whose
counts differ between the data ranks with 2 microbatches (8 rows, so that
a microbatch still shards over 4 data ranks).

Tolerances, those of ``tests/test_torch_mesh_train.py``: each step's loss
within 1e-5 relative, ``grad_norm`` 1e-4 (5e-3 after the first step with
compression), ``expert_counts`` and the dropped share exact; each rank's
leaves after step 3 (parameters and moments) against the block of JAX's
global arrays that the rank holds, within 1e-4 relative in norm (5e-3
with compression). Each rank's moments hold exactly the bytes of its
ZeRO block. At accumulation 1 the FSDP step equals the port's step
without FSDP at the same shape, put together from the ranks: the
gradients are the same sums in the same order (the reduce-scatter adds
the data ranks' gradients in rank order, as the replicated step's
all-reduce does), and only the gradient norm adds its slices' squares in
another order. So step 1's loss is bit-equal, the norms within
``SAME_RTOL`` 1e-6, and the state within 1e-6 relative in norm after 3
steps (Adam's update is scale-free, so the norm's last bit moves every
leaf by about as much).
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import MeshAt, ranks, run_jax  # noqa: E402
from repro_torch.bridge import params_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.sharding import ShardingPolicy, param_specs  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    DataConfig,
    SyntheticTokenStream,
    init_train_state,
    make_train_step,
)
from repro_torch.training.optimizer import adamw_state_specs  # noqa: E402

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
STATE_RTOL = 1e-4  # relative, in norm
COMPRESS_TOL = 5e-3  # relative, in norm
SAME_RTOL = 1e-6  # FSDP against the replicated step, relative
STEPS, SEQ = 3, 16
SHAPES = [(2, 2), (4, 1)]
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=STEPS)
# name: (optimizer overrides, accum_steps, rows, masked)
CASES = {
    "plain": ({}, 1, 4, False),
    "int8": (dict(compress=True), 1, 4, False),
    "mask_accum2": ({}, 2, 8, True),
}


def _cfg(get_config):
    return dataclasses.replace(get_config(ARCH), capacity_factor=2.0)


def _inputs(name, seed):
    """The global numpy weights in slot order, the tables and the
    batches of a case."""
    cfg = _cfg(get_smoke_config)
    _, _, rows, masked = CASES[name]
    tree = state_to_numpy(init_params(cfg, seed=seed, device="cpu",
                                      dtype=torch.float32))
    rng = np.random.default_rng(seed + 7)
    s2e = np.stack([rng.permutation(cfg.num_virtual_experts)
                    for _ in range(cfg.num_layers)]).astype(np.int32)
    tree["blocks"]["moe"] = {
        k: (v if k == "router" else np.take_along_axis(
            v, s2e[:, :, None, None], axis=1))
        for k, v in tree["blocks"]["moe"].items()}
    data = SyntheticTokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=SEQ, global_batch=rows,
                                           seed=seed))
    batches = [next(data) for _ in range(STEPS)]
    if masked:
        # unequal valid tokens a row, so the data ranks' counts differ
        mask = np.zeros((rows, SEQ), np.float32)
        for row, n in enumerate((16, 3, 9, 1, 12, 5, 0, 7)):
            mask[row, :n] = 1.0
        for b in batches:
            b["loss_mask"] = mask
    return {"params": tree, "e2s": np.argsort(s2e, axis=1).astype(np.int32),
            "batches": batches}


INPUTS = {name: _inputs(name, seed) for seed, name in enumerate(CASES)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nbytes(tree):
    if isinstance(tree, dict):
        return {k: _nbytes(v) for k, v in tree.items()}
    return tree.nelement() * tree.element_size()


# ------------------------------------------------------------ the port side
def _train(mesh, name, fsdp):
    policy = ShardingPolicy(mesh=mesh, fsdp=fsdp)
    cfg = _cfg(get_smoke_config)
    opt_kw, accum, _, _ = CASES[name]
    inp = INPUTS[name]
    params = params_from_numpy(inp["params"], cfg, "cpu", torch.float32,
                               policy=policy)
    opt = AdamWConfig(**OPT, **opt_kw)
    state = init_train_state(params, opt)
    step = make_train_step(cfg, opt, policy=policy, accum_steps=accum)
    e2s = torch.from_numpy(inp["e2s"])
    metrics = []
    for batch in inp["batches"]:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, e2s)
        metrics.append({k: (v if isinstance(v, float) else v.numpy().copy())
                        for k, v in m.items()})
    specs = param_specs(params, policy, cfg,
                        num_slots=cfg.num_virtual_experts)
    return {"metrics": metrics, "state": state_to_numpy(state),
            "moment_bytes": _nbytes({k: state["opt"][k]
                                     for k in ("mu", "nu")}),
            "state_specs": adamw_state_specs(specs)}


def _rank_cases(mesh):
    out = {name: _train(mesh, name, True) for name in CASES}
    out["replicated"] = _train(mesh, "plain", False)
    return out


# ------------------------------------------------------------- the JAX side
def jax_train_fsdp(payload):
    """JAX's FSDP mesh train step on every case and shape (in a
    subprocess with 4 forced host devices): each step's metrics and the
    final state."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.sharding.policy import ShardingPolicy as JaxPolicy
    from repro.training import (
        AdamWConfig as JaxAdamW,
        init_train_state as jax_init_state,
        make_train_step as jax_make_step,
    )

    assert jax.device_count() == 4
    out = {}
    for shape in SHAPES:
        mesh = make_host_mesh(*shape)
        cfg = dataclasses.replace(_cfg(jax_smoke), moe_backend="pallas")
        for name, (opt_kw, accum, _, _) in CASES.items():
            inp = payload[name]
            opt = JaxAdamW(**OPT, **opt_kw)
            step = jax.jit(jax_make_step(cfg, JaxPolicy(mesh=mesh, fsdp=True),
                                         opt, accum_steps=accum, remat=True))
            state = jax_init_state(jax.tree.map(jnp.asarray, inp["params"]),
                                   opt)
            metrics = []
            with mesh:
                for batch in inp["batches"]:
                    state, m = step(state, {k: jnp.asarray(v)
                                            for k, v in batch.items()},
                                    jnp.asarray(inp["e2s"]))
                    metrics.append(jax.tree.map(np.asarray, m))
            out[(shape, name)] = {"metrics": metrics,
                                  "state": jax.tree.map(np.asarray, state)}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_fsdp_train")
    with ThreadPoolExecutor(1) as pool:  # JAX runs beside the ranks
        jax_out = pool.submit(run_jax, "test_torch_mesh_fsdp_train:"
                              "jax_train_fsdp", INPUTS, tmp)
        port = {shape: ranks(_rank_cases, *shape, tmp) for shape in SHAPES}
        return port, jax_out.result()


def _spec(path, shape):
    """The parameter spec of a train-state path under the port's FSDP
    policy (``opt/mu/…`` and ``ef_residual/…`` name their parameter's)."""
    specs = _flat(param_specs(INPUTS["plain"]["params"],
                              ShardingPolicy(mesh=MeshAt(shape, 0), fsdp=True),
                              _cfg(get_smoke_config)))
    for prefix in ("opt/mu/", "opt/nu/", "ef_residual/", "params/"):
        if path.startswith(prefix):
            return specs.get(path[len(prefix):])
    return None


def _block(whole, spec, shape, rank):
    """The rank's block of a whole array by its spec."""
    mesh = MeshAt(shape, rank)
    for dim, axes in enumerate(spec or ()):
        if axes is not None:
            whole = np.split(whole, mesh.size(axes), axis=dim)[
                mesh.index(axes)]
    return whole


def _whole(rank_states, path, spec, shape, fsdp=True):
    """A leaf put together from the ranks' blocks by its spec (without
    FSDP the spec's ``data`` entries are whole: the data rows hold the
    same blocks)."""
    spec = tuple(a if fsdp or a != "data" else None for a in spec or ())
    blocks = [_flat(s)[path] for s in rank_states]
    size = [n * (1 if a is None else MeshAt(shape, 0).size(a))
            for n, a in zip(blocks[0].shape, spec + (None,) * blocks[0].ndim)]
    out = np.zeros(size, blocks[0].dtype)
    for rank, b in enumerate(blocks):
        mesh = MeshAt(shape, rank)
        idx = tuple(slice(None) if a is None else
                    slice(mesh.index(a) * n, (mesh.index(a) + 1) * n)
                    for n, a in zip(b.shape, spec + (None,) * b.ndim))
        out[idx] = b
    return out


RUNS = [(shape, name) for shape in SHAPES for name in CASES]
IDS = [f"{n}-{s[0]}x{s[1]}" for s, n in RUNS]


@pytest.mark.parametrize("shape,name", RUNS, ids=IDS)
def test_fsdp_train_steps_match_jax_fsdp_step(results, shape, name):
    port, jax_out = results
    want = jax_out[(shape, name)]
    compress = CASES[name][0].get("compress")
    tol = COMPRESS_TOL if compress else STATE_RTOL
    for rank, res in enumerate(port[shape]):
        got = res[name]
        for s, (tm, jm) in enumerate(zip(got["metrics"], want["metrics"])):
            assert float(tm["loss"]) == pytest.approx(
                float(jm["loss"]), rel=LOSS_RTOL), (rank, s)
            norm_tol = COMPRESS_TOL if s and compress else NORM_RTOL
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=norm_tol), (rank, s)
            np.testing.assert_array_equal(tm["expert_counts"],
                                          jm["expert_counts"])
            assert float(tm["moe_dropped"]) == pytest.approx(
                float(jm["moe_dropped"]), rel=1e-6, abs=1e-9)
        # every rank reports the same global metrics, bit for bit
        for tm, t0 in zip(got["metrics"], port[shape][0][name]["metrics"]):
            assert float(tm["loss"]) == float(t0["loss"])
            assert float(tm["grad_norm"]) == float(t0["grad_norm"])
        for path, w in _flat(want["state"]).items():
            if path.startswith("ef_residual"):
                continue  # the scale's rounding boundaries
            g = _flat(got["state"])[path]
            w = _block(np.asarray(w, np.float32), _spec(path, shape), shape,
                       rank)
            assert g.shape == w.shape, (rank, path)
            assert np.isfinite(g).all(), (rank, path)
            err = np.linalg.norm(g - w) / max(float(np.linalg.norm(w)), 1e-30)
            assert err <= tol, (rank, path, err)


def test_fsdp_drops_assignments(results):
    """Capacity factor 2.0 drops assignments on both sides alike, at both
    shapes (the data ranks dispatch as JAX's groups do)."""
    port, jax_out = results
    for shape in SHAPES:
        drops = [float(m["moe_dropped"])
                 for m in port[shape][0]["plain"]["metrics"]]
        assert any(d > 0 for d in drops), shape
        assert drops == [float(m["moe_dropped"]) for m in
                         jax_out[(shape, "plain")]["metrics"]], shape


@pytest.mark.parametrize("shape,name", RUNS, ids=IDS)
def test_fsdp_moments_hold_exactly_the_zero_block(results, shape, name):
    """Each rank's ``mu`` and ``nu`` hold the fp32 bytes of its block of
    every leaf: the global bytes over the extents its spec names, ``data``
    included."""
    port, _ = results
    glob = _flat(INPUTS[name]["params"])
    mesh = MeshAt(shape, 0)
    sharded = 0
    for res in port[shape]:
        got = res[name]
        specs = got["state_specs"]
        assert specs["mu"] == specs["nu"] and specs["step"] == ()
        for moment in ("mu", "nu"):
            flat_bytes = _flat(got["moment_bytes"][moment])
            flat_specs = _flat(specs[moment])
            for path, arr in glob.items():
                spec = flat_specs[path] or ()
                n = arr.size * 4
                for axes in spec:
                    if axes is not None:
                        n //= mesh.size(axes)
                assert flat_bytes[path] == n, (moment, path)
                sharded += "data" in spec
    assert sharded


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "4x1"])
def test_fsdp_equals_the_replicated_step_but_for_the_norm(results, shape):
    port, _ = results
    fsdp = [r["plain"] for r in port[shape]]
    plain = [r["replicated"] for r in port[shape]]
    for f, p in zip(fsdp[0]["metrics"], plain[0]["metrics"]):
        assert float(f["grad_norm"]) == pytest.approx(float(p["grad_norm"]),
                                                      rel=SAME_RTOL)
    assert float(fsdp[0]["metrics"][0]["loss"]) == float(
        plain[0]["metrics"][0]["loss"])
    for path in _flat(fsdp[0]["state"]):
        spec = _spec(path, shape)
        g = _whole([r["state"] for r in fsdp], path, spec, shape)
        w = _whole([r["state"] for r in plain], path, spec, shape,
                   fsdp=False)
        assert g.shape == w.shape, path
        err = np.linalg.norm(g - w) / max(float(np.linalg.norm(w)), 1e-30)
        assert err <= SAME_RTOL, (path, err)
