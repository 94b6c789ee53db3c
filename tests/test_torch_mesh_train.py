"""The port's training step under a mesh of ``gloo`` ranks on the CPU
against JAX's ``make_train_step(config, policy, …)`` on a forced 4-device
host mesh of the same shape (``moe_backend="pallas"``: its kernels in
interpret mode under ``shard_map``, their ``custom_vjp`` backwards).

granite's smoke config in fp32, capacity factor 2.0, under a seeded
non-identity placement, 3 AdamW steps of 4 × 16 tokens, at (1, 4) and
(2, 2) (JAX's (2, 2) dispatches in two groups, each with its own
capacity), from the same numpy weights and batches on both sides. Also:
a pool of 6 experts, which 4 model ranks do not divide (stored whole, its
rows computed apart and summed over ``model``); int8 compression (the
scale a max over ``model``); a ``loss_mask`` whose counts differ between
the data ranks, with 2 microbatches; and, on the port alone, 2
microbatches ≡ 1 under a mesh where the two are the same math.

Tolerances, those of the single-card three-step test
(``tests/test_torch_optim.py::test_three_train_steps_track_jax``): each
step's loss within ``LOSS_RTOL`` 1e-5 relative, ``grad_norm`` 1e-4,
``expert_counts`` and the dropped share exact; each rank's leaves after step
3 (parameters and moments) against JAX's global arrays within ``STATE_RTOL``
1e-4 relative in norm (5e-3 with compression: a rounding boundary moves a
whole leaf's scale): an expert stack's rows on each rank against the same
rows of JAX's, every other leaf whole, its blocks over ``model`` (the port's
``param_specs``: the projections and the vocabulary) put together from the
ranks of a data row. An element-wise bound of 1e-4 of the leaf's max does
not hold after three AdamW steps between the packages even on one device:
where a gradient is near 0 the update's sign follows its last bits. At (1,
4) (16 tokens a row: sequence-parallel, 4 rows a rank) every rank's state is
also bit-equal to the port's one-process state, and every rank reports the
same metrics, bit for bit. Each rank's moments hold exactly the bytes of the
rank's shard that ``adamw_state_specs`` names.
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
STEPS, B, SEQ = 3, 4, 16
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=STEPS)
# name: (config overrides, optimizer overrides, accum_steps, masked, shapes)
CASES = {
    "plain": ({}, {}, 1, False, [(1, 4), (2, 2)]),
    "ev6": (dict(num_experts=6), {}, 1, False, [(1, 4)]),
    "int8": ({}, dict(compress=True), 1, False, [(2, 2)]),
    "mask_accum2": ({}, {}, 2, True, [(2, 2)]),
}
# 2 microbatches ≡ 1 where they are the same math: no aux term, no drops
SAME_MATH = dict(router_aux_coef=0.0, capacity_factor=8.0)


def _cfg(get_config, overrides):
    return dataclasses.replace(get_config(ARCH),
                               **{"capacity_factor": 2.0, **overrides})


def _placement(num_layers, num_slots, seed):
    rng = np.random.default_rng(seed)
    s2e = np.stack([rng.permutation(num_slots) for _ in range(num_layers)])
    return s2e.astype(np.int32), np.argsort(s2e, axis=1).astype(np.int32)


def _inputs(name, seed):
    """The global numpy weights in slot order, the tables and the
    batches of a case."""
    cfg = _cfg(get_smoke_config, CASES.get(name, (SAME_MATH,))[0])
    tree = state_to_numpy(init_params(cfg, seed=seed, device="cpu",
                                      dtype=torch.float32))
    s2e, e2s = _placement(cfg.num_layers, cfg.num_virtual_experts, seed + 7)
    tree["blocks"]["moe"] = {
        k: (v if k == "router" else np.take_along_axis(
            v, s2e[:, :, None, None], axis=1))
        for k, v in tree["blocks"]["moe"].items()}
    data = SyntheticTokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=SEQ, global_batch=B,
                                           seed=seed))
    batches = [next(data) for _ in range(STEPS)]
    if name == "mask_accum2":
        # unequal valid tokens a row, so the data ranks' counts differ
        mask = np.zeros((B, SEQ), np.float32)
        for row, n in enumerate((16, 3, 9, 1)):
            mask[row, :n] = 1.0
        for b in batches:
            b["loss_mask"] = mask
    return {"params": tree, "e2s": e2s, "batches": batches}


INPUTS = {name: _inputs(name, seed)
          for seed, name in enumerate([*CASES, "same_math"])}


# ------------------------------------------------------------ the port side
def _nbytes(tree):
    if isinstance(tree, dict):
        return {k: _nbytes(v) for k, v in tree.items()}
    return tree.nelement() * tree.element_size()


def _train(mesh, name, overrides, opt_kw, accum):
    policy = ShardingPolicy(mesh=mesh)
    cfg = _cfg(get_smoke_config, overrides)
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
            "moment_bytes": _nbytes({k: state["opt"][k] for k in ("mu", "nu")}),
            "state_specs": adamw_state_specs(specs)}


def _rank_cases(mesh, names):
    shape = (mesh.size("data"), mesh.size("model"))
    out = {}
    for name in names:
        overrides, opt_kw, accum, _, _ = CASES[name]
        out[name] = _train(mesh, name, overrides, opt_kw, accum)
    if shape == (2, 2):
        out["same_math"] = {accum: _train(mesh, "same_math", SAME_MATH, {},
                                          accum) for accum in (1, 2)}
    return out


# ------------------------------------------------------------- the JAX side
def jax_train(payload):
    """JAX's mesh train step on every case and shape (in a subprocess with
    4 forced host devices): each step's metrics and the final state."""
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
    for (data, model), name in payload["runs"]:
        overrides, opt_kw, accum, _, _ = CASES[name]
        inp = payload["inputs"][name]
        mesh = make_host_mesh(data, model)
        cfg = dataclasses.replace(_cfg(jax_smoke, overrides),
                                  moe_backend="pallas")
        opt = JaxAdamW(**OPT, **opt_kw)
        step = jax.jit(jax_make_step(cfg, JaxPolicy(mesh=mesh), opt,
                                     accum_steps=accum, remat=True))
        state = jax_init_state(jax.tree.map(jnp.asarray, inp["params"]), opt)
        metrics = []
        with mesh:
            for batch in inp["batches"]:
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                                jnp.asarray(inp["e2s"]))
                metrics.append(jax.tree.map(np.asarray, m))
        out[((data, model), name)] = {
            "metrics": metrics, "state": jax.tree.map(np.asarray, state)}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    runs = [(shape, name) for name, case in CASES.items()
            for shape in case[4]]
    names = {shape: [n for s, n in runs if s == shape]
             for shape in ((1, 4), (2, 2))}
    with ThreadPoolExecutor(1) as pool:  # JAX runs beside the ranks
        jax_out = pool.submit(run_jax, "test_torch_mesh_train:jax_train",
                              {"runs": runs, "inputs": INPUTS}, tmp)
        port = {shape: ranks(_rank_cases, *shape, tmp, names[shape])
                for shape in names}
        return port, jax_out.result()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _spec(path, shape, name):
    specs = param_specs(INPUTS[name]["params"],
                        ShardingPolicy(mesh=MeshAt(shape, 0)),
                        _cfg(get_smoke_config, CASES[name][0]))
    return spec_of(_flat(specs), path)


def _rows(path, want, rank, shape, name):
    """The rank's shard of JAX's global leaf by the port's specs."""
    return rank_shard(want, _spec(path, shape, name), shape, rank)


def _held(ranks_out, path, rank, shape, name):
    """(what the rank's row of the mesh holds of a leaf, the part of the
    global leaf it is held against): an expert stack's rows on the rank
    itself, against the same rows of the global leaf; every other leaf
    sharded over ``model`` put together from the ranks of the rank's data
    row (its blocks concatenated), against the whole global leaf, as the
    leaf was compared when every rank held it whole."""
    spec = _spec(path, shape, name) or ()
    mine = _flat(ranks_out[rank][name]["state"])[path]
    expert = path.split("/")[-1] in ("w_gate", "w_up", "w_down") and \
        "/moe/" in f"/{path}"
    if expert or "model" not in spec:
        return mine, lambda w: _rows(path, w, rank, shape, name)
    row = rank // shape[1] * shape[1]
    whole = np.concatenate(
        [_flat(ranks_out[r][name]["state"])[path]
         for r in range(row, row + shape[1])], axis=spec.index("model"))
    return whole, lambda w: w


class _Grouped(ShardingPolicy):
    """One process that dispatches in two groups, as (2, 2) does."""

    @property
    def data_axis_size(self) -> int:
        return 2


def _one_process(name, groups=1):
    """The case's steps on the port in this process, without a mesh,
    dispatched in ``groups`` groups."""
    overrides, opt_kw, accum, _, _ = CASES[name]
    cfg = _cfg(get_smoke_config, overrides)
    inp = INPUTS[name]
    opt = AdamWConfig(**OPT, **opt_kw)
    state = init_train_state(params_from_numpy(inp["params"], cfg, "cpu",
                                               torch.float32), opt)
    step = make_train_step(cfg, opt, accum_steps=accum,
                           policy=_Grouped() if groups == 2 else None)
    metrics = []
    for batch in inp["batches"]:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                        torch.from_numpy(inp["e2s"]))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, _flat(state_to_numpy(state))


RUNS = [(shape, name) for name, case in CASES.items() for shape in case[4]]


@pytest.mark.parametrize("shape,name", RUNS,
                         ids=[f"{n}-{s[0]}x{s[1]}" for s, n in RUNS])
def test_train_steps_match_jax_mesh_step(results, shape, name):
    port, jax_out = results
    want = jax_out[(shape, name)]
    for rank, res in enumerate(port[shape]):
        got = res[name]
        for s, (tm, jm) in enumerate(zip(got["metrics"], want["metrics"])):
            assert float(tm["loss"]) == pytest.approx(
                float(jm["loss"]), rel=LOSS_RTOL), (rank, s)
            # with compression, after the first step the quantizer's
            # rounding flips a level where the two sum in other orders
            norm_tol = (COMPRESS_TOL if s and CASES[name][1].get("compress")
                        else NORM_RTOL)
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=norm_tol), (rank, s)
            assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
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
                continue  # the scale's rounding boundaries (see above)
            g, part = _held(port[shape], path, rank, shape, name)
            w = part(np.asarray(w, np.float32))
            assert g.shape == w.shape, path
            assert np.isfinite(g).all(), path
            tol = COMPRESS_TOL if CASES[name][1].get("compress") else STATE_RTOL
            err = np.linalg.norm(g - w) / max(float(np.linalg.norm(w)), 1e-30)
            assert err <= tol, (rank, path, err)


@pytest.mark.parametrize("name", ["plain", "ev6"])
def test_one_by_four_equals_one_process_bit_for_bit(results, name):
    """At (1, 4) each rank computes what one process does: its experts'
    rows and its blocks of the sequence and the projections, of the same
    products, gathered, and the same sums."""
    port, _ = results
    metrics, state = _one_process(name)
    for rank, res in enumerate(port[(1, 4)]):
        got = res[name]
        assert [(float(m["loss"]), float(m["grad_norm"]))
                for m in got["metrics"]] == metrics
        for path, g in _flat(got["state"]).items():
            w = _rows(path, state[path], rank, (1, 4), name)
            assert np.array_equal(g, w), (rank, path)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if (2, 2) in c[4]])
def test_two_by_two_tracks_one_process_in_two_groups(results, name):
    """At (2, 2) the ranks sum the same terms as one process that
    dispatches in two groups, in other orders: the metrics and every
    rank's state agree to the fp32 tolerances (the state within
    ``COMPRESS_TOL`` with compression, whose levels flip on the orders'
    last bits)."""
    port, _ = results
    tol = COMPRESS_TOL if CASES[name][1].get("compress") else STATE_RTOL
    metrics, state = _one_process(name, groups=2)
    for rank, res in enumerate(port[(2, 2)]):
        got = res[name]
        for m, (loss, norm) in zip(got["metrics"], metrics):
            assert float(m["loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
            assert float(m["grad_norm"]) == pytest.approx(norm, rel=NORM_RTOL)
        for path in _flat(got["state"]):
            if path.startswith("ef_residual"):
                continue  # a flipped level moves it by a whole level
            g, part = _held(port[(2, 2)], path, rank, (2, 2), name)
            w = part(state[path])
            err = np.linalg.norm(g - w) / max(float(np.linalg.norm(w)), 1e-30)
            assert err <= tol, (rank, path, err)


def test_drops_and_groups_are_exercised(results):
    """The plain case drops assignments, and (2, 2)'s two dispatch groups
    drop differently from (1, 4)'s one, on both sides alike."""
    port, jax_out = results
    drops = {shape: [float(m["moe_dropped"]) for m in
                     port[shape][0]["plain"]["metrics"]]
             for shape in ((1, 4), (2, 2))}
    assert any(d > 0 for d in drops[(1, 4)])
    assert any(d > 0 for d in drops[(2, 2)])
    assert drops[(1, 4)] != drops[(2, 2)]
    for shape in drops:
        assert drops[shape] == [float(m["moe_dropped"]) for m in
                                jax_out[(shape, "plain")]["metrics"]]


@pytest.mark.parametrize("shape,name", RUNS,
                         ids=[f"{n}-{s[0]}x{s[1]}" for s, n in RUNS])
def test_moments_hold_exactly_the_ranks_shard(results, shape, name):
    port, _ = results
    data, model = shape
    inp = INPUTS[name]
    glob = _flat(inp["params"])
    for res in port[shape]:
        got = res[name]
        specs = got["state_specs"]
        assert specs["step"] == ()
        assert specs["mu"] == specs["nu"]
        for moment in ("mu", "nu"):
            flat_bytes = _flat(got["moment_bytes"][moment])
            flat_specs = _flat_specs(specs[moment])
            for path, arr in glob.items():
                n = arr.size * 4  # fp32 moments of the global leaf
                for axes in flat_specs[path] or ():
                    if axes is not None:
                        n //= model  # a dim over "model"
                assert flat_bytes[path] == n, (moment, path)


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_two_microbatches_equal_one_under_a_mesh(results):
    port, _ = results
    for res in port[(2, 2)]:
        one, two = res["same_math"][1], res["same_math"][2]
        for m1, m2 in zip(one["metrics"], two["metrics"]):
            assert float(m2["loss"]) == pytest.approx(float(m1["loss"]),
                                                      rel=LOSS_RTOL)
            assert float(m2["grad_norm"]) == pytest.approx(
                float(m1["grad_norm"]), rel=NORM_RTOL)
        a, b = _flat(one["state"]), _flat(two["state"])
        for path in a:
            err = np.linalg.norm(b[path] - a[path]) / max(
                float(np.linalg.norm(a[path])), 1e-30)
            assert err <= STATE_RTOL, (path, err)
