"""The SSM and hybrid families' training under JAX's mesh layout across
four ``gloo`` ranks on the CPU, against JAX's mesh path on a forced
4-device host mesh of the same shape (in a subprocess): every leaf's
gradient of ``loss_fn`` as the train step reduces it
(``training/train_step.py::_reduce_grads``) against ``jax.grad`` of
JAX's jitted mesh ``loss_fn``, and one AdamW step against JAX's jitted
``make_train_step(config, policy, …)``, from the same numpy weights and
batch, recomputation off on both sides (the mesh path under ``remat`` is
the attention families' tests'). One step: a second one parts every run
from every other by the sign of Adam's first update on near-zero
gradients (zamba2 smoke's step-2 norm moves by 2e-4 between the port's
one process and JAX's, as much as between its mesh and JAX's), which
``tests/test_torch_mesh_train.py``'s three steps of granite do not.

mamba2's and zamba2's smoke configs in fp32 at ``ssm_chunk = 4`` on both
sides (the reference's SSD backward overflows to NaN at longer chunks:
``tests/test_torch_train.py``), 4 × 16 tokens (sequence-parallel over 4
model ranks), JAX's layer stack in ``"python"`` (zamba2's ``"scan"``
parts from it, ROADMAP C1). This file runs (1, 4);
``test_torch_mesh_ssm_train_2x2.py`` (2, 2),
``test_torch_mesh_ssm_fsdp_train.py`` (2, 2) under FSDP (and the save
restored at (4, 1)) and ``test_torch_mesh_ssm_fsdp_train_4x1.py`` (4, 1)
under FSDP run the same checks with these helpers, a JAX subprocess
each.

Tolerances, ``tests/test_torch_mesh_train.py``'s: the loss within
``LOSS_RTOL`` 1e-5 relative, ``grad_norm`` ``NORM_RTOL`` 1e-4; each
gradient leaf (the rank's block of JAX's) within ``GRAD_TOL`` 1e-4 of
the leaf's max |g| (``tests/test_torch_train.py``'s), and the moments
after the step with them (:func:`check_step` says why the parameters
after it are not held). Each rank's moments hold exactly the bytes of
its shard. Every rank reports the same metrics, bit for bit, and every
whole leaf's gradient is the same on every rank.

Unlike the attention families, a (1, 4) step is not one process's bit for
bit: ``out_proj``'s row partials are summed over the model ranks in fp32
(one process's product sums its heads in one fp32 accumulation), and the
B/C projections' and convolutions' gradients are each rank's heads' terms
summed in rank order. :func:`test_one_by_four_tracks_one_process` holds
the loss within ``ONE_PROCESS_LOSS_RTOL`` 1e-6 and every gradient leaf
within ``ONE_PROCESS_GRAD_TOL`` 5e-5 of its max |g|: the CPU reads
2.7e-6 (mamba2) and 1.7e-5 (zamba2, ``conv_c_w``) of the max.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import MeshAt, rank_shard, ranks, run_jax, spec_of  # noqa: E402
from repro_torch.bridge import params_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
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
from repro_torch.training.optimizer import adamw_state_specs  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    _reduce_grads,
    train_state_specs,
)
from repro_torch.tree import leaves, unflatten  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
GRAD_TOL = 1e-4  # of each leaf's max |g|
ONE_PROCESS_LOSS_RTOL, ONE_PROCESS_GRAD_TOL = 1e-6, 5e-5
ARCHS = ("mamba2-1.3b", "zamba2-1.2b")
SSD_CHUNK = 4
STEPS, B, SEQ = 1, 4, 16
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=STEPS)
# name: (mesh shape, fsdp); a file a case (``test_torch_mesh_ssm_*``)
CASES = {"1x4": ((1, 4), False), "2x2": ((2, 2), False),
         "2x2_fsdp": ((2, 2), True), "4x1_fsdp": ((4, 1), True)}


def cfg_of(arch, get_config=get_smoke_config):
    return dataclasses.replace(get_config(arch), ssm_chunk=SSD_CHUNK)


def _inputs(arch, seed):
    cfg = cfg_of(arch)
    tree = state_to_numpy(init_params(cfg, seed=seed, device="cpu",
                                      dtype=torch.float32))
    rng = np.random.default_rng(seed + 11)
    ssm = tree["blocks"]["ssm"]
    for k in ("dt_bias", "D", "gate_norm", "conv_x_b", "conv_b_b",
              "conv_c_b"):
        ssm[k] = (ssm[k] + rng.standard_normal(ssm[k].shape) * 0.1).astype(
            np.float32)
    data = SyntheticTokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=SEQ, global_batch=B,
                                           seed=seed))
    return {"params": tree, "batches": [next(data) for _ in range(STEPS)]}


INPUTS = {arch: _inputs(arch, seed) for seed, arch in enumerate(ARCHS)}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = v
    return out


def _nbytes(tree):
    if isinstance(tree, dict):
        return {k: _nbytes(v) for k, v in tree.items()}
    return tree.nelement() * tree.element_size()


# ------------------------------------------------------------ the port side
def grads_and_steps(mesh, arch, fsdp):
    """The reduced gradients of the batch, then the train step on it:
    the metrics, the state after it and the moments' bytes."""
    cfg = cfg_of(arch)
    inp = INPUTS[arch]
    policy = None if mesh is None else ShardingPolicy(mesh=mesh, fsdp=fsdp)
    params = params_from_numpy(inp["params"], cfg, "cpu", torch.float32,
                               policy=policy)
    flat_p = leaves(params)
    for p in flat_p:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in inp["batches"][0].items()}
    loss, _ = loss_fn(params, batch, cfg, policy=policy, remat=False)
    grads = torch.autograd.grad(loss, flat_p)
    specs = None
    if policy is not None:
        specs = param_specs(params, policy, cfg)
        grads = _reduce_grads(list(grads), params, specs, policy)
    out = {"loss": float(loss.detach()), "grads": flat(state_to_numpy(
        unflatten(params, [g.detach() for g in grads])))}
    opt = AdamWConfig(**OPT)
    state = init_train_state(params_from_numpy(
        inp["params"], cfg, "cpu", torch.float32, policy=policy), opt)
    step = make_train_step(cfg, opt, policy=policy, remat=False)
    metrics = []
    for b in inp["batches"]:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out.update(metrics=metrics, state=state_to_numpy(state),
               moment_bytes=_nbytes({k: state["opt"][k] for k in ("mu", "nu")}),
               state_specs=None if specs is None else adamw_state_specs(specs))
    return out, state


def _rank(mesh, fsdp, save=None):
    out = {}
    for arch in ARCHS:
        out[arch], state = grads_and_steps(mesh, arch, fsdp)
        if save is not None:
            policy = ShardingPolicy(mesh=mesh, fsdp=fsdp)
            CheckpointManager(f"{save}/{arch}").save(
                STEPS, state, mesh=mesh,
                shardings=train_state_specs(state, policy, cfg_of(arch)))
    return out


def restore_rank(mesh, fsdp, root):
    """Each arch's train state restored from ``root`` onto this rank's
    shards under the mesh's policy."""
    policy = ShardingPolicy(mesh=mesh, fsdp=fsdp)
    out = {}
    for arch in ARCHS:
        cfg = cfg_of(arch)
        skeleton = init_train_state(init_params(
            cfg, seed=0, device="cpu", dtype=torch.float32, policy=policy),
            AdamWConfig(**OPT))
        state, _, step = CheckpointManager(f"{root}/{arch}").restore_sharded(
            skeleton, train_state_specs(skeleton, policy, cfg), mesh=mesh)
        out[arch] = {"step": step, "state": flat(state_to_numpy(state))}
    return out


# ------------------------------------------------------------- the JAX side
def jax_train(payload):
    """``jax.grad`` of JAX's jitted mesh ``loss_fn`` and its jitted mesh
    train step, each case and arch (in a subprocess with 4 forced host
    devices)."""
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
    import repro.models.model as jax_model

    assert jax.device_count() == 4
    # the layer stack unrolled, as the port's (ROADMAP C1)
    scan_or_unroll = jax_model._scan_or_unroll
    jax_model._scan_or_unroll = lambda f, init, xs, mode: scan_or_unroll(
        f, init, xs, "python")
    out = {}
    for name, (shape, fsdp) in payload["cases"].items():
        mesh = make_host_mesh(*shape)
        policy = JaxPolicy(mesh=mesh, fsdp=fsdp)
        for arch in payload["archs"]:
            inp = payload["inputs"][arch]
            cfg = cfg_of(arch, jax_smoke)
            _, specs = jax_init(cfg, jax.random.PRNGKey(0), policy,
                                jnp.float32)
            params = jax.tree.map(
                lambda a, s: jax.device_put(jnp.asarray(a),
                                            NamedSharding(mesh, s)),
                inp["params"], specs)
            batch = {k: jnp.asarray(v) for k, v in inp["batches"][0].items()}

            def loss(p, cfg=cfg, batch=batch):
                return jax_loss(p, batch, cfg, policy, remat=False)[0]

            with mesh:
                value, grads = jax.jit(jax.value_and_grad(loss))(params)
            res = {"loss": float(value),
                   "grads": flat(jax.tree.map(np.asarray, grads))}
            opt = JaxAdamW(**OPT)
            step = jax.jit(jax_make_step(cfg, policy, opt, remat=False))
            state = jax_init_state(jax.tree.map(jnp.asarray, inp["params"]),
                                   opt)
            metrics = []
            with mesh:
                for b in inp["batches"]:
                    state, m = step(state, {k: jnp.asarray(v)
                                            for k, v in b.items()})
                    metrics.append((float(m["loss"]), float(m["grad_norm"])))
            res["metrics"] = metrics
            res["state"] = flat(jax.tree.map(np.asarray, state))
            out[(name, arch)] = res
    return out


def run_case(name, tmp, save=None):
    """JAX's case ``name`` in a subprocess beside the port's ranks;
    returns (each rank's results, JAX's by arch)."""
    shape, fsdp = CASES[name]
    with ThreadPoolExecutor(1) as pool:
        jax_out = pool.submit(run_jax, "test_torch_mesh_ssm_train:jax_train",
                              {"cases": {name: CASES[name]}, "archs": ARCHS,
                               "inputs": INPUTS}, tmp)
        port = ranks(_rank, *shape, tmp, fsdp, save)
        return port, {arch: jax_out.result()[(name, arch)] for arch in ARCHS}


@functools.lru_cache(maxsize=None)
def one_process(arch):
    """The port's gradients and step in one process on the same inputs."""
    return grads_and_steps(None, arch, False)[0]


def specs_of(arch, shape, fsdp):
    return flat(param_specs(INPUTS[arch]["params"],
                            ShardingPolicy(mesh=MeshAt(shape, 0), fsdp=fsdp),
                            cfg_of(arch)))


def _grad_err(got, want, whole):
    """max |Δ| over the whole leaf's max |g|."""
    scale = max(float(np.abs(whole).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


def check_grads(results, name, arch):
    port, jax_out = results
    shape, fsdp = CASES[name]
    want = jax_out[arch]
    specs = specs_of(arch, shape, fsdp)
    for rank, res in enumerate(port):
        got = res[arch]
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
        assert got["grads"].keys() == want["grads"].keys()
        for path, whole in want["grads"].items():
            w = rank_shard(np.asarray(whole, np.float32), specs[path], shape,
                           rank)
            g = got["grads"][path]
            assert g.shape == w.shape, (rank, path)
            assert np.isfinite(g).all(), (rank, path)
            err = _grad_err(g, w, whole)
            assert err <= GRAD_TOL, (rank, path, err)
            if not specs[path]:
                # a whole leaf's gradient: the same on every rank
                assert np.array_equal(g, port[0][arch]["grads"][path]), \
                    (rank, path)


def check_step(results, name, arch):
    """The step's loss and norm against JAX's; the moments after it (the
    rank's block of JAX's) within ``GRAD_TOL`` of the leaf's max (``mu``,
    linear in the clipped gradient) and twice that (``nu``, its square).
    The parameters are not held after the step: Adam's first update of a
    weight is −lr·g/(|g| + ε), and where |g| lies below a leaf's max by
    more than the gradients' tolerance (zamba2's ``blocks/ln`` holds
    gradients of 1.9e-6 against a max of 0.04) its fp32 differences are
    O(1) there (the port's one process parts from JAX by 1.85e-4 of that
    leaf in norm, and (2, 2) from one process by 1.7e-4). The gradients
    and moments held above are what the update reads."""
    port, jax_out = results
    shape, fsdp = CASES[name]
    want = jax_out[arch]
    specs = specs_of(arch, shape, fsdp)
    for rank, res in enumerate(port):
        got = res[arch]
        for (loss, norm), (jl, jn) in zip(got["metrics"], want["metrics"]):
            assert loss == pytest.approx(jl, rel=LOSS_RTOL)
            assert norm == pytest.approx(jn, rel=NORM_RTOL)
        assert got["metrics"] == port[0][arch]["metrics"]
        state = flat(got["state"])
        assert state.keys() == want["state"].keys()
        for path, whole in want["state"].items():
            whole = np.asarray(whole, np.float32)
            w = rank_shard(whole, spec_of(specs, path), shape, rank)
            g = state[path]
            assert g.shape == w.shape, (rank, path)
            if path.startswith("opt/mu/"):
                assert _grad_err(g, w, whole) <= GRAD_TOL, (rank, path)
            elif path.startswith("opt/nu/"):
                assert _grad_err(g, w, whole) <= 2 * GRAD_TOL, (rank, path)


def check_moments(results, name, arch):
    """Each rank's moments: exactly the bytes of its shard by the specs
    (a leaf's global elements over the extents its spec names)."""
    shape, fsdp = CASES[name]
    specs = specs_of(arch, shape, fsdp)
    mesh = MeshAt(shape, 0)
    for res in results[0]:
        got = flat(res[arch]["moment_bytes"])
        for moment in ("mu", "nu"):
            for path, arr in flat(INPUTS[arch]["params"]).items():
                n = arr.size * 4
                for axes in specs[path] or ():
                    if axes is not None:
                        n //= mesh.size(axes)
                assert got[f"{moment}/{path}"] == n, (moment, path)
        assert res[arch]["state_specs"]["mu"] == param_specs(
            INPUTS[arch]["params"], ShardingPolicy(mesh=mesh, fsdp=fsdp),
            cfg_of(arch))


NAME = "1x4"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_case(NAME, tmp_path_factory.mktemp("mesh_ssm_train"))


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_mesh_path(results, arch):
    check_grads(results, NAME, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_mesh_step(results, arch):
    check_step(results, NAME, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moments_hold_exactly_the_ranks_shard(results, arch):
    check_moments(results, NAME, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_four_tracks_one_process(results, arch):
    """(1, 4) against the port's one process on the same inputs: the loss
    and the gradients (see the module's notes for why not bit for
    bit)."""
    one = one_process(arch)
    specs = specs_of(arch, (1, 4), False)
    for rank, res in enumerate(results[0]):
        got = res[arch]
        assert got["loss"] == pytest.approx(one["loss"],
                                            rel=ONE_PROCESS_LOSS_RTOL)
        for path, whole in one["grads"].items():
            w = rank_shard(whole, specs[path], (1, 4), rank)
            err = _grad_err(got["grads"][path], w, whole)
            assert err <= ONE_PROCESS_GRAD_TOL, (rank, path, err)
