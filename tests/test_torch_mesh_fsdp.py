"""FSDP's layout (ZeRO-3: the projections, the vocabulary and the expert
stacks stored over ``data`` as well as ``model``) and its checkpoints.

In this process, against JAX's specs at (2, 2) and (4, 1):

* ``param_specs`` under ``ShardingPolicy(mesh, fsdp=True)`` equals the
  specs JAX's ``init_params`` returns under its FSDP policy, leaf for
  leaf, ``data`` entries included, for every attention family's smoke
  config (the port's one divergence, a pool the model axis does not
  divide whole over ``model``, does not arise at these shapes: ``ev6``'s
  6 slots divide 2 and 1);
* each rank's leaves from ``params_from_numpy`` are ``np.split`` of
  JAX's global leaf by JAX's FSDP spec, bit for bit, and
  ``init_params`` under the policy keeps leaves of the same shapes;
* an FSDP dim that the data extent does not divide raises ``ValueError``
  naming the leaf; ``decode_cache_rows`` gives the rank's rows of the
  dense cache over the cache-batch axes.

Across ``gloo`` ranks: ``Mesh.reduce_scatter`` and ``gather_fsdp``'s
adjoint give the rank's block of ``all_reduce``'s sum bit for bit; a
save from an FSDP (2, 2) training state (granite
smoke, fp32, capacity factor 8.0, so that (2, 2) and (4, 1) dispatch the
same math) restores on one process bit for bit as the ranks' ZeRO blocks
put together, JAX's ``CheckpointManager.restore`` reads it, and
``restore_sharded`` onto an FSDP (4, 1) mesh followed by 2 more steps
tracks 5 uninterrupted (2, 2) steps within the single-card train tests'
tolerances (loss 1e-5, grad norm 1e-4, the state 1e-4 relative in norm).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import MeshAt, ranks  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.sharding.policy import ShardingPolicy as JaxPolicy  # noqa: E402
from repro.sharding.policy import host_policy as jax_host_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.kernels.sharded import gather_fsdp  # noqa: E402
from repro_torch.models import init_decode_cache, init_params  # noqa: E402
from repro_torch.models.model import decode_cache_rows  # noqa: E402
from repro_torch.sharding import ShardingPolicy, param_specs  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    DataConfig,
    SyntheticTokenStream,
    init_train_state,
    make_train_step,
    train_state_specs,
)

torch.set_num_threads(1)

SHAPES = [(2, 2), (4, 1)]
IDS = ["2x2", "4x1"]
ATTENTION = [a for a, c in ARCHS.items() if c.family not in ("ssm", "hybrid")]
CASES = {a: (a, {}) for a in ATTENTION}
CASES["ev6"] = ("granite-moe-3b-a800m", dict(num_experts=6))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax(case, shape):
    """JAX's numpy params (host draw) and its FSDP specs over a stand-in
    mesh of ``shape``, both flattened by path."""
    arch, overrides = CASES[case]
    cfg = dataclasses.replace(jax_smoke(arch), **overrides)
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0), jax_host_policy(),
                                jnp.float32)
    _, specs = jax_init_params(
        cfg, jax.random.PRNGKey(0),
        JaxPolicy(mesh=MeshAt(shape, 0), fsdp=True), jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return tree, {k: tuple(v) for k, v in _flat(specs).items()}


def _cfg(case):
    arch, overrides = CASES[case]
    return dataclasses.replace(get_smoke_config(arch), **overrides)


def _split(arr, spec, shape, rank):
    """``np.split`` of a global leaf by a spec at one rank."""
    mesh = MeshAt(shape, rank)
    for dim, axes in enumerate(spec):
        if axes is not None:
            arr = np.split(arr, mesh.size(axes), axis=dim)[mesh.index(axes)]
    return arr


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_specs_are_jax_fsdp_specs(case, shape):
    tree, jspecs = _jax(case, shape)
    specs = _flat(param_specs(
        tree, ShardingPolicy(mesh=MeshAt(shape, 0), fsdp=True), _cfg(case)))
    assert specs.keys() == jspecs.keys()
    for path, jspec in jspecs.items():
        assert specs[path] == jspec, path
    assert any("data" in s for s in specs.values())


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("case", ["granite-moe-3b-a800m", "qwen3-32b", "ev6"])
def test_each_ranks_leaves_are_jax_leaves_split_by_fsdp_specs(case, shape):
    tree, jspecs = _jax(case, shape)
    cfg = _cfg(case)
    flat = _flat(tree)
    for rank in range(shape[0] * shape[1]):
        policy = ShardingPolicy(mesh=MeshAt(shape, rank), fsdp=True)
        mine = _flat(params_from_numpy(tree, cfg, "cpu", torch.float32,
                                       policy=policy))
        drawn = _flat(init_params(cfg, seed=0, device="cpu",
                                  dtype=torch.float32, policy=policy))
        assert mine.keys() == flat.keys() == drawn.keys()
        for path, arr in flat.items():
            want = _split(arr, jspecs[path], shape, rank)
            assert np.array_equal(mine[path].numpy(), want), (rank, path)
            assert tuple(drawn[path].shape) == want.shape, (rank, path)


def test_an_fsdp_dim_the_data_axis_does_not_divide_raises():
    """Three data ranks divide none of granite smoke's 64-wide ``d_model``:
    the conversion and the draw name the leaf."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    tree, _ = _jax("granite-moe-3b-a800m", (2, 2))
    policy = ShardingPolicy(mesh=MeshAt((3, 1), 0), fsdp=True)
    named = r"^(embed|blocks/attn/w[qkvo]|blocks/moe/w_\w+): dim \d of " \
        r"size 64 does not shard over 'data' \(3 ranks\)$"
    with pytest.raises(ValueError, match=named):
        params_from_numpy(tree, cfg, "cpu", torch.float32, policy=policy)
    with pytest.raises(ValueError, match=named):
        init_params(cfg, device="meta", dtype=torch.float32, policy=policy)


def test_cache_rows_follow_the_cache_batch_axes():
    """Replicated activations with the cache's rows over ``data``: a rank
    holds ``B/d`` rows of the cache and runs all ``B``; without
    ``cache_batch_axes`` the cache's rows are the batch's; none where
    the extent does not divide the rows."""
    cfg = get_smoke_config("granite-moe-3b-a800m")

    def rows(policy, batch):
        return decode_cache_rows(policy, batch)

    for rank in range(4):
        mesh = MeshAt((4, 1), rank)
        fsdp = ShardingPolicy(mesh=mesh, batch_axes=(),
                              cache_batch_axes=("data",), fsdp=True)
        assert rows(fsdp, 8) == slice(2 * rank, 2 * rank + 2)
        assert rows(fsdp, 6) is None
        assert rows(ShardingPolicy(mesh=mesh), 8) == rows(fsdp, 8)
        assert rows(ShardingPolicy(mesh=mesh, batch_axes=(),
                                   cache_batch_axes=()), 8) is None
        caches = init_decode_cache(cfg, 2, 32, device="meta", policy=fsdp)
        assert caches["attn"]["k"].shape[1] == 2
    assert rows(None, 8) is None


def _collectives(mesh):
    """Each rank's ``reduce_scatter`` of a tensor drawn per rank, and its
    block's gradient through ``gather_fsdp`` of a cotangent drawn per
    rank, over each axis and dim, in fp32 and bf16, each against its
    block of the fp32 ``all_reduce`` of the same tensors; and whether the
    gathered tensor holds the rank's block at its place."""
    out = {"reduce_scatter": {}, "gather_fsdp": {}}
    for axis in ("data", "model", ("data", "model")):
        n, i = mesh.size(axis), mesh.index(axis)
        for dim in (0, 1):
            for dtype in (torch.float32, torch.bfloat16):
                key = (str(axis), dim, str(dtype))
                g = torch.Generator().manual_seed(mesh.rank)
                t = torch.randn((4, 8, 3), generator=g).to(dtype)
                got = mesh.reduce_scatter(t, axis, dim, dtype=torch.float32)
                whole = mesh.all_reduce(t, axis, dtype=torch.float32)
                per = t.shape[dim] // n
                out["reduce_scatter"][key] = (
                    got.numpy(), whole.narrow(dim, i * per, per).numpy())
                block = t.narrow(dim, i * per, per).clone().requires_grad_()
                gathered = gather_fsdp(block, mesh, axis, dim)
                ct = torch.randn(gathered.shape, generator=g).to(dtype)
                gathered.backward(ct)
                want = mesh.all_reduce(ct, axis, dtype=torch.float32)
                out["gather_fsdp"][key] = (
                    tuple(gathered.shape),
                    torch.equal(gathered.detach().narrow(dim, i * per, per),
                                block.detach()),
                    block.grad.dtype == dtype, block.grad.float().numpy(),
                    want.narrow(dim, i * per, per).to(dtype).float().numpy())
    return out


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return ranks(_collectives, 2, 2, tmp_path_factory.mktemp("fsdp_coll"))


def test_reduce_scatter_is_the_all_reduce_block(collectives):
    """``Mesh.reduce_scatter`` (FSDP's adjoint) is the rank's block of
    ``all_reduce``'s sum, bit for bit: the same partials added in the
    same order."""
    for res in collectives:
        for key, (got, want) in res["reduce_scatter"].items():
            assert got.shape == want.shape, key
            assert np.array_equal(got, want), key


def test_gather_fsdp_adjoint_is_the_all_reduce_block(collectives):
    """``gather_fsdp`` puts the rank's block at its place of the whole,
    and its adjoint is the rank's block of every rank's cotangent summed
    in fp32 in rank order (``all_reduce``'s bits), in the block's
    dtype."""
    for res in collectives:
        for key, (shape, placed, dtype_kept, got, want) in (
                res["gather_fsdp"].items()):
            assert shape == (4, 8, 3) and placed and dtype_kept, key
            assert np.array_equal(got, want), key


# ------------------------------------------------------------ checkpoints
ARCH = "granite-moe-3b-a800m"
TRAIN_OVERRIDES = dict(capacity_factor=8.0)
SAVE_STEP, MORE = 3, 2
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=SAVE_STEP + MORE)


def _train_cfg():
    return dataclasses.replace(get_smoke_config(ARCH), **TRAIN_OVERRIDES)


def _train_inputs():
    cfg = _train_cfg()
    tree = state_to_numpy(init_params(cfg, seed=5, device="cpu",
                                      dtype=torch.float32))
    data = SyntheticTokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=16, global_batch=4,
                                           seed=3))
    return {"params": tree,
            "batches": [next(data) for _ in range(SAVE_STEP + MORE)]}


TRAIN = _train_inputs()


def _trainer(mesh):
    policy = ShardingPolicy(mesh=mesh, fsdp=True)
    cfg = _train_cfg()
    opt = AdamWConfig(**OPT)
    state = init_train_state(params_from_numpy(
        TRAIN["params"], cfg, "cpu", torch.float32, policy=policy), opt)
    step = make_train_step(cfg, opt, policy=policy)
    specs = train_state_specs(state, policy, cfg,
                              num_slots=cfg.num_virtual_experts)
    return state, step, specs


def _steps(step, state, lo, hi):
    metrics = []
    for batch in TRAIN["batches"][lo:hi]:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return state, metrics


def _save_rank(mesh, root):
    """FSDP (2, 2): 3 steps, the save from the mesh, 2 more steps."""
    state, step, specs = _trainer(mesh)
    state, metrics = _steps(step, state, 0, SAVE_STEP)
    saved = state_to_numpy(state)
    path = CheckpointManager(root).save(SAVE_STEP, state, mesh=mesh,
                                        shardings=specs,
                                        extra={"step": SAVE_STEP})
    state, more = _steps(step, state, SAVE_STEP, SAVE_STEP + MORE)
    return {"saved": saved, "path": path, "metrics": metrics + more,
            "final": state_to_numpy(state), "specs": specs}


def _resume_rank(mesh, root):
    """FSDP (4, 1): restore the (2, 2) save onto this mesh, 2 more steps."""
    skeleton, step, specs = _trainer(mesh)
    state, extra, at = CheckpointManager(root).restore_sharded(
        skeleton, specs, mesh=mesh)
    state, metrics = _steps(step, state, extra["step"], SAVE_STEP + MORE)
    return {"at": at, "metrics": metrics, "final": state_to_numpy(state),
            "specs": specs}


def _whole(rank_states, specs, shape):
    """The ranks' ZeRO blocks put back together by their specs."""
    flat = [_flat(s) for s in rank_states]
    fspecs = _flat(specs)
    out = {}
    for k, v in flat[0].items():
        spec = tuple(fspecs.get(k) or ())
        pad = spec + (None,) * (v.ndim - len(spec))
        size = [n * (1 if a is None else MeshAt(shape, 0).size(a))
                for n, a in zip(v.shape, pad)]
        whole = np.zeros(size, v.dtype)
        for rank, f in enumerate(flat):
            mesh = MeshAt(shape, rank)
            whole[tuple(slice(None) if a is None else
                        slice(mesh.index(a) * n, (mesh.index(a) + 1) * n)
                        for n, a in zip(f[k].shape, pad))] = f[k]
        out[k] = whole
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_fsdp_save")
    save = ranks(_save_rank, 2, 2, root, str(root / "ckpt"))
    resume = ranks(_resume_rank, 4, 1, root, str(root / "ckpt"))
    return root / "ckpt", save, resume


def test_fsdp_save_restores_on_one_process_bit_for_bit(saved):
    root, save, _ = saved
    assert all(r["path"] == save[0]["path"] for r in save)
    assert CheckpointManager(str(root)).committed_steps() == [SAVE_STEP]
    want = _whole([r["saved"] for r in save], save[0]["specs"], (2, 2))
    assert "data" in save[0]["specs"]["opt"]["mu"]["blocks"]["attn"]["wq"]
    skeleton = init_train_state(params_from_numpy(
        TRAIN["params"], _train_cfg(), "cpu", torch.float32),
        AdamWConfig(**OPT))
    state, extra, step = CheckpointManager(str(root)).restore(skeleton)
    assert (extra, step) == ({"step": SAVE_STEP}, SAVE_STEP)
    got = {k: v.numpy() for k, v in _flat(state).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def test_fsdp_save_is_read_by_jax(saved):
    root, save, _ = saved
    want = _whole([r["saved"] for r in save], save[0]["specs"], (2, 2))
    skeleton = {}
    for k, v in want.items():
        node = skeleton
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    state, extra, step = JaxCheckpointManager(str(root)).restore(skeleton)
    assert (extra, step) == ({"step": SAVE_STEP}, SAVE_STEP)
    got = _flat(jax.tree.map(np.asarray, state))
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


def test_fsdp_restore_onto_another_mesh_resumes_training(saved):
    _, save, resume = saved
    straight = save[0]["metrics"]
    final = _whole([r["final"] for r in save], save[0]["specs"], (2, 2))
    for rank, r in enumerate(resume):
        assert r["at"] == SAVE_STEP
        for (loss, norm), (want_loss, want_norm) in zip(
                r["metrics"], straight[SAVE_STEP:]):
            assert loss == pytest.approx(want_loss, rel=1e-5)
            assert norm == pytest.approx(want_norm, rel=1e-4)
        fspecs = _flat(r["specs"])
        for k, v in _flat(r["final"]).items():
            spec = fspecs.get(k) or ()
            w = _split(final[k], spec, (4, 1), rank)
            assert v.shape == w.shape, (rank, k)
            err = np.linalg.norm(v - w) / max(float(np.linalg.norm(w)), 1e-30)
            assert err <= 1e-4, (rank, k, err)
