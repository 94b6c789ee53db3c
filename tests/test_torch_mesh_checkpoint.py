"""``CheckpointManager.restore_sharded`` onto meshes of ``gloo`` ranks on
the CPU: a checkpoint written by the JAX package (granite's smoke params
in fp32 and bf16, unsharded as JAX stores them) restores onto (1, 4) and
(2, 2), each rank holding exactly its shard by the port's specs
(``sharding.param_specs``: the expert stacks' slots of its model rank,
the projections' and the vocabulary's blocks, everything else whole), bit
for bit; so does one written by the
single-card port. The restored shard serves: a decode-free check that
the sharded MoE layer on it gives the single-card layer's output at
(1, 4), bit for bit.

A checkpoint saved from a mesh (``CheckpointManager.save(…, mesh=…,
shardings=…)``): a (2, 2) training state after 3 steps (granite smoke,
fp32, 16 virtual experts, capacity factor 8.0 so that no assignment
drops and the dispatch groups of (2, 2) and (1, 4) are the same math)
restores on one process bit for bit as the ranks' shards put together,
JAX's ``CheckpointManager.restore`` reads it, and ``restore_sharded``
onto (1, 4) followed by 2 more steps tracks 5 uninterrupted (2, 2) steps
within the single-card train tests' tolerances (loss 1e-5, grad norm
1e-4, the state 1e-4 relative in norm; the two meshes sum in other
orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import MeshAt, rank_shard, ranks, spec_of  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.sharding import host_policy as jax_host_policy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.moe import moe_layer  # noqa: E402
from repro_torch.bridge import params_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    ShardingPolicy,
    local_expert_slots,
    param_specs,
)
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    DataConfig,
    SyntheticTokenStream,
    init_train_state,
    make_train_step,
    train_state_specs,
)

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"
OVERRIDES = dict(num_experts=8, expert_tp=2)  # 16 virtual experts
SHAPES = [(1, 4), (2, 2)]


def _cfg(get_config):
    return dataclasses.replace(get_config(ARCH), **OVERRIDES)


def _skeleton(tree, policy):
    """This rank's shapes and dtypes of the stored tree."""
    specs = param_specs(tree, policy, _cfg(get_smoke_config))

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k] if s else None) for k, v in t.items()}
        shape = list(t.shape)
        for dim, axes in enumerate(s or ()):
            if axes is not None:
                shape[dim] //= policy.mesh.size(axes)
        return torch.empty(shape, dtype=t.dtype)

    return walk(tree, specs), specs


def _flat_specs(shape, rank):
    """``param_specs`` of the 16-expert granite tree, flattened by path."""
    cfg = _cfg(get_smoke_config)
    tree = init_params(cfg, device="meta")
    specs = param_specs(tree, ShardingPolicy(mesh=MeshAt(shape, rank)), cfg)
    return _flat(specs)


def _shard_of(path, whole, shape, rank):
    """The rank's shard of a whole parameter (or moment, by its
    parameter's path) by the port's specs."""
    return rank_shard(whole, spec_of(_flat_specs(shape, rank), path), shape,
                      rank)


def _rank(mesh, root, tree_shapes):
    policy = ShardingPolicy(mesh=mesh)
    out = {}
    for name in ("jax_f32", "jax_bf16", "port"):
        skeleton, specs = _skeleton(tree_shapes[name], policy)
        state, extra, step = CheckpointManager(f"{root}/{name}").restore_sharded(
            skeleton, specs, mesh=mesh)
        out[name] = ({k: v.float().numpy() for k, v in _flat(state).items()},
                     extra, step)
    # the restored fp32 shard serves the layer
    cfg = _cfg(get_smoke_config)
    state, _, _ = CheckpointManager(f"{root}/jax_f32").restore_sharded(
        *_skeleton(tree_shapes["jax_f32"], policy), mesh=mesh)
    lp = {k: v[0] for k, v in state["blocks"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32))
    table = torch.arange(cfg.num_virtual_experts, dtype=torch.int32)
    out["layer"] = moe_layer(x, lp, table, cfg, policy,
                             num_slots=cfg.num_virtual_experts)[0].numpy()
    out["slots"] = local_expert_slots(policy, cfg.num_virtual_experts)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


class _Shapes:
    """A picklable stand-in for a stored leaf: its shape and dtype."""

    def __init__(self, t):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return _Shapes(tree)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_ckpt")
    jcfg = _cfg(jax_smoke)
    trees, shapes = {}, {}
    for name, dtype in (("jax_f32", jnp.float32), ("jax_bf16", jnp.bfloat16)):
        params, _ = jax_init_params(jcfg, jax.random.PRNGKey(4),
                                    jax_host_policy(), dtype)
        JaxCheckpointManager(str(root / name)).save(7, params,
                                                    extra={"who": "jax"})
        trees[name] = {k: np.asarray(v, np.float32) for k, v in
                       _flat(jax.tree.map(np.asarray, params)).items()}
        tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        shapes[name] = jax.tree.map(
            lambda a, d=tdtype: _Shapes(torch.empty(a.shape, dtype=d)), params)
    # the single-card port writes its own fp32 copy of the same params
    port_state = {k: torch.from_numpy(v.copy()) for k, v in trees["jax_f32"].items()}
    nested = {}
    for k, v in port_state.items():
        node = nested
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    CheckpointManager(str(root / "port")).save(9, nested, extra={"who": "port"})
    trees["port"] = trees["jax_f32"]
    shapes["port"] = _shapes(nested)
    port = {shape: ranks(_rank, *shape, root, str(root), shapes)
            for shape in SHAPES}
    return port, trees


@pytest.mark.parametrize("name", ["jax_f32", "jax_bf16", "port"])
@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_restore_sharded_keeps_each_ranks_shard(results, shape, name):
    port, trees = results
    data, model = shape
    Ev = 16
    for rank, res in enumerate(port[shape]):
        got, extra, step = res[name]
        assert extra == {"who": "port" if name == "port" else "jax"}
        assert step == (9 if name == "port" else 7)
        per = Ev // model
        mine = slice(rank % model * per, (rank % model + 1) * per)
        assert res["slots"] == mine
        assert got.keys() == trees[name].keys()
        for k, want in trees[name].items():
            want = _shard_of(k, want, shape, rank)
            if name == "jax_bf16":  # the stored bf16 bits, as fp32
                want = torch.from_numpy(want).bfloat16().float().numpy()
            assert np.array_equal(got[k], want), k


def test_restored_shard_serves_the_single_card_layer(results):
    port, trees = results
    cfg = _cfg(get_smoke_config)
    lp = {k.split("/")[-1]: torch.from_numpy(v[0].copy()) for k, v in
          trees["jax_f32"].items() if k.startswith("blocks/moe/")}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32))
    table = torch.arange(cfg.num_virtual_experts, dtype=torch.int32)
    want = moe_layer(x, lp, table, cfg)[0].numpy()
    for res in port[(1, 4)]:
        assert np.array_equal(res["layer"], want)
    for res in port[(2, 2)]:  # two dispatch groups: every rank alike
        assert res["layer"].shape == want.shape
        np.testing.assert_array_equal(res["layer"], port[(2, 2)][0]["layer"])


# ------------------------------------------------------ a save from a mesh
SAVE_STEP, MORE = 3, 2
TRAIN_OVERRIDES = dict(OVERRIDES, capacity_factor=8.0)
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=SAVE_STEP + MORE)


def _train_inputs():
    cfg = dataclasses.replace(get_smoke_config(ARCH), **TRAIN_OVERRIDES)
    tree = state_to_numpy(init_params(cfg, seed=5, device="cpu",
                                      dtype=torch.float32))
    Ev = cfg.num_virtual_experts
    rng = np.random.default_rng(12)
    s2e = np.stack([rng.permutation(Ev) for _ in range(cfg.num_layers)])
    tree["blocks"]["moe"] = {
        k: (v if k == "router" else np.take_along_axis(
            v, s2e[:, :, None, None], axis=1))
        for k, v in tree["blocks"]["moe"].items()}
    data = SyntheticTokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=16, global_batch=4,
                                           seed=3))
    return {"params": tree, "e2s": np.argsort(s2e, axis=1).astype(np.int32),
            "batches": [next(data) for _ in range(SAVE_STEP + MORE)]}


TRAIN = _train_inputs()


def _trainer(mesh):
    policy = ShardingPolicy(mesh=mesh)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **TRAIN_OVERRIDES)
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
                                for k, v in batch.items()},
                        torch.from_numpy(TRAIN["e2s"]))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return state, metrics


def _save_rank(mesh, root):
    """(2, 2): 3 steps, the save from the mesh, 2 more steps."""
    state, step, specs = _trainer(mesh)
    state, metrics = _steps(step, state, 0, SAVE_STEP)
    saved = state_to_numpy(state)
    path = CheckpointManager(root).save(SAVE_STEP, state, mesh=mesh,
                                        shardings=specs,
                                        extra={"step": SAVE_STEP})
    state, more = _steps(step, state, SAVE_STEP, SAVE_STEP + MORE)
    return {"saved": saved, "path": path, "metrics": metrics + more,
            "final": state_to_numpy(state)}


def _resume_rank(mesh, root):
    """(1, 4): restore the (2, 2) save onto this mesh, 2 more steps."""
    skeleton, step, specs = _trainer(mesh)
    state, extra, at = CheckpointManager(root).restore_sharded(
        skeleton, specs, mesh=mesh)
    state, metrics = _steps(step, state, extra["step"], SAVE_STEP + MORE)
    return {"at": at, "metrics": metrics, "final": state_to_numpy(state)}


def _gathered(rank_states, shape):
    """The ranks' shards put back together by the port's specs: a leaf
    sharded over ``model`` from the model ranks of data row 0 along its
    sharded dim, every other leaf from rank 0."""
    data, model = shape
    flat = [_flat(s) for s in rank_states]
    specs = _flat_specs(shape, 0)
    out = {}
    for k, v in flat[0].items():
        spec = spec_of(specs, k) or ()
        if "model" in spec:
            v = np.concatenate([flat[m][k] for m in range(model)],
                               axis=spec.index("model"))
        out[k] = v
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_save")
    save = ranks(_save_rank, 2, 2, root, str(root / "ckpt"))
    resume = ranks(_resume_rank, 1, 4, root, str(root / "ckpt"))
    return root / "ckpt", save, resume


def test_mesh_save_restores_on_one_process_bit_for_bit(saved):
    root, save, _ = saved
    assert all(r["path"] == save[0]["path"] for r in save)
    assert CheckpointManager(str(root)).committed_steps() == [SAVE_STEP]
    want = _gathered([r["saved"] for r in save], (2, 2))
    # the second data row held the same shards as the first
    for r, twin in ((save[2], save[0]), (save[3], save[1])):
        for k, v in _flat(r["saved"]).items():
            assert np.array_equal(v, _flat(twin["saved"])[k]), k
    cfg = dataclasses.replace(get_smoke_config(ARCH), **TRAIN_OVERRIDES)
    skeleton = init_train_state(params_from_numpy(
        TRAIN["params"], cfg, "cpu", torch.float32), AdamWConfig(**OPT))
    state, extra, step = CheckpointManager(str(root)).restore(skeleton)
    assert (extra, step) == ({"step": SAVE_STEP}, SAVE_STEP)
    got = {k: v.numpy() for k, v in _flat(state).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    assert got["params/blocks/moe/w_gate"].shape[1] == 16  # the whole pool


def test_mesh_save_is_read_by_jax(saved):
    root, save, _ = saved
    want = _gathered([r["saved"] for r in save], (2, 2))
    skeleton = _nest(want)
    state, extra, step = JaxCheckpointManager(str(root)).restore(skeleton)
    assert (extra, step) == ({"step": SAVE_STEP}, SAVE_STEP)
    got = _flat(jax.tree.map(np.asarray, state))
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_restore_sharded_onto_another_mesh_resumes_training(saved):
    _, save, resume = saved
    straight = save[0]["metrics"]
    final = _gathered([r["final"] for r in save], (2, 2))
    for rank, r in enumerate(resume):
        assert r["at"] == SAVE_STEP
        for (loss, norm), (want_loss, want_norm) in zip(
                r["metrics"], straight[SAVE_STEP:]):
            assert loss == pytest.approx(want_loss, rel=1e-5)
            assert norm == pytest.approx(want_norm, rel=1e-4)
        for k, v in _flat(r["final"]).items():
            w = _shard_of(k, final[k], (1, 4), rank)
            err = np.linalg.norm(v - w) / max(float(np.linalg.norm(w)), 1e-30)
            assert err <= 1e-4, (rank, k, err)
