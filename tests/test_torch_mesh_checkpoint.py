"""``CheckpointManager.restore_sharded`` onto meshes of ``gloo`` ranks on
the CPU: a checkpoint written by the JAX package (granite's smoke params
in fp32 and bf16, unsharded as JAX stores them) restores onto (1, 4) and
(2, 2), each rank holding exactly its shard by the port's specs
(``sharding.param_specs``: the expert stacks' slots of its model rank,
everything else whole), bit for bit; so does one written by the
single-card port. The restored shard serves: a decode-free check that
the sharded MoE layer on it gives the single-card layer's output at
(1, 4), bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import ranks  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.sharding import host_policy as jax_host_policy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.moe import moe_layer  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    ShardingPolicy,
    local_expert_slots,
    param_specs,
)

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"
OVERRIDES = dict(num_experts=8, expert_tp=2)  # 16 virtual experts
SHAPES = [(1, 4), (2, 2)]


def _cfg(get_config):
    return dataclasses.replace(get_config(ARCH), **OVERRIDES)


def _skeleton(tree, policy):
    """This rank's shapes and dtypes of the stored tree."""
    specs = param_specs(tree, policy)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k] if s else None) for k, v in t.items()}
        shape = list(t.shape)
        if s is not None:
            shape[1] //= policy.model_axis_size
        return torch.empty(shape, dtype=t.dtype)

    return walk(tree, specs), specs


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
            if k.split("/")[-1] in ("w_gate", "w_up", "w_down"):
                want = want[:, mine]
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
