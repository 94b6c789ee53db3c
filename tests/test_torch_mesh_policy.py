"""The port's ``ShardingPolicy`` and ``policy_for`` against JAX's, in this
process, over a stub mesh that has only ``shape`` and ``axis_names`` (no
device is touched on either side): every field, property and spec method,
for every config and step kind, on the (1, 4), (2, 2), (2, 4) and
(16, 16) meshes and the multi-pod (2, 16, 16). JAX's specs are
``PartitionSpec``s, the port's plain tuples of the same entries."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch.mesh import policy_for as jax_policy_for  # noqa: E402
from repro.sharding.policy import ShardingPolicy as JaxPolicy  # noqa: E402
from repro.sharding.policy import host_policy as jax_host_policy  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.mesh import policy_for  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    ShardingPolicy,
    host_policy,
    local_expert_slots,
    param_specs,
    take_shard,
)


@dataclasses.dataclass
class StubMesh:
    shape: dict
    axis_names: tuple


MESHES = {
    "1x4": {"data": 1, "model": 4},
    "2x2": {"data": 2, "model": 2},
    "2x4": {"data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
}
STEP_KINDS = ("train", "prefill", "decode")
GLOBAL_BATCHES = (None, 1, 2, 8, 64)
PROPS = ("batch", "cache_batch", "kv_seq", "data_axis_size",
         "all_data_axes", "model_axis_size")


def _stub(name):
    shape = MESHES[name]
    return StubMesh(dict(shape), tuple(shape))


def _same_policy(tp, jp):
    """Every field, property and spec method answers alike."""
    for f in ("batch_axes", "model_axis", "kv_seq_axes", "fsdp",
              "cache_batch_axes"):
        assert getattr(tp, f) == getattr(jp, f), f
    for prop in PROPS:
        assert getattr(tp, prop) == getattr(jp, prop), prop
    for stacked in (True, False):
        assert tp.w_col(stacked) == tuple(jp.w_col(stacked))
        assert tp.w_row(stacked) == tuple(jp.w_row(stacked))
        assert tp.w_vector(stacked) == tuple(jp.w_vector(stacked))
        for tail in (2, 3):
            assert tp.w_expert(tail, stacked) == tuple(jp.w_expert(tail, stacked))
    for ndim in (1, 3):
        assert tp.w_replicated(ndim) == tuple(jp.w_replicated(ndim))
    assert tp.embed_tied() == tuple(jp.embed_tied())
    assert tp.embed_untied() == tuple(jp.embed_untied())
    assert tp.lm_head() == tuple(jp.lm_head())
    assert tp.spec(None, "model", ("pod", "data")) == tuple(
        jp.spec(None, "model", ("pod", "data")))
    for Ev in (4, 6, 8, 16, 20, 80, 84):
        assert tp.expert_collective_axis(Ev) == jp.expert_collective_axis(Ev)
        assert tp.moe_expert_pad(Ev) == jp.moe_expert_pad(Ev)
        for Gd in (1, 2, 16, 32):
            assert tp.moe_shard_spec(Gd, Ev) == jp.moe_shard_spec(Gd, Ev)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_policy_for_matches_jax(arch, mesh):
    """``policy_for`` makes JAX's decisions for each step kind and global
    batch (FSDP at inference for the huge configs, the replicated-batch
    long-context decode), and the policies answer alike."""
    stub = _stub(mesh)
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    for kind in STEP_KINDS:
        for gb in GLOBAL_BATCHES:
            for c, jc in ((cfg, jcfg), (None, None)):
                tp = policy_for(stub, step_kind=kind, global_batch=gb, config=c)
                jp = jax_policy_for(stub, step_kind=kind, global_batch=gb,
                                    config=jc)
                assert tp.mesh is stub
                _same_policy(tp, jp)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_default_policy_matches_jax(mesh):
    stub = _stub(mesh)
    batch_axes = ("pod", "data") if "pod" in stub.shape else ("data",)
    for fsdp in (False, True):
        _same_policy(ShardingPolicy(mesh=stub, batch_axes=batch_axes, fsdp=fsdp),
                     JaxPolicy(mesh=stub, batch_axes=batch_axes, fsdp=fsdp))
    _same_policy(ShardingPolicy(mesh=stub, batch_axes=()),
                 JaxPolicy(mesh=stub, batch_axes=()))


def test_host_policy_matches_jax_and_constrain_is_the_identity():
    tp, jp = host_policy(), jax_host_policy()
    _same_policy(tp, jp)
    assert tp.named("model") is None and jp.named("model") is None
    assert tp.moe_shard_spec(4, 8) == (None, None)
    x = torch.arange(6.0).reshape(1, 2, 3)
    stub_policy = ShardingPolicy(mesh=_stub("2x2"))
    for pol in (tp, stub_policy):
        for fn in (pol.act_bsd, pol.act_seq_sharded, pol.act_ff_sharded,
                   pol.act_vocab_sharded):
            assert fn(x) is x
        assert pol.constrain(x, "data", None, "model") is x
        assert pol.kv_cache(x) is x
    assert stub_policy.named(None, "model") == (None, "model")


@pytest.mark.parametrize("mesh", ["1x4", "2x2", "2x4"])
def test_port_shard_helpers(mesh):
    """What the port honours: the expert pool's slot dim over ``model``
    where the axis divides it, the vocabulary of a tied embedding over
    ``model``, every whole leaf a spec of Nones; without a mesh, None."""

    class Placed(StubMesh):
        def index(self, axis):
            return {"data": 1, "model": 1}[axis] % self.shape[axis]

    shape = MESHES[mesh]
    pol = ShardingPolicy(mesh=Placed(dict(shape), tuple(shape)))
    m = shape["model"]
    assert local_expert_slots(pol, 8 * m) == slice((1 % m) * 8,
                                                   (1 % m) * 8 + 8)
    assert local_expert_slots(pol, 4 * m + 1) is None
    assert local_expert_slots(host_policy(), 8) is None
    params = {"embed": torch.zeros(8, 4),
              "blocks": {"moe": {"router": torch.zeros(2, 4, 4),
                                 "w_gate": torch.zeros(2, 4 * m, 4, 3)},
                         "ln1": torch.zeros(2, 4)}}
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("granite-moe-3b-a800m")  # tied, attention blocks
    specs = param_specs(params, pol, cfg)
    assert specs == {"embed": ("model", None),
                     "blocks": {"moe": {"router": (None, None, None),
                                        "w_gate": (None, "model", None, None)},
                                "ln1": (None, None)}}
    assert param_specs(params, host_policy(), cfg)["blocks"]["moe"]["w_gate"] is None


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x7b"])
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_init_params_keeps_the_ranks_slots_of_one_draw(arch, mesh):
    """``init_params`` under a policy that shards the pool: each model
    rank's expert stacks are its slots ``[d·S/m, (d+1)·S/m)`` of the
    one-device draw with the same seed, every other leaf its shard of the
    one-device draw by ``param_specs`` (fp32 on the CPU, where the
    layer-at-a-time draw gives the whole draw's values); a pool the axis
    does not divide is whole."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params

    cfg = get_smoke_config(arch)
    shape = MESHES[mesh]
    m, Ev = shape["model"], cfg.num_virtual_experts
    whole = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    for d in range(m):
        class Placed(StubMesh):
            def index(self, axis):
                return {"data": 0, "model": d}[axis]

            def size(self, axis):
                return self.shape[axis]

        pol = ShardingPolicy(mesh=Placed(dict(shape), tuple(shape)))
        mine = init_params(cfg, seed=3, device="cpu", dtype=torch.float32,
                           policy=pol)
        rows = local_expert_slots(pol, Ev)
        assert (rows is None) == (Ev % m != 0)
        for name in ("w_gate", "w_up", "w_down"):
            want = whole["blocks"]["moe"][name]
            got = mine["blocks"]["moe"][name]
            assert torch.equal(got, want if rows is None else want[:, rows])
        assert torch.equal(mine["final_norm"], whole["final_norm"])
        assert torch.equal(mine["blocks"]["moe"]["router"],
                           whole["blocks"]["moe"]["router"])
        specs = param_specs(whole, pol, cfg)
        for key, want in (("embed", whole["embed"]),
                          ("wq", whole["blocks"]["attn"]["wq"]),
                          ("wo", whole["blocks"]["attn"]["wo"])):
            got = (mine["embed"] if key == "embed"
                   else mine["blocks"]["attn"][key])
            spec = (specs["embed"] if key == "embed"
                    else specs["blocks"]["attn"][key])
            assert torch.equal(got, take_shard(want, spec, pol.mesh)), key
