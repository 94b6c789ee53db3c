"""The capacity-free oracle (``moe_backend="dense_ref"``) on the port's
paths against the JAX package's, on smoke configs under non-identity
placements (fp32, CPU: the plain kernel versions on the port's side).

* The layer: ``moe_layer(..., backend="dense_ref")`` and a config whose
  ``moe_backend`` is ``"dense_ref"`` against JAX's ``moe_layer(...,
  backend="dense_ref")`` at capacity factor 0.5, where the staged plane
  drops: ``y`` within ``rtol=1e-5, atol=1e-5``, counts equal, no drop,
  overflow or shed, a zero ``shed_delta``; the same bits under any
  placement; unknown names refused as JAX refuses them.
* A replicated (E_v, P) pool gives the single-copy layer's bits, as
  ``tests/test_replication.py`` holds JAX's.
* The engine at ``tests/test_torch_engine.py``'s knobs with
  ``EngineConfig(moe_backend="dense_ref")`` gives the JAX engine's tokens
  in both decode modes, where the staged engine drops; an online run with
  migrations gives JAX's tokens and those of the identity layout's run.
  The captured step holds no host sync.
* ``ModelConfig.active_param_count`` equals JAX's on all ten configs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.online as jonline  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.online as tonline  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from test_torch_bridge import placed_params, smoke_configs  # noqa: E402
from test_torch_graph import NoHostSync  # noqa: E402
from test_torch_online import _knobs, _profiles, _serve  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.moe import moe_layer as jax_moe_layer  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    MOE_BACKENDS,
    get_config,
    get_smoke_config,
)
from repro_torch.models.moe import (  # noqa: E402
    apply_placement,
    identity_placement,
    moe_layer,
    resolve_moe_backend,
)
from repro_torch.replication import ReplicatedPlacement  # noqa: E402

torch.set_num_threads(1)

CF = 0.5  # the staged plane drops at this capacity


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


@pytest.fixture(scope="module", params=[1, 2], ids=["tp1", "tp2"])
def setup(request):
    jcfg, tcfg = smoke_configs(expert_tp=request.param)
    jparams, tparams, e2s = placed_params(jcfg, tcfg, seed=request.param)
    x = np.random.default_rng(3).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    return (jcfg, tcfg, _layer0(jparams["blocks"]["moe"]),
            _layer0(tparams["blocks"]["moe"]), e2s[0], x)


def _zero_aux(aux, num_slots):
    assert float(aux.dropped) == 0.0 and aux.dropped.dtype == torch.float32
    for f in ("dropped_tokens", "overflow_tokens", "shed_tokens"):
        assert int(getattr(aux, f)) == 0, f
    assert torch.equal(aux.shed_delta,
                       torch.zeros(num_slots, dtype=torch.int32))


@pytest.mark.parametrize("via", ["argument", "config"])
def test_layer_matches_jax(setup, via):
    jcfg, tcfg, jp, tp, e2s, x = setup
    yj, auxj = jax_moe_layer(jnp.asarray(x), jp, jnp.asarray(e2s), jcfg,
                             host_policy(), capacity_factor=CF,
                             backend="dense_ref")
    if via == "argument":
        yt, auxt = moe_layer(torch.from_numpy(x), tp, torch.from_numpy(e2s),
                             tcfg, capacity_factor=CF, backend="dense_ref")
    else:
        yt, auxt = moe_layer(
            torch.from_numpy(x), tp, torch.from_numpy(e2s),
            dataclasses.replace(tcfg, moe_backend="dense_ref"),
            capacity_factor=CF)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(auxt.expert_counts.numpy(),
                                  np.asarray(auxj["expert_counts"]))
    np.testing.assert_allclose(float(auxt.aux_loss), float(auxj["aux_loss"]),
                               rtol=1e-5)
    for f in ("dropped_tokens", "overflow_tokens", "shed_tokens",
              "shed_delta"):
        np.testing.assert_array_equal(getattr(auxt, f).numpy(),
                                      np.asarray(auxj[f]), err_msg=f)
    _zero_aux(auxt, tcfg.num_virtual_experts)
    # the staged plane drops at this capacity: the oracle is what it costs
    _, staged = moe_layer(torch.from_numpy(x), tp, torch.from_numpy(e2s),
                          tcfg, capacity_factor=CF)
    assert int(staged.dropped_tokens) > 0


def test_layer_is_placement_invariant(setup):
    jcfg, tcfg, jp, tp, e2s, x = setup
    s2e = np.argsort(e2s)  # the placed pool back in virtual order
    tp_id = dict(tp, **{n: tp[n][torch.from_numpy(np.argsort(s2e))]
                        for n in ("w_gate", "w_up", "w_down")})
    xt = torch.from_numpy(x)
    y_id, _ = moe_layer(xt, tp_id, identity_placement(tcfg, 1)[0], tcfg,
                        backend="dense_ref")
    y_pl, _ = moe_layer(xt, tp, torch.from_numpy(e2s), tcfg,
                        backend="dense_ref")
    assert torch.equal(y_id, y_pl)


def test_unknown_backend_is_refused(setup):
    _, tcfg, _, tp, e2s, x = setup
    with pytest.raises(ValueError, match="moe_backend"):
        moe_layer(torch.from_numpy(x), tp, torch.from_numpy(e2s), tcfg,
                  backend="triton")
    with pytest.raises(ValueError, match="moe_backend"):
        dataclasses.replace(tcfg, moe_backend="triton")
    with pytest.raises(ValueError, match="moe_backend"):
        resolve_moe_backend("cutlass", tcfg)
    assert resolve_moe_backend(None, dataclasses.replace(
        tcfg, moe_backend="dense_ref")) == "dense_ref"
    assert resolve_moe_backend("pallas", tcfg) == "pallas"
    assert MOE_BACKENDS == ("einsum", "pallas", "dense_ref")


def test_replicated_pool_gives_the_single_copy_bits(setup):
    """One replica slot on each of 4 devices, an (E_v, 8) split table: the
    oracle reads each expert's first copy, whose rows are the single-copy
    pool's, so the output is bit-equal."""
    _, tcfg, _, tp, e2s, x = setup
    Ev = tcfg.num_virtual_experts
    s2e = np.argsort(e2s)
    virt = {n: tp[n][torch.from_numpy(np.argsort(s2e))]
            for n in ("w_gate", "w_up", "w_down")}
    rp = ReplicatedPlacement.linear(Ev, 4, 1)
    rep = {n: v[0] for n, v in apply_placement(
        {n: w[None] for n, w in virt.items()},
        torch.from_numpy(rp.slot_to_expert[None])).items()}
    rep["router"] = tp["router"]
    xt = torch.from_numpy(x)
    y1, aux1 = moe_layer(xt, dict(virt, router=tp["router"]),
                         identity_placement(tcfg, 1)[0], tcfg,
                         backend="dense_ref")
    y2, aux2 = moe_layer(xt, rep, torch.from_numpy(rp.replica_table(8)),
                         tcfg, backend="dense_ref")
    assert rep["w_gate"].shape[0] == Ev + 4
    assert torch.equal(y1, y2)
    assert torch.equal(aux1.expert_counts, aux2.expert_counts)
    _zero_aux(aux2, Ev + 4)


# ----------------------------------------------------------------- engine
KNOBS = dict(max_batch=3, max_len=40, other_time_per_step=1e-3,
             prefill_chunk=4, prefill_time_per_token=1e-4)


def _requests(vocab):
    rng = np.random.default_rng(21)
    lengths = [6, 9, 13, 6, 9]  # few distinct lengths: few JAX prefill traces
    return [rng.integers(0, vocab, size=n) for n in lengths], [8, 5, 10, 7, 6]


def _dropped(eng):
    """Wrap the engine's control-plane step to sum every step's drops."""
    seen = []
    inner = eng._moe_step

    def step(moe_aux, sim_latency):
        seen.append(int(moe_aux.dropped_tokens.sum()))
        return inner(moe_aux, sim_latency)

    eng._moe_step = step
    return seen


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's in both modes with the oracle, and
    the port's staged engine, on one set of weights under a placement, at
    capacity factors 0.5 (prefill and decode)."""
    jcfg, tcfg = smoke_configs(expert_tp=2, capacity_factor=CF,
                               decode_capacity_factor=CF)
    jparams, tparams, e2s = placed_params(jcfg, tcfg, seed=5)
    prompts, news = _requests(jcfg.vocab_size)
    jeng = jserving.ServingEngine(
        jparams, jcfg, host_policy(),
        jserving.EngineConfig(**KNOBS, moe_backend="dense_ref",
                              kv=jserving.PagedKVConfig(block_size=4)),
        profile=None)
    jeng.placements = jnp.asarray(e2s)
    jeng.serve(jserving.batch_arrivals(prompts, news))
    out = {"jax": jeng}
    for name, mode, backend in (("scan", "scan", "dense_ref"),
                                ("python", "python", "dense_ref"),
                                ("staged", "scan", None)):
        eng = tserving.ServingEngine(
            tparams, tcfg,
            tserving.EngineConfig(**KNOBS, moe_backend=backend,
                                  decode_mode=mode,
                                  kv=tserving.PagedKVConfig(block_size=4)),
            device="cpu")
        eng.placements = torch.from_numpy(e2s)
        eng.dropped = _dropped(eng)
        eng.serve(tserving.batch_arrivals(prompts, news))
        out[name] = eng
    return out


def _tokens(eng):
    return {r.uid: list(r.generated) for r in eng.finished}


@pytest.mark.parametrize("mode", ["scan", "python"])
def test_engine_tokens_match_jax(engines, mode):
    jeng, teng = engines["jax"], engines[mode]
    assert teng.config.moe_backend == "dense_ref"
    assert len(teng.finished) == 5
    assert _tokens(teng) == _tokens(jeng)
    assert teng.step_count == jeng.step_count
    assert teng.sim_step_latencies == pytest.approx(jeng.sim_step_latencies)
    assert int(teng.expert_counts.sum()) == 2 * 3 * 2  # L · max_batch · k
    assert teng.dropped and not any(teng.dropped)
    assert teng.graph_capture_counts == {
        "decode": int(mode == "scan"), "prefill": 0, "migrate": 0}
    # the staged engine at the same knobs drops, and so decodes otherwise
    assert engines["staged"].config.moe_backend == "einsum"
    assert sum(engines["staged"].dropped) > 0


def test_the_captured_oracle_step_holds_no_host_sync(engines):
    eng = engines["scan"]
    graph = eng.decode_graph
    cur_len = np.array([5, 9, 0], np.int32)
    tables = np.zeros((3, graph.n_max), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :3] = [3, 4, 5]
    with NoHostSync():
        logits, _, aux = eng._decode(
            eng.params, eng.caches, cur_len, np.array([[3], [7], [0]]),
            eng.config, eng.placements, block_tables=tables)
    assert bool(torch.isfinite(logits[:, :eng.config.vocab_size]).all())
    assert int(aux.dropped_tokens.sum()) == 0
    assert graph.builds == 1


# ----------------------------------------------------------------- online
def test_online_oracle_matches_jax_and_the_identity_run():
    """fig23's burst/gem-online scenario (``tests/test_torch_online.py``)
    under the oracle: the JAX engine, the port's (``"scan"``) with its
    drift replans and migration batches, and the port's ``linear`` run
    without the online plane (which installs the identity layout) give
    the same tokens."""
    jcfg, tcfg = smoke_configs(expert_tp=2, decode_capacity_factor=4.0)
    jparams, tparams, _ = placed_params(jcfg, tcfg, seed=3)
    kv = dict(block_size=4, num_blocks=40, watermark_blocks=1)
    jeng = _serve(jonline, jserving.ServingEngine(
        jparams, jcfg, host_policy(),
        jserving.EngineConfig(**_knobs(jcore, jonline, "scan"),
                              moe_backend="dense_ref",
                              kv=jserving.PagedKVConfig(**kv)),
        profile=_profiles(jcore)[0], num_devices=4), jcfg.vocab_size)
    runs = {}
    for name, extra in (("online", {}),
                        ("fixed", dict(online=False,
                                       placement_policy="linear"))):
        knobs = dict(_knobs(tcore, tonline, "scan"), **extra)
        params = {k: v for k, v in tparams.items()}
        params["blocks"] = dict(tparams["blocks"])
        params["blocks"]["moe"] = {k: v.clone() for k, v in
                                   tparams["blocks"]["moe"].items()}
        runs[name] = _serve(tonline, tserving.ServingEngine(
            params, tcfg,
            tserving.EngineConfig(**knobs, moe_backend="dense_ref",
                                  kv=tserving.PagedKVConfig(**kv)),
            profile=_profiles(tcore)[0], num_devices=4, device="cpu"),
            tcfg.vocab_size)
    teng = runs["online"]
    assert _tokens(teng) == _tokens(jeng) == _tokens(runs["fixed"])
    assert teng.migration_records == jeng.migration_records
    assert len(teng.migration_records) >= 2
    assert teng.controller.replans == jeng.controller.replans
    fixed = runs["fixed"]
    assert fixed.controller is None and fixed.placement_applied
    assert torch.equal(fixed.placements,
                       identity_placement(tcfg, tcfg.num_layers))
    assert not torch.equal(teng.placements, fixed.placements)


# ----------------------------------------------------------------- A1
@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_active_param_count_equals_jax(arch, which):
    if which == "full":
        ours, ref = get_config(arch), jax_get_config(arch)
    else:
        ours, ref = get_smoke_config(arch), jax_smoke(arch)
    assert ours.active_param_count() == ref.active_param_count()
    assert ours.param_count() == ref.param_count()
    if ours.is_moe:
        assert ours.active_param_count() < ours.param_count()
    else:
        assert ours.active_param_count() == ours.param_count()
