"""The dense KV cache and sliding-window attention of the port against the
JAX package, at smoke size with fp32 weights from the JAX ``init_params``
(through ``params_from_numpy``).

* ``attention_train`` with a window (mixtral smoke: window 32) at S = 80,
  against JAX's chunked gather with 16-row and whole-row query chunks;
* ``attention_decode`` stepped from ``cur_len`` 28 to 70 on the 32-entry
  ring: outputs and the ring's contents, across two wraps;
* the engine: ``kv_mode`` resolution and its errors, a prompt longer than
  the ring, a ragged dense batch (one shared length, the longest row's),
  paged ≡ dense tokens, every smoke config under ``kv_mode="auto"``, and
  fig25's live engine as written (mixtral smoke with its window,
  ``max_len`` 128, replication, shedding and the online plane): tokens
  and per-step enable / dropped / shed / overflow counts.

The JAX engines run ``"scan"`` (their default) except zamba2's, held
against JAX ``"python"`` (its reference modes disagree); the port runs
both of its modes. Tolerances: attention outputs and caches within
rtol = atol = 1e-5 (fp32); tokens and counts equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.online as jonline  # noqa: E402
import repro.replication as jrep  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.online as tonline  # noqa: E402
import repro_torch.replication as trep  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from test_torch_bridge import placement, smoke_configs  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.attention import AttnCache  # noqa: E402
from repro.models.attention import attention_decode as jax_attention_decode  # noqa: E402
from repro.models.attention import attention_train as jax_attention_train  # noqa: E402
from repro.models.moe import apply_placement as jax_apply_placement  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.attention import attention_decode, attention_train  # noqa: E402

torch.set_num_threads(1)

ARCH = "mixtral-8x7b"
TOL = dict(rtol=1e-5, atol=1e-5)
PACKAGES = {
    "jax": (jcore, jonline, jrep, jserving),
    "port": (tcore, tonline, trep, tserving),
}


def _params(jcfg, tcfg, *, seed=0, placed=True, zero_router=False):
    """JAX fp32 params (MoE: a non-identity placement unless ``placed`` is
    False, the router zeroed on request), the port's copy, and the
    expert→slot tables (None when not placed)."""
    params, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed), host_policy(),
                                jnp.float32)
    e2s = None
    if jcfg.is_moe:
        moe = dict(params["blocks"]["moe"])
        if zero_router:  # tied logits: every token's top-2 is experts 0, 1
            moe["router"] = jnp.zeros_like(moe["router"])
        if placed:
            s2e, e2s = placement(jcfg.num_layers,
                                 jcfg.num_experts * jcfg.expert_tp,
                                 seed=seed + 11)
            moe = jax_apply_placement(moe, jnp.asarray(s2e))
        params = {**params, "blocks": {**params["blocks"], "moe": moe}}
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return params, tparams, e2s


def _layer0(jparams, tparams):
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"]["attn"])
    tp = {k: v[0] for k, v in tparams["blocks"]["attn"].items()}
    return jp, tp


@pytest.mark.parametrize("q_chunk", [16, 512])
def test_sliding_window_prefill_matches_jax(q_chunk):
    jcfg, tcfg = smoke_configs(ARCH)
    assert tcfg.sliding_window == 32
    jparams, tparams, _ = _params(jcfg, tcfg, placed=False)
    jp, tp = _layer0(jparams, tparams)
    x = np.random.default_rng(3).standard_normal((2, 80, jcfg.d_model))
    x = x.astype(np.float32)
    jy, jc = jax_attention_train(jnp.asarray(x), jp, jcfg, host_policy(),
                                 q_chunk=q_chunk, return_cache=True)
    ty, (k, v) = attention_train(torch.from_numpy(x), tp, tcfg,
                                 return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jc.v), **TOL)
    # the window matters: full causal attention gives other numbers
    full, _ = attention_train(torch.from_numpy(x), tp,
                              dataclasses.replace(tcfg, sliding_window=0))
    assert not torch.allclose(full, ty, rtol=1e-3, atol=1e-3)


def test_ring_decode_matches_jax_across_two_wraps():
    """Prefill 28 tokens into the 32-entry ring (max_len 128, window 32),
    then decode from cur_len 28 to 70: the write index wraps at 32 and 64.
    Outputs and the ring's contents are compared every step."""
    jcfg, tcfg = smoke_configs(ARCH)
    jparams, tparams, _ = _params(jcfg, tcfg, placed=False)
    jp, tp = _layer0(jparams, tparams)
    rng = np.random.default_rng(7)
    B, P, S_max = 2, 28, min(tcfg.sliding_window, 128)
    x = rng.standard_normal((B, P, jcfg.d_model)).astype(np.float32)
    _, jc = jax_attention_train(jnp.asarray(x), jp, jcfg, host_policy(),
                                return_cache=True)
    pad = [(0, 0), (0, S_max - P), (0, 0), (0, 0)]
    jk, jv = (jnp.pad(t, pad) for t in (jc.k, jc.v))
    tk, tv = (torch.tensor(np.asarray(t)) for t in (jk, jv))
    wrote = set()
    for cur in range(P, 70):
        xt = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jy, new = jax_attention_decode(jnp.asarray(xt), jp, AttnCache(jk, jv),
                                       jnp.asarray(cur, jnp.int32), jcfg,
                                       host_policy())
        jk, jv = new.k, new.v
        ty = attention_decode(torch.from_numpy(xt), tp, tk, tv,
                              torch.tensor(cur, dtype=torch.int32), tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL,
                                   err_msg=f"cur_len {cur}")
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        wrote.add(cur % S_max)
    assert wrote == set(range(S_max))  # every ring entry was rewritten


def test_a_full_panel_clamps_the_write_like_jax():
    """Without a window, a write past the panel's last position lands on
    it: ``dynamic_update_slice`` clamps its start, and so does the port."""
    jcfg, tcfg = smoke_configs(ARCH, sliding_window=0)
    jparams, tparams, _ = _params(jcfg, tcfg, placed=False)
    jp, tp = _layer0(jparams, tparams)
    rng = np.random.default_rng(8)
    S_max = 12
    shape = (2, S_max, jcfg.num_kv_heads, jcfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jy, new = jax_attention_decode(jnp.asarray(xt), jp,
                                   AttnCache(jnp.asarray(k), jnp.asarray(v)),
                                   jnp.asarray(S_max, jnp.int32), jcfg,
                                   host_policy())
    tk, tv = torch.tensor(k), torch.tensor(v)
    ty = attention_decode(torch.from_numpy(xt), tp, tk, tv,
                          torch.tensor(S_max, dtype=torch.int32), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(new.k), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(new.v), **TOL)
    assert not np.allclose(tk.numpy()[:, -1], k[:, -1])


# ------------------------------------------------------------------ engine
def _engine(pkg, jparams, tparams, cfgs, ecfg_kwargs, *, mode, **kwargs):
    serving = PACKAGES[pkg][3]
    jcfg, tcfg = cfgs
    ecfg = serving.EngineConfig(decode_mode=mode, **ecfg_kwargs)
    if pkg == "jax":
        return serving.ServingEngine(jparams, jcfg, host_policy(), ecfg,
                                     **kwargs)
    return serving.ServingEngine(_clone(tparams), tcfg, ecfg, device="cpu",
                                 **kwargs)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _tokens(eng):
    return {r.uid: list(r.generated) for r in eng.finished}


@pytest.mark.parametrize("arch, window, mode, paged", [
    (ARCH, None, "auto", False),
    (ARCH, 0, "auto", True),
    (ARCH, 0, "dense", False),
    ("qwen3-32b", None, "auto", True),
    ("mamba2-1.3b", None, "auto", False),
    ("zamba2-1.2b", None, "dense", False),
])
def test_kv_mode_resolves_like_jax(arch, window, mode, paged):
    over = {} if window is None else {"sliding_window": window}
    cfgs = smoke_configs(arch, **over)
    jparams, tparams, _ = _params(*cfgs, placed=False)
    knobs = dict(max_batch=2, max_len=32, kv_mode=mode)
    engines = [_engine(pkg, jparams, tparams, cfgs, knobs, mode="python")
               for pkg in ("jax", "port")]
    assert [e.paged for e in engines] == [paged, paged]
    assert [e.kv_pool is None for e in engines] == [not paged, not paged]
    assert engines[1].kv_stats() == engines[0].kv_stats()


@pytest.mark.parametrize("arch, mode", [
    (ARCH, "paged"), ("mamba2-1.3b", "paged"), ("zamba2-1.2b", "paged"),
    ("qwen1.5-4b", "ring"),
])
def test_kv_mode_refusals_match_jax(arch, mode):
    cfgs = smoke_configs(arch)
    jparams, tparams, _ = _params(*cfgs, placed=False)
    messages = []
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError) as err:
            _engine(pkg, jparams, tparams, cfgs,
                    dict(max_batch=2, max_len=32, kv_mode=mode), mode="python")
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_a_prompt_longer_than_the_ring_raises_like_jax():
    cfgs = smoke_configs(ARCH)
    jparams, tparams, _ = _params(*cfgs, placed=False)
    prompt = np.arange(40) % cfgs[0].vocab_size  # the ring holds 32
    for pkg in ("jax", "port"):
        eng = _engine(pkg, jparams, tparams, cfgs,
                      dict(max_batch=2, max_len=128), mode="python")
        assert not eng.paged
        eng.submit(prompt, max_new_tokens=4)
        with pytest.raises(ValueError):
            eng.step()


RAGGED = dict(max_batch=3, max_len=64, other_time_per_step=1e-3,
              prefill_chunk=4, prefill_time_per_token=1e-4)


@pytest.fixture(scope="module")
def ragged_runs():
    """mixtral smoke with its window on the dense cache, three slots,
    prompts of 5 to 23 tokens arriving together (the shared length is the
    longest row's) and queued requests reusing finished slots; the rows
    wrap the 32-entry ring. A non-identity placement."""
    cfgs = smoke_configs(ARCH)
    jparams, tparams, e2s = _params(*cfgs, seed=5)
    rng = np.random.default_rng(21)
    lengths, news = [5, 23, 11, 17, 8], [30, 12, 26, 9, 20]
    prompts = [rng.integers(0, cfgs[0].vocab_size, size=n) for n in lengths]
    runs = {}
    for pkg, mode in (("jax", "scan"), ("port", "scan"), ("port", "python")):
        eng = _engine(pkg, jparams, tparams, cfgs, RAGGED, mode=mode)
        eng.placements = (jnp.asarray(e2s) if pkg == "jax"
                          else torch.from_numpy(e2s))
        serving = PACKAGES[pkg][3]
        eng.serve(serving.batch_arrivals(prompts, news))
        runs[pkg, mode] = eng
    return runs


@pytest.mark.parametrize("mode", ["scan", "python"])
def test_ragged_dense_batch_matches_jax(ragged_runs, mode):
    jeng, teng = ragged_runs["jax", "scan"], ragged_runs["port", mode]
    assert not teng.paged and teng.kv_pool is None
    assert len(teng.finished) == len(jeng.finished) == 5
    assert _tokens(teng) == _tokens(jeng)
    assert [r.uid for r in teng.finished] == [r.uid for r in jeng.finished]
    assert teng.step_count == jeng.step_count
    assert teng.sim_step_latencies == pytest.approx(jeng.sim_step_latencies)
    assert int(teng.expert_counts.sum()) == 2 * 3 * 2  # L · max_batch · k
    assert teng.kv_stats() == jeng.kv_stats() == {}
    for name in ("k", "v"):
        np.testing.assert_allclose(teng.caches["attn"][name].numpy(),
                                   np.asarray(jeng.caches["attn"][name]),
                                   rtol=1e-4, atol=1e-4)
    want = {"decode": int(mode == "scan"), "prefill": 0, "migrate": 0}
    assert teng.graph_capture_counts == want


def test_the_shared_length_is_the_batch_maximum(ragged_runs):
    """A shorter row decoded at the longest row's length differs from the
    same row served alone, which the paged cache would give."""
    cfgs = smoke_configs(ARCH)
    jparams, tparams, e2s = _params(*cfgs, seed=5)
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, cfgs[0].vocab_size, size=5)
    alone = _engine("port", jparams, tparams, cfgs, RAGGED, mode="python")
    alone.placements = torch.from_numpy(e2s)
    alone.submit(prompt, max_new_tokens=30)
    first = ragged_runs["port", "scan"].finished
    together = {r.uid: r.generated for r in first}[1]
    assert alone.run()[0].generated != together


def _profile(core, speeds, max_tokens=512, tile=8):
    fleet = core.DeviceFleet.from_speeds(
        np.asarray(speeds, dtype=np.float64), tile=tile, tile_time=40e-6)
    return core.profile_fleet(core.simulator_measure_fn(fleet), 4,
                              max_tokens=max_tokens, tile=tile,
                              repeats=3).profile


def test_paged_and_dense_engines_generate_identical_tokens():
    """The port's twin of ``tests/test_serving.py::
    test_paged_and_dense_engines_generate_identical_tokens`` (mixtral
    smoke with the window off, decode capacity factor 4, GEM's replan at
    step 8), and the JAX dense engine's tokens besides."""
    cfgs = smoke_configs(ARCH, decode_capacity_factor=4.0, sliding_window=0)
    jparams, tparams, _ = _params(*cfgs, placed=False)
    runs = {}
    for pkg, kv_mode in (("port", "paged"), ("port", "dense"),
                         ("jax", "dense")):
        core = PACKAGES[pkg][0]
        knobs = dict(max_batch=4, max_len=64,
                     gem=core.GEMConfig(trace_length=8, num_restarts=2),
                     replan_after=8, other_time_per_step=1e-4,
                     kv_mode=kv_mode)
        eng = _engine(pkg, jparams, tparams, cfgs, knobs,
                      mode="scan", num_devices=4,
                      profile=_profile(core, core.setup_speeds("high", 4)))
        assert eng.paged is (kv_mode == "paged")
        rng = np.random.default_rng(0)
        for _ in range(4):
            eng.submit(rng.integers(0, cfgs[0].vocab_size, size=8),
                       max_new_tokens=12)
        eng.run(max_steps=200)
        assert eng.placement_applied
        runs[pkg, kv_mode] = _tokens(eng)
    assert len(runs["port", "paged"]) == 4
    assert runs["port", "paged"] == runs["port", "dense"] == runs["jax", "dense"]


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_every_smoke_config_serves_like_jax(arch):
    """kv_mode="auto": paged for the attention families without a window,
    dense for mixtral's window, ssm and hybrid. Ragged prompts, two slots
    for three requests."""
    cfgs = smoke_configs(arch)
    jparams, tparams, e2s = _params(*cfgs, seed=1)
    jmode = "python" if cfgs[0].is_hybrid else "scan"
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfgs[0].vocab_size, size=n) for n in (5, 9, 7)]
    knobs = dict(max_batch=2, max_len=32, other_time_per_step=1e-3)
    runs = {}
    for pkg, mode in (("jax", jmode), ("port", "scan"), ("port", "python")):
        eng = _engine(pkg, jparams, tparams, cfgs, knobs, mode=mode)
        if e2s is not None:
            eng.placements = (jnp.asarray(e2s) if pkg == "jax"
                              else torch.from_numpy(e2s))
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        eng.run()
        runs[pkg, mode] = eng
    jeng = runs["jax", jmode]
    for mode in ("scan", "python"):
        teng = runs["port", mode]
        assert teng.paged == jeng.paged
        assert len(teng.finished) == 3
        assert _tokens(teng) == _tokens(jeng), mode
        assert teng.sim_step_latencies == pytest.approx(
            jeng.sim_step_latencies)
    assert runs["port", "scan"].graph_capture_counts["decode"] == 1


# ------------------------------------------------------------------- fig25
def _fig25_profile(core, speeds):
    fleet = core.DeviceFleet.from_speeds(
        np.asarray(speeds, dtype=np.float64), tile=1, tile_time=50e-6,
        base=10e-6)
    return core.profile_fleet(core.simulator_measure_fn(fleet, seed=0),
                              len(speeds), max_tokens=64, tile=1,
                              repeats=5).profile


FIG25_BELIEVED = (0.6, 0.8, 1.0, 1.3)
FIG25_TRUE = (0.6, 0.8, 1.0, 0.5)


def _fig25_run(pkg, mode, jparams, tparams, cfgs):
    """``benchmarks/fig25_shedding.py::_drive_engine(shed_on=True,
    suppress=False, seed=0, smoke=True)`` as written, on either package."""
    core, online, rep, serving = PACKAGES[pkg]
    knobs = dict(
        max_batch=16, max_len=128,
        gem=core.GEMConfig(trace_length=8, num_restarts=4),
        other_time_per_step=1e-4, online=True,
        drift=online.DriftConfig(min_steps=4, threshold=100.0,
                                 var_threshold=2.0),
        migration=online.MigrationConfig(max_moves_per_step=2,
                                         base_overhead=0.0),
        replan_cooldown=8, payback_horizon=100_000,
        replication=rep.ReplicationConfig(
            replica_slots=1, exclude_speed_below=0.0, consistent_only=False),
        shed=serving.ShedConfig(enabled=True, min_overflow=1, hysteresis=1.0,
                                drop_penalty_s=0.01),
    )
    eng = _engine(pkg, jparams, tparams, cfgs, knobs, mode=mode,
                  profile=_fig25_profile(core, FIG25_BELIEVED),
                  num_devices=len(FIG25_BELIEVED))
    assert not eng.paged  # the window: the dense ring
    rng = np.random.default_rng(17)  # seeded(17, 0)
    for _ in range(16):
        eng.submit(rng.integers(0, cfgs[0].vocab_size, size=8), 32)

    def counters():
        return dict(eng.telemetry.registry.snapshot().get("counters", {}))

    per_step, steps = [], 0
    while eng.scheduler.has_work() and steps < 200:
        if steps == 12:
            eng.set_true_profile(_fig25_profile(core, FIG25_TRUE))
        pre = eng.shed_enables
        c0 = counters()
        eng.step()
        c1 = counters()
        per_step.append((int(pre.sum()),) + tuple(
            int(c1.get(n, 0.0) - c0.get(n, 0.0))
            for n in ("dispatch.dropped_tokens", "shed.tokens",
                      "shed.overflow_tokens")))
        steps += 1
    return eng, per_step


@pytest.fixture(scope="module")
def fig25_runs():
    cfgs = smoke_configs(ARCH, decode_capacity_factor=1.5)
    jparams, tparams, _ = _params(*cfgs, placed=False, zero_router=True)
    return {(pkg, mode): _fig25_run(pkg, mode, jparams, tparams, cfgs)
            for pkg, mode in (("jax", "scan"), ("port", "scan"),
                              ("port", "python"))}


@pytest.mark.parametrize("mode", ["scan", "python"])
def test_fig25_live_engine_matches_jax(fig25_runs, mode):
    jeng, jsteps = fig25_runs["jax", "scan"]
    teng, tsteps = fig25_runs["port", mode]
    assert len(teng.finished) == len(jeng.finished) == 16
    assert _tokens(teng) == _tokens(jeng)
    assert tsteps == jsteps
    assert sum(s[2] for s in tsteps) > 0  # tokens were shed
    assert sum(s[0] for s in tsteps) > 0  # and the enables flipped on
    rep, jrep_ = teng.latency_report(), jeng.latency_report()
    for key in ("shed_tokens", "shed_overflow_tokens", "replans", "steps"):
        assert rep[key] == jrep_[key], key
    assert teng.graph_capture_counts["decode"] == int(mode == "scan")
