"""The Hopper kernels against their plain versions, on the card.

Tests marked ``cuda`` skip without an NVIDIA GPU; on the H100 run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports nothing of JAX, so it runs on a machine without it. The
wrappers' input checks run everywhere: they raise before any build.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import moe_gemm  # noqa: E402
from repro_torch.kernels.collective import MigrationExecutable  # noqa: E402
from repro_torch.kernels.moe_gemm import moe_ffn_cuda  # noqa: E402
from repro_torch.kernels.ref import moe_ffn_ref, topk_router_ref  # noqa: E402
from repro_torch.kernels.topk_router import topk_router_cuda  # noqa: E402
from repro_torch.models import apply_placement, init_params  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402


def _ffn_inputs(S, C, D, F, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((S, C, D), generator=g)
    x[:, -1] = 0.0  # a pad row gives zero
    ws = [torch.randn(shape, generator=g) * 0.1
          for shape in ((S, D, F), (S, D, F), (S, F, D))]
    return [t.to(device=device, dtype=dtype) for t in (x, *ws)]


def _router_logits(T, E, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((T, E), generator=g) * 2
    logits[0] = 0.0  # all tied: the lowest ids win
    logits[1, : E // 2] = logits[1, 0]
    return logits.to(device)


def test_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        moe_ffn_cuda(*_ffn_inputs(2, 4, 16, 8, torch.float32, "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        topk_router_cuda(_router_logits(4, 8, "cpu"), 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


# every row-tile boundary of the bf16 tensor-core kernel (8, 16, 32 rows)
_C_BOUNDARIES = [1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64]


def _bits(t):
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                   torch.int32: torch.int32}[t.dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("C", _C_BOUNDARIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_kernel_matches_plain(cuda, C, dtype):
    ts = _ffn_inputs(5, C, 64, 96, getattr(torch, dtype), cuda, seed=C)
    before = ops.launch_counts()["moe_ffn"]
    got = ops.moe_ffn(*ts)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_ffn"] == before + 1
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got, moe_ffn_ref(*ts), rtol=tol, atol=tol)
    assert not got[:, -1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 4, 9, 32, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_kernel_is_exact_under_slot_permutation(cuda, C, dtype):
    """A slot's result depends neither on its position nor on the run: the
    same call twice gives the same bytes, and permuting the slots of x and
    of the three weight stacks permutes y bit for bit."""
    ts = _ffn_inputs(7, C, 128, 96, getattr(torch, dtype), cuda, seed=10 + C)
    perm = torch.as_tensor(np.random.default_rng(C).permutation(7), device=cuda)
    got = ops.moe_ffn(*ts)
    again = ops.moe_ffn(*ts)
    permuted = ops.moe_ffn(*(t[perm].contiguous() for t in ts))
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    assert torch.equal(_bits(permuted), _bits(got[perm]))


def test_kernel_path_names_the_path_from_the_exported_threshold(monkeypatch):
    """bf16 calls of C >= C_MIN rows take the wgmma kernels, fewer rows the
    mma.sync ones; fp32 has one path and never reads the threshold."""
    monkeypatch.setattr(moe_gemm, "_min_c", 64)
    assert moe_gemm.kernel_path(torch.bfloat16, 63) == "mma.sync"
    assert moe_gemm.kernel_path(torch.bfloat16, 64) == "wgmma"
    assert moe_gemm.kernel_path(torch.bfloat16, 1279) == "wgmma"
    monkeypatch.setattr(moe_gemm, "_min_c", None)
    assert moe_gemm.kernel_path(torch.float32, 1279) == "fp32"
    assert moe_gemm._min_c is None
    assert "TMA" in moe_gemm._error(-1001) and "CUDA error 2" == moe_gemm._error(2)


@pytest.fixture
def min_c(cuda):
    return moe_gemm.wgmma_min_c()


# C around the wgmma path's threshold (as offsets from C_MIN, read on the
# card) and its 128-row tile edges
_LARGE_C = [("min", -1), ("min", 0), ("min", 1), ("abs", 65), ("abs", 128),
            ("abs", 129), ("abs", 1279)]


def _large_c(spec, min_c):
    kind, v = spec
    return min_c + v if kind == "min" else v


@pytest.mark.cuda
@pytest.mark.parametrize("spec", _LARGE_C, ids=lambda s: f"{s[0]}{s[1]:+d}")
def test_moe_ffn_large_c_matches_plain_on_its_path(cuda, min_c, spec):
    """Every C runs a port kernel: the wgmma one from C_MIN rows on (its
    own launch count goes up), the mma.sync one below; both hold to the
    plain version, and a zero pad row gives zero."""
    C = _large_c(spec, min_c)
    ts = _ffn_inputs(3, C, 128, 256, torch.bfloat16, cuda, seed=C)
    before = ops.launch_counts()
    got = ops.moe_ffn(*ts)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["moe_ffn"] == before["moe_ffn"] + 1
    assert after["moe_ffn_wgmma"] == before["moe_ffn_wgmma"] + (C >= min_c)
    torch.testing.assert_close(got, moe_ffn_ref(*ts), rtol=1e-2, atol=1e-2)
    assert not got[:, -1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("spec", _LARGE_C, ids=lambda s: f"{s[0]}{s[1]:+d}")
def test_moe_ffn_large_c_is_exact_under_slot_permutation(cuda, min_c, spec):
    C = _large_c(spec, min_c)
    ts = _ffn_inputs(5, C, 128, 128, torch.bfloat16, cuda, seed=20 + C)
    perm = torch.as_tensor(np.random.default_rng(C).permutation(5), device=cuda)
    got = ops.moe_ffn(*ts)
    again = ops.moe_ffn(*ts)
    permuted = ops.moe_ffn(*(t[perm].contiguous() for t in ts))
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    assert torch.equal(_bits(permuted), _bits(got[perm]))


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [("small", 1, 32), ("small", 9, -1),
                                  ("large", 0, 1), ("large", 0, 1279),
                                  ("large", 129, 1279)],
                         ids=lambda p: f"{p[0]}-{p[1]}-{p[2]}")
def test_moe_ffn_rows_do_not_depend_on_c_within_a_path(cuda, min_c, pair):
    """A call's rows are the same rows of a call with more of them, bit for
    bit, as long as both take one path (C_MIN-relative entries: -1 is
    C_MIN - 1, 0 and 1 are C_MIN and C_MIN + 1)."""
    kind, small, large = pair
    if kind == "small":
        large = min_c - 1 if large == -1 else large
    else:
        small = min_c + small if small <= 1 else small
        large = min_c + large if large <= 1 else large
    assert (small >= min_c) == (large >= min_c)
    x, wg, wu, wd = _ffn_inputs(3, large, 128, 256, torch.bfloat16, cuda,
                                seed=small)
    y_large = ops.moe_ffn(x, wg, wu, wd)
    y_small = ops.moe_ffn(x[:, :small].contiguous(), wg, wu, wd)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y_small), _bits(y_large[:, :small]))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [7, 130])
def test_moe_ffn_ragged_d_and_f_on_both_paths(cuda, min_c, C):
    """D and F multiples of 8 but of no tile width: the mma.sync kernel
    masks them, the wgmma one gets zeros from TMA past them and masks its
    stores."""
    ts = _ffn_inputs(4, C, 520, 264, torch.bfloat16, cuda, seed=C)
    got = ops.moe_ffn(*ts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, moe_ffn_ref(*ts), rtol=1e-2, atol=1e-2)
    assert moe_gemm.kernel_path(torch.bfloat16, C) == (
        "wgmma" if C >= min_c else "mma.sync")


@pytest.mark.cuda
@pytest.mark.parametrize("D,F", [(64, 92), (60, 96)])
def test_moe_ffn_bf16_refuses_what_the_tensor_cores_cannot_take(cuda, D, F):
    """The 16-byte copies need D and F multiples of 8: the wrapper raises
    and never routes to the plain version."""
    ts = _ffn_inputs(2, 4, D, F, torch.bfloat16, cuda)
    before = ops.launch_counts()["moe_ffn"]
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.moe_ffn(*ts)
    assert ops.launch_counts()["moe_ffn"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1000, 4096])
def test_topk_router_stats_over_many_blocks_are_bit_equal(cuda, T):
    """The last block sums every block's partial in block order: the
    statistics are final on return, the same bits from call to call, and
    equal (counts) or within 1e-5 (probability sums) of the plain version."""
    logits = _router_logits(T, 40, cuda, seed=T)
    runs = [ops.topk_router(logits, 8, with_stats=True) for _ in range(4)]
    want = topk_router_ref(logits, 8, with_stats=True)
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(_bits(a), _bits(b))
    gates, ids, probs_sum, counts = runs[0]
    assert torch.equal(ids, want[1]) and torch.equal(counts, want[3])
    assert int(counts.sum()) == T * 8
    torch.testing.assert_close(probs_sum, want[2], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gates, want[0], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_topk_router_without_rows_gives_zero_stats(cuda):
    gates, ids, probs_sum, counts = ops.topk_router(
        torch.empty((0, 40), device=cuda), 8, with_stats=True)
    assert gates.shape == (0, 8) and ids.shape == (0, 8)
    assert gates.dtype == torch.float32 and ids.dtype == torch.int32
    assert not probs_sum.any() and not counts.any()
    assert probs_sum.shape == counts.shape == (40,)


@pytest.mark.cuda
@pytest.mark.parametrize("E,k", [(8, 2), (40, 8), (128, 8)])
@pytest.mark.parametrize("with_stats", [True, False])
@pytest.mark.parametrize("T", [8, 37])  # one block; five, the last sums
def test_topk_router_kernel_matches_plain(cuda, E, k, with_stats, T):
    logits = _router_logits(T, E, cuda, seed=E)
    got = ops.topk_router(logits, k, with_stats=with_stats)
    want = topk_router_ref(logits, k, with_stats=with_stats)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert got[1][0].tolist() == list(range(k))
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    if with_stats:
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
        assert torch.equal(got[3], want[3])


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, wg, wu, wd = _ffn_inputs(2, 4, 16, 8, torch.float16, cuda)
    with pytest.raises(TypeError):
        moe_ffn_cuda(x, wg, wu, wd)
    x, wg, wu, wd = _ffn_inputs(2, 4, 16, 8, torch.float32, cuda)
    with pytest.raises(ValueError):
        moe_ffn_cuda(x, wg.transpose(1, 2), wu, wd)
    with pytest.raises(ValueError):
        topk_router_cuda(_router_logits(4, 129, cuda), 8)
    with pytest.raises(ValueError):
        topk_router_cuda(_router_logits(4, 40, cuda), 9)


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu(cuda):
    """Smoke granite, fp32, non-identity placement: the kernel path and
    the plain path give the same greedy tokens."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    Ev = cfg.num_virtual_experts
    rng = np.random.default_rng(0)
    s2e = np.stack([rng.permutation(Ev) for _ in range(cfg.num_layers)])
    e2s = torch.as_tensor(np.argsort(s2e, axis=1), dtype=torch.int32)
    params = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    blocks = dict(params["blocks"])
    blocks["moe"] = apply_placement(blocks["moe"], torch.as_tensor(s2e))
    params = {**params, "blocks": blocks}
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 14)]
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        eng = ServingEngine(p, cfg, EngineConfig(max_batch=2, max_len=40),
                            device=dev)
        eng.placements = e2s.to(dev)
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=6)
        ops.reset_launch_counts()
        out[str(dev)] = {r.uid: r.generated for r in eng.run()}
        if dev == cuda:
            calls = cfg.num_layers * (eng.prefill_count + eng.decode_count)
            counts = ops.launch_counts()
            assert counts["moe_ffn"] == counts["topk_router_stats"] == calls
    assert out["cpu"] == out[str(cuda)]


@pytest.mark.cuda
def test_migration_on_the_card_is_exact_and_one_layer_at_a_time(cuda):
    """The pool is rewritten in place: each slot's rows afterwards are the
    bytes of its source slot, the tables are the inverse permutation, and
    the memory it takes beyond the pool is at most one layer's rows."""
    L, S, D, F = 6, 16, 256, 128
    g = torch.Generator(device=cuda).manual_seed(0)
    ws = [torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
          for shape in ((L, S, D, F), (L, S, D, F), (L, S, F, D))]
    before = [w.clone() for w in ws]
    rng = np.random.default_rng(1)
    src = np.stack([rng.permutation(S) for _ in range(L)]).astype(np.int32)
    tables = torch.arange(S, dtype=torch.int32, device=cuda).repeat(L, 1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, new_tables = MigrationExecutable()(src, tables, *ws)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    layer_rows = sum(w[0].numel() * w.element_size() for w in ws)
    assert extra <= layer_rows, (extra, layer_rows)
    assert all(a is b for a, b in zip(out, ws))
    rows = torch.as_tensor(src, device=cuda).long()
    for new, old in zip(out, before):
        for layer in range(L):
            assert torch.equal(_bits(new[layer]), _bits(old[layer][rows[layer]]))
    assert new_tables.dtype == torch.int32
    assert np.array_equal(new_tables.cpu().numpy(), np.argsort(src, axis=1))


def _replan_engine(params, cfg, mode, device, logits):
    """Smoke granite with GEM's one-shot replan mid-run; keeps a copy of
    every decode step's logits."""
    from repro_torch.core import GEMConfig
    from repro_torch.launch.serve import emulated_profile

    eng = ServingEngine(
        params, cfg,
        EngineConfig(max_batch=3, max_len=40, decode_mode=mode,
                     gem=GEMConfig(trace_length=4, num_restarts=3)),
        profile=emulated_profile("high", 4), num_devices=4, device=device,
    )
    inner = eng._decode

    def decode(*a, **kw):
        out = inner(*a, **kw)
        logits.append(out[0].clone())
        return out

    eng._decode = decode
    rng = np.random.default_rng(4)
    for n, new in zip((7, 11, 7, 11), (9, 6, 8, 7)):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n), max_new_tokens=new)
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_graph_matches_python_through_a_replan(cuda, dtype):
    """Two layers on the card, GEM's replan mid-run: the captured decode
    step gives the eager step's tokens and logits bit for bit, is captured
    once (the swap adds no capture), launches K1 and K2 on every MoE layer
    call through its replays, and leaves K2's arrival counters at 0."""
    from repro_torch.kernels.topk_router import arrival_counters

    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = init_params(cfg, seed=3, device=cuda, dtype=getattr(torch, dtype))
    runs = {}
    for mode in ("scan", "python"):
        logits = []
        eng = _replan_engine(_clone(params), cfg, mode, cuda, logits)
        ops.reset_launch_counts()
        eng.run()
        torch.cuda.synchronize()
        calls = cfg.num_layers * (eng.prefill_count + eng.decode_count)
        counts = ops.launch_counts()
        assert counts["moe_ffn"] == counts["topk_router_stats"] == calls
        assert eng.migration_records and eng.placement_applied
        runs[mode] = (eng, logits)
    (scan, scan_logits), (python, py_logits) = runs["scan"], runs["python"]
    assert scan.graph_capture_counts == {"decode": 1, "prefill": 0,
                                         "migrate": 0}
    assert {r.uid: r.generated for r in scan.finished} == \
        {r.uid: r.generated for r in python.finished}
    assert len(scan_logits) == len(py_logits) == scan.decode_count
    for a, b in zip(scan_logits, py_logits):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(scan.placements, python.placements)
    assert all(int(c.item()) == 0 for c in arrival_counters())


@pytest.mark.cuda
def test_a_host_sync_in_the_decode_step_fails_the_capture(cuda, monkeypatch):
    """The warm-up before the capture runs under the sync debug mode
    "error": a step that reads a device value on the host raises at once
    instead of being captured."""
    from repro_torch.models import model

    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = init_params(cfg, seed=3, device=cuda, dtype=torch.float32)
    norm = model.rms_norm

    def syncing_norm(x, scale, eps=1e-6):
        float(x.float().abs().max())  # a host read of a device value
        return norm(x, scale, eps)

    monkeypatch.setattr(model, "rms_norm", syncing_norm)
    with pytest.raises(RuntimeError):
        ServingEngine(params, cfg, EngineConfig(max_batch=2, max_len=40),
                      device=cuda)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shed", [0, 1])
def test_shed_pass_on_the_card_equals_the_cpu_without_a_sync(cuda, shed):
    """The replica split and the shed pass on CUDA tensors, under the sync
    debug mode "error": every plan field equals the CPU's."""
    from repro_torch.models import dispatch

    cfg = get_smoke_config("granite-moe-3b-a800m")
    Ev, k = cfg.num_virtual_experts, cfg.experts_per_token
    rng = np.random.default_rng(2)
    ids = np.tile(np.arange(k, dtype=np.int32), (1, 16, 1))  # all hot
    gates = rng.uniform(0.1, 1.0, size=(1, 16, k)).astype(np.float32)
    table = np.tile(np.arange(Ev, dtype=np.int32)[:, None], (1, 16))
    table[:k, 14:] = Ev + np.arange(k)[:, None]  # a small-share copy
    plans = {}
    for dev in ("cpu", cuda):
        zeros = torch.zeros(cfg.num_experts, device=dev)
        router = dispatch.RouterOutput(
            gates=torch.as_tensor(gates, device=dev),
            ids=torch.as_tensor(ids, device=dev),
            expert_counts=zeros.int(), density=zeros, probs_mean=zeros,
            aux_loss=zeros.sum())
        t = torch.as_tensor(table, device=dev)
        enable = torch.full((), shed, dtype=torch.int32, device=dev)
        mode = torch.cuda.get_sync_debug_mode()
        if dev == cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            plans[str(dev)] = dispatch.build_dispatch(
                router, t, cfg, capacity_factor=1.0, num_slots=Ev + 4,
                shed_enable=enable)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    ref, got = plans["cpu"], plans[str(cuda)]
    for name in ("dispatch_idx", "dispatch_gate", "assign_row", "dropped",
                 "dropped_tokens", "overflow_tokens", "shed_tokens",
                 "shed_delta"):
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name)), name
    assert (int(ref.shed_tokens) > 0) == bool(shed)


def _twin_profile(speeds):
    """A 4-device emulated staircase fleet at ``speeds``, profiled."""
    from repro_torch.core import DeviceFleet, profile_fleet, simulator_measure_fn

    fleet = DeviceFleet.from_speeds(np.asarray(speeds, dtype=np.float64),
                                    tile=1, tile_time=50e-6, base=10e-6)
    return profile_fleet(simulator_measure_fn(fleet, seed=0), 4,
                         max_tokens=64, tile=1, repeats=5).profile


@pytest.mark.cuda
def test_replicated_shed_engine_on_the_card_matches_the_cpu(cuda):
    """Smoke granite, fp32, zeroed router, one replica slot a device, shed
    on, online, the fastest card slowed mid-run: "scan" and "python" on
    the card and "python" on the CPU give the same tokens and the same
    per-step shed counts, some steps shed, and "scan" captures once."""
    import dataclasses

    from repro_torch.core import GEMConfig
    from repro_torch.online import DriftConfig, MigrationConfig
    from repro_torch.replication import ReplicationConfig
    from repro_torch.serving import ShedConfig

    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              decode_capacity_factor=1.5)
    params = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    params["blocks"]["moe"]["router"].zero_()
    runs = {}
    for dev, mode in (("cpu", "python"), (cuda, "python"), (cuda, "scan")):
        eng = ServingEngine(
            _to(params, dev), cfg,
            EngineConfig(max_batch=8, max_len=40, decode_mode=mode,
                         gem=GEMConfig(trace_length=8, num_restarts=4),
                         online=True,
                         drift=DriftConfig(min_steps=4, threshold=100.0,
                                           var_threshold=2.0),
                         migration=MigrationConfig(max_moves_per_step=256),
                         replan_cooldown=8, payback_horizon=100_000,
                         replication=ReplicationConfig(
                             replica_slots=1, exclude_speed_below=0.0,
                             consistent_only=False, refine=False),
                         shed=ShedConfig(enabled=True, drop_penalty_s=0.01)),
            profile=_twin_profile([0.6, 0.8, 1.0, 1.3]), num_devices=4,
            device=dev)
        steps = []
        inner = eng._shed_step

        def record(counts_virt, aux, cost_mx, steps=steps, inner=inner):
            steps.append([getattr(aux, n).cpu().tolist() for n in (
                "overflow_tokens", "shed_tokens", "dropped_tokens")])
            return inner(counts_virt, aux, cost_mx)

        eng._shed_step = record
        rng = np.random.default_rng(17)
        for _ in range(16):
            eng.submit(rng.integers(0, cfg.vocab_size, size=8),
                       max_new_tokens=24)
        for step in range(200):
            if not eng.scheduler.has_work():
                break
            if step == 12:
                eng.set_true_profile(_twin_profile([0.6, 0.8, 1.0, 0.2]))
            eng.step()
        runs[str(dev), mode] = (eng, steps)
    ref_eng, ref_steps = runs["cpu", "python"]
    assert any(sum(shed) > 0 for _, shed, _ in ref_steps)
    for key, (eng, steps) in runs.items():
        assert {r.uid: r.generated for r in eng.finished} == \
            {r.uid: r.generated for r in ref_eng.finished}, key
        assert steps == ref_steps, key
    assert runs[str(cuda), "scan"][0].graph_capture_counts["decode"] == 1


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-1.3b", "zamba2-1.2b",
                                  "gemma-7b"])
def test_dense_cache_engine_on_the_card_matches_the_cpu(cuda, arch):
    """Smoke configs on the dense cache (mixtral's window-32 ring wraps;
    the SSM state and conv buffers; zamba2's shared block; gemma's GeGLU,
    forced dense), fp32, ragged prompts: the captured step and the eager
    one on the card give the CPU's greedy tokens, and the capture leaves
    the caches as it found them."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 19, 11)]
    out, launches = {}, {}
    for dev, mode in (("cpu", "python"), (cuda, "scan"), (cuda, "python")):
        eng = ServingEngine(_to(params, dev), cfg, EngineConfig(
            max_batch=2, max_len=64, kv_mode="dense", decode_mode=mode),
            device=dev)
        assert all(not t.any() for t in _cache_leaves(eng.caches))
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=24)
        ops.reset_launch_counts()
        out[str(dev), mode] = {r.uid: r.generated for r in eng.run()}
        launches[str(dev), mode] = ops.launch_counts()
        if mode == "scan":
            assert eng.graph_capture_counts["decode"] == 1
    assert out[str(cuda), "scan"] == out["cpu", "python"]
    assert out[str(cuda), "python"] == out["cpu", "python"]
    if cfg.is_moe:
        assert launches[str(cuda), "scan"]["moe_ffn"] > 0
    else:
        assert not any(launches[str(cuda), "scan"].values())


def _cache_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _cache_leaves(v)
        else:
            yield v


@pytest.mark.cuda
@pytest.mark.parametrize("arch,paged,slots", [
    ("mixtral-8x7b", False, 40), ("mamba2-1.3b", False, 40),
    ("zamba2-1.2b", False, 40), ("qwen2.5-14b", False, 32768),
    ("granite-moe-3b-a800m", True, 4096),
], ids=["ring", "ssm", "hybrid", "dense-128MB", "paged-128MB"])
def test_binding_restores_the_caches_without_a_second_copy(cuda, arch, paged,
                                                           slots):
    """``DecodeGraph`` runs the idle step twice before it captures: on
    random fp32 caches the binding leaves every entry as it found it (the
    paged pool's null block aside), and at 128 MB of KV cache over 8
    layers the binding's peak allocation above the caches stays under half
    of them (one layer's intermediates are an eighth), so no second copy of
    the cache is made. ``slots`` is max_len on the dense cache and the
    block count on the paged one."""
    import dataclasses

    from repro_torch.models import init_decode_cache, init_paged_decode_cache
    from repro_torch.models.model import DecodeGraph

    cfg = get_smoke_config(arch)
    if not cfg.is_hybrid:
        cfg = dataclasses.replace(cfg, num_layers=8)
    params = init_params(cfg, seed=2, device=cuda, dtype=torch.float32)
    B, bs = 2, 16
    if paged:
        caches = init_paged_decode_cache(cfg, slots, bs, device=cuda,
                                         dtype=torch.float32)
    else:
        caches = init_decode_cache(cfg, B, slots, device=cuda,
                                   dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for t in _cache_leaves(caches):
        t.normal_(generator=gen)
    before = [t.clone() for t in _cache_leaves(caches)]
    cache_bytes = sum(t.numel() * t.element_size() for t in before)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    graph = DecodeGraph(params, caches, None, cfg, batch=B,
                        n_max=4 if paged else None, device=cuda)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert graph.builds == 1 and graph._graph is not None
    for t, old in zip(_cache_leaves(caches), before):
        if paged:
            t, old = t[:, 1:], old[:, 1:]
        assert torch.equal(t, old)
    if cache_bytes >= 2 ** 27:
        assert extra < cache_bytes // 2, (extra, cache_bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_function_on_the_card_matches_the_plain_backward(cuda, dtype):
    """The autograd Function over K1: its forward is the kernel (one launch,
    counted), its backward the reference math; on the card against the
    same Function on the CPU (the plain forward) from the same inputs."""
    from repro_torch.kernels.autograd import MoEFFN

    dt = getattr(torch, dtype)
    cpu = [t.requires_grad_(True) for t in _ffn_inputs(6, 9, 64, 96, dt, "cpu")]
    dev = [t.detach().to(cuda).requires_grad_(True) for t in cpu]
    g = torch.Generator().manual_seed(3)
    cot = torch.randn((6, 9, 64), generator=g).to(dt)
    before = ops.launch_counts()["moe_ffn"]
    y = ops.moe_ffn(*dev)
    assert type(y.grad_fn).__name__ == "MoEFFNBackward"
    got = torch.autograd.grad(y, dev, grad_outputs=cot.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_ffn"] == before + 1
    want = torch.autograd.grad(MoEFFN.apply(*cpu), cpu, grad_outputs=cot)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, a, b in zip(("dx", "dWg", "dWu", "dWd"), got, want):
        assert a.dtype == b.dtype == dt, name
        scale = b.float().abs().max().item()
        err = (a.cpu().float() - b.float()).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("T, E, k", [(64, 40, 8), (1000, 8, 2), (5, 128, 8)])
def test_topk_router_function_on_the_card_matches_the_plain_backward(
        cuda, T, E, k):
    """The autograd Function over K2: ids and counts equal, non-differentiable
    and of their own storage (the kernel returns views of one buffer), the
    logits' gradient under cotangents on the gates and on probs_sum equal
    to the CPU's within 1e-5 of its max."""
    from repro_torch.kernels.autograd import TopKRouter

    logits = _router_logits(T, E, "cpu")
    g = torch.Generator().manual_seed(T)
    cg = torch.randn((T, k), generator=g)
    cp = torch.randn((E,), generator=g)
    lc = logits.clone().requires_grad_(True)
    ld = logits.to(cuda).requires_grad_(True)
    before = ops.launch_counts()["topk_router_stats"]
    out = ops.topk_router(ld, k, with_stats=True)
    assert ops.launch_counts()["topk_router_stats"] == before + 1
    ptrs = {t.untyped_storage().data_ptr() for t in out}
    assert len(ptrs) == 4
    gates, ids, psum, counts = out
    assert not ids.requires_grad and not counts.requires_grad
    want = TopKRouter.apply(lc, k)
    assert torch.equal(ids.cpu(), want[1]) and torch.equal(counts.cpu(), want[3])
    (got,) = torch.autograd.grad((gates, psum), ld,
                                 grad_outputs=(cg.to(cuda), cp.to(cuda)))
    (ref,) = torch.autograd.grad((want[0], want[2]), lc, grad_outputs=(cg, cp))
    scale = ref.abs().max().item()
    assert (got.cpu() - ref).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """granite smoke, fp32, under a placement: one step of the train step
    through K1/K2 (launches = layers × 1 forward, remat off) against the
    CPU's: loss within 1e-5, expert counts equal, each parameter leaf
    after the update within 1e-4 in relative norm (Adam's first step moves
    a coordinate whose gradient is at rounding level by up to the learning
    rate either way, so not element by element)."""
    from repro_torch.launch.train import placement
    from repro_torch.models import apply_placement
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step
    from repro_torch.tree import leaves, tree_map

    cfg = get_smoke_config("granite-moe-3b-a800m")
    s2e, e2s = placement(cfg.num_layers, cfg.num_virtual_experts, seed=2)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    out = {}
    for device in ("cpu", cuda):
        params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
        params["blocks"]["moe"] = apply_placement(params["blocks"]["moe"], s2e)
        params = tree_map(lambda t: t.to(device), params)
        state = init_train_state(params, AdamWConfig())
        step = make_train_step(cfg, AdamWConfig(), remat=False)
        ops.reset_launch_counts()
        state, m = step(state, {k: torch.from_numpy(v).to(device)
                                for k, v in batch.items()},
                        torch.from_numpy(e2s).to(device))
        out[str(device)] = (float(m["loss"]), m["expert_counts"].cpu(),
                            state["params"], ops.launch_counts())
    (lc, cc, pc, _), (ld, cd, pd, launched) = out["cpu"], out[str(cuda)]
    assert launched["moe_ffn"] == launched["topk_router_stats"] == cfg.num_layers
    assert launched["topk_router"] == 0
    assert abs(ld - lc) <= 1e-5 * abs(lc)
    assert torch.equal(cd, cc)
    for a, b in zip(leaves(pd), leaves(pc)):
        err = torch.linalg.vector_norm(a.detach().cpu() - b.detach())
        assert err.item() <= 1e-4 * torch.linalg.vector_norm(b).item()
