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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
