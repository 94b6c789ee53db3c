"""The port's plain kernel versions against the JAX Pallas kernels.

K1 is the grouped SwiGLU expert FFN, K2/K3 the router with and without aux
statistics. The JAX kernels run as their own tests run them on the CPU:
in Pallas interpret mode, K1 through ``moe_ffn_sharded`` (the serving
path, which pads ragged C and F to its tiles). The Hopper kernels
themselves are held against these plain versions on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.sharded import moe_ffn_sharded  # noqa: E402
from repro.kernels.topk_router import topk_router_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import moe_ffn_ref, topk_router_ref  # noqa: E402

torch.set_num_threads(1)

S, D = 3, 64


def _ffn_inputs(C, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, C, D)).astype(np.float32)
    x[:, -1] = 0.0  # a zero row (a pad row) must give zero
    w = [
        (rng.standard_normal(shape) * 0.1).astype(np.float32)
        for shape in ((S, D, F), (S, D, F), (S, F, D))
    ]
    return x, w


@pytest.mark.parametrize("C", [1, 3, 4, 33])
@pytest.mark.parametrize("F", [96, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_ref_matches_pallas(C, F, dtype):
    x, w = _ffn_inputs(C, F, seed=C * 1000 + F)
    jdt = getattr(jnp, dtype)
    want = moe_ffn_sharded(
        jnp.asarray(x, jdt)[None], *(jnp.asarray(a, jdt) for a in w),
        mesh=None, data_spec=None, expert_spec=None, interpret=True,
    )[0]
    tdt = getattr(torch, dtype)
    got = moe_ffn_ref(*(torch.from_numpy(a).to(tdt) for a in (x, *w)))
    assert got.dtype == tdt and tuple(got.shape) == (S, C, D)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )
    assert not got[:, -1].any()


def _router_logits(T, E, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((T, E)) * 2).astype(np.float32)
    logits[0] = 0.0  # all tied: the lowest ids win
    logits[1, : E // 2] = logits[1, 0]  # a tied block inside a row
    logits[2] = np.repeat(logits[2, : E // 4], 4)[:E]  # ties in fours
    return logits


@pytest.mark.parametrize("E", [8, 40, 128])
@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("with_stats", [True, False])
def test_topk_router_ref_matches_pallas(E, k, with_stats):
    T = 37  # three blocks of 16 rows: ragged T, padded rows masked
    logits = _router_logits(T, E, seed=E * 10 + k)
    want = topk_router_pallas(
        jnp.asarray(logits), k, block_t=16, interpret=True,
        with_stats=with_stats,
    )
    got = topk_router_ref(torch.from_numpy(logits), k, with_stats=with_stats)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1][0].numpy(), np.arange(k))
    np.testing.assert_allclose(
        got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6
    )
    if with_stats:
        np.testing.assert_allclose(
            got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-6
        )
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert got[3].dtype == torch.int32 and int(got[3].sum()) == T * k


def test_ops_take_plain_versions_on_cpu():
    ops.reset_launch_counts()
    x, w = _ffn_inputs(4, 96, seed=0)
    ts = [torch.from_numpy(a) for a in (x, *w)]
    torch.testing.assert_close(ops.moe_ffn(*ts), moe_ffn_ref(*ts), rtol=0, atol=0)
    logits = torch.from_numpy(_router_logits(9, 40, seed=1))
    for a, b in zip(ops.topk_router(logits, 8, with_stats=True),
                    topk_router_ref(logits, 8, with_stats=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the plain path is no kernel launch
    assert set(ops.launch_counts().values()) == {0}
