"""MoE router on the card: the wrapper of ``csrc/topk_router.cu``.

One CUDA source replaces both TPU router kernels of
``repro/kernels/topk_router.py``: ``_router_stats_kernel`` (``with_stats``,
the serving path) and ``_router_kernel``. Design notes are in the source.
Callers normally go through :func:`repro_torch.kernels.ops.topk_router`.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import current_stream_handle
from . import _build, launches

__all__ = ["topk_router_cuda", "arrival_counters", "MAX_EXPERTS", "MAX_K"]

MAX_EXPERTS = 128  # a warp holds a row: 4 logits per lane
MAX_K = 8
_ROWS_PER_BLOCK = 8  # warps per block (csrc/topk_router.cu kWarps)
_fn = None
# per (device, stream): the kernel's arrival counter, 0 between launches.
# A CUDA graph bakes in the counter of the stream that captured it, so
# that counter must exist before the capture (a first call on that stream
# outside it makes it); it is never allocated while a stream captures.
_arrivals: dict[tuple[int, int], torch.Tensor] = {}


def arrival_counters() -> list[torch.Tensor]:
    """Every stream's arrival counter: each is 0 whenever no launch on its
    stream is in flight."""
    return list(_arrivals.values())


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("topk_router").topk_router_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def topk_router_cuda(logits, k: int, *, with_stats: bool = False):
    """logits (T, E) float32 on a CUDA device → gates (T, k) f32, ids (T, k)
    i32, plus probs_sum (E,) f32 and counts (E,) i32 with ``with_stats``.

    Takes E ≤ 128 and 1 ≤ k ≤ min(E, 8); anything else raises. One kernel
    launch and one allocation: the outputs are views of one buffer that
    also holds the kernel's per-block partials (layout in the source).
    """
    if not logits.is_cuda:
        raise ValueError("topk_router_cuda: logits must be on a CUDA device")
    if logits.dtype != torch.float32:
        raise TypeError(f"topk_router_cuda: float32 logits, got {logits.dtype}")
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError("topk_router_cuda: contiguous (T, E) logits")
    T, E = logits.shape
    if not (1 <= E <= MAX_EXPERTS and 1 <= k <= min(E, MAX_K)):
        raise ValueError(
            f"topk_router_cuda: needs E <= {MAX_EXPERTS} and "
            f"1 <= k <= min(E, {MAX_K}); got E={E}, k={k}"
        )
    dev = logits.device
    tk = T * k
    nb = -(-T // _ROWS_PER_BLOCK)
    words = 2 * tk + (2 * E + 2 * nb * E if with_stats else 0)
    buf = torch.empty(words, dtype=torch.float32, device=dev)
    if T == 0:
        buf.zero_()  # no rows: zero statistics
    else:
        stream = current_stream_handle(dev)
        counter = None
        if with_stats:
            counter = _arrivals.get((dev.index, stream))
            if counter is None:
                if torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(
                        "topk_router_cuda: no arrival counter for the "
                        "capturing stream; run the captured body once on "
                        "that stream before the capture"
                    )
                counter = _arrivals[dev.index, stream] = torch.zeros(
                    1, dtype=torch.int32, device=dev
                )
            counter = counter.data_ptr()
        err = _launcher()(
            logits.data_ptr(), buf.data_ptr(), counter, T, E, k,
            int(with_stats), stream,
        )
        if err != 0:
            raise RuntimeError(
                f"topk_router kernel launch failed: CUDA error {err}"
            )
        launches.count("topk_router_stats" if with_stats else "topk_router")
    ibuf = buf.view(torch.int32)
    gates = buf.as_strided((T, k), (k, 1))
    ids = ibuf.as_strided((T, k), (k, 1), tk)
    if not with_stats:
        return gates, ids
    return (gates, ids, buf.as_strided((E,), (1,), 2 * tk),
            ibuf.as_strided((E,), (1,), 2 * tk + E))
