"""Grouped SwiGLU expert FFN on the card: the wrapper of ``csrc/moe_ffn.cu``.

The CUDA kernel replaces the TPU kernel ``repro/kernels/moe_gemm.py::
_ffn_kernel``; its design notes are in the source. This wrapper checks
what the kernel takes, allocates the output and the hidden scratch, and
launches on PyTorch's current stream. Callers normally go through
:func:`repro_torch.kernels.ops.moe_ffn`, which picks the kernel for a CUDA
tensor and the plain version for a CPU one.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import current_stream_handle
from . import _build

__all__ = ["moe_ffn_cuda", "LAUNCHES"]

# kernel launches since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"moe_ffn": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("moe_ffn").moe_ffn_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def moe_ffn_cuda(x_e, w_gate, w_up, w_down):
    """x_e (S, C, D), w_gate/w_up (S, D, F), w_down (S, F, D) → (S, C, D).

    All four on one CUDA device, contiguous, float32 or bfloat16 and of
    one dtype; in bfloat16, D and F multiples of 8 and the data 16-byte
    aligned. Anything else raises.
    """
    ts = (x_e, w_gate, w_up, w_down)
    if not all(t.is_cuda and t.device == x_e.device for t in ts):
        raise ValueError("moe_ffn_cuda: all operands must be on one CUDA device")
    if x_e.dtype not in _DTYPE_CODE or any(t.dtype != x_e.dtype for t in ts):
        raise TypeError(
            f"moe_ffn_cuda: float32 or bfloat16, all one dtype; got "
            f"{[str(t.dtype) for t in ts]}"
        )
    if x_e.dim() != 3 or w_gate.dim() != 3:
        raise ValueError("moe_ffn_cuda: x_e (S, C, D), weights (S, D, F)")
    S, C, D = x_e.shape
    F = w_gate.shape[-1]
    if (
        tuple(w_gate.shape) != (S, D, F)
        or tuple(w_up.shape) != (S, D, F)
        or tuple(w_down.shape) != (S, F, D)
    ):
        raise ValueError(
            f"moe_ffn_cuda: shapes x {tuple(x_e.shape)}, w_gate "
            f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, w_down "
            f"{tuple(w_down.shape)} do not agree"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("moe_ffn_cuda: operands must be contiguous")
    if x_e.dtype == torch.bfloat16 and (
        D % 8 or F % 8 or any(t.data_ptr() % 16 for t in ts)
    ):
        # the tensor-core path copies 16-byte chunks of 8 values
        raise ValueError(
            f"moe_ffn_cuda: bfloat16 needs D and F multiples of 8 and "
            f"16-byte aligned operands; got D={D}, F={F}"
        )
    y = torch.empty_like(x_e)
    if y.numel() == 0 or F == 0:
        return y.zero_()
    h = torch.empty((S, C, F), dtype=x_e.dtype, device=x_e.device)
    stream = current_stream_handle(x_e.device)
    err = _launcher()(
        x_e.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        h.data_ptr(), y.data_ptr(), S, C, D, F, _DTYPE_CODE[x_e.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"moe_ffn kernel launch failed: CUDA error {err}")
    LAUNCHES["moe_ffn"] += 1
    return y
