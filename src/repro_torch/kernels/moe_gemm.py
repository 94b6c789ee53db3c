"""Grouped SwiGLU expert FFN on the card: the wrapper of ``csrc/moe_ffn.cu``.

The CUDA kernels replace the TPU kernel ``repro/kernels/moe_gemm.py::
_ffn_kernel``; their design notes are in the sources. A bfloat16 call of
C token rows a slot runs one of two designs, picked inside the library by
one compile-time threshold, C_MIN (:func:`wgmma_min_c`, 33): below it the
``mma.sync`` kernels of ``moe_ffn.cu``, tuned for decode; from it the
``wgmma``/TMA kernels of ``csrc/moe_ffn_wgmma.cuh`` (128-row tiles, for
prefill and training; Mixtral's 4k prefill is bound by operations).
:func:`kernel_path` names the path a call takes, and such a call also adds
one to the ``"moe_ffn_wgmma"`` launch count beside ``"moe_ffn"``. float32
has one path. This wrapper checks what the kernels take, allocates the
output and the hidden scratch, and launches on PyTorch's current stream;
a launch or tensor-map failure raises. Callers normally go through
:func:`repro_torch.kernels.ops.moe_ffn`, which picks the kernel for a CUDA
tensor and the plain version for a CPU one.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import current_stream_handle
from . import _build, launches

__all__ = ["kernel_path", "moe_ffn_cuda", "wgmma_min_c"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_min_c = None


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


def wgmma_min_c() -> int:
    """The fewest token rows a slot (C) from which a bfloat16 call runs the
    wgmma/TMA kernels; below it, the mma.sync kernels. A compile-time
    constant of ``csrc/moe_ffn_wgmma.cuh``, read from the built library."""
    global _min_c
    if _min_c is None:
        fn = _build.load("moe_ffn").moe_ffn_wgmma_min_c
        fn.argtypes = []
        fn.restype = ctypes.c_int
        _min_c = int(fn())
    return _min_c


def kernel_path(dtype, C: int) -> str:
    """Which kernel a call of ``dtype`` with C token rows a slot launches:
    ``"wgmma"``, ``"mma.sync"`` (bfloat16) or ``"fp32"``."""
    if dtype != torch.bfloat16:
        return "fp32"
    return "wgmma" if C >= wgmma_min_c() else "mma.sync"


def _error(err: int) -> str:
    if err < 0:
        return f"TMA tensor map not encoded (code {err}: -1000 - CUresult)"
    return f"CUDA error {err}"


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
        raise RuntimeError(f"moe_ffn kernel launch failed: {_error(err)}")
    launches.count("moe_ffn")
    if kernel_path(x_e.dtype, C) == "wgmma":
        launches.count("moe_ffn_wgmma")
    return y
