"""Where the port's entry points run: the card, unless the caller asks for
the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "current_stream_handle"]


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA device, and an error when there is none: the
    port never carries on on the CPU unless ``device="cpu"`` is passed.
    ``"meta"`` (shapes and dtypes only, nothing allocated, nothing
    computed) is taken when asked for by name: the dry run
    (:mod:`repro_torch.launch.dryrun`) runs the step functions there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def current_stream_handle(device: torch.device) -> int:
    """The ``cudaStream_t`` of PyTorch's current stream on a CUDA device, as
    an int for a kernel launch. The raw binding skips building a
    ``torch.cuda.Stream`` object, which costs more host time than a small
    kernel's whole launch."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
