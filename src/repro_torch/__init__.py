"""PyTorch/CUDA port of the GEM MoE serving system.

A package of its own beside the JAX reference (``repro``), with the same
module layout. It imports torch and numpy, never JAX and nothing of
``repro``. Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a CUDA tensor always goes through the hand-written
Hopper kernels (:mod:`repro_torch.kernels`), a CPU tensor through their
plain PyTorch versions.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
