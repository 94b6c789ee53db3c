"""Hand-written Hopper kernels, their plain versions, and device dispatch.

Modules are imported by name (``repro_torch.kernels.ops`` …); importing
this package builds nothing and needs no GPU.
"""
