"""Token sampling for the serving engine."""
from __future__ import annotations

import torch

__all__ = ["sample"]


def sample(logits, *, temperature: float = 0.0,
           generator: torch.Generator | None = None):
    """logits (B, V) → token ids (B,) int32. Temperature 0 is greedy (the
    first maximum wins, as ``jnp.argmax``). A positive temperature draws
    from ``generator``; its numbers are torch's, not JAX's, so sampled
    streams are not held to parity with the JAX engine."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling with temperature needs a torch.Generator")
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
