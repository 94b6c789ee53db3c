"""Training step: loss → grads → AdamW, with gradient accumulation and
compression (port of ``repro/training/train_step.py``).

The state is the JAX layout, ``{"params", "opt": {"mu", "nu", "step"},
["ef_residual"]}``, so that checkpoint paths match across the packages.
The step runs autograd over :func:`repro_torch.models.loss_fn` (through
the kernels' ``torch.autograd.Function``s in the MoE layers) and updates
the state in place. MoE configs take the (L, E_v) placement tables and
report per-layer expert counts, GEM's Step-1 trace, as in serving.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..models.model import loss_fn
from ..tree import leaves, tree_map
from .optimizer import AdamWConfig, adamw_init, adamw_update, compress_grads

__all__ = ["init_train_state", "make_train_step"]


def init_train_state(params, cfg: AdamWConfig) -> dict[str, Any]:
    """The state around ``params`` (whose tensors it holds and the step
    updates): fp32 moments, the step count, and with ``cfg.compress`` the
    fp32 error-feedback residual."""
    state: dict[str, Any] = {"params": params, "opt": adamw_init(params)}
    if cfg.compress:
        state["ef_residual"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


def make_train_step(config: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    *, accum_steps: int = 1, remat: bool = True, mark=None):
    """Returns ``train_step(state, batch, placements=None) → (state,
    metrics)``; the state is updated in place and returned.

    ``batch`` is a dict of tensors (``tokens``, ``labels``, optional
    ``patches`` and ``loss_mask``). ``accum_steps > 1`` splits it on the
    leading axis into microbatches whose fp32 gradients are summed and
    divided once, where JAX runs a ``lax.scan``; the loss is their mean and
    the aux the last microbatch's. The metrics are ``loss``, ``grad_norm``
    (device scalars) and ``lr`` (a float), plus ``moe_dropped`` and
    ``expert_counts`` (L, E) for MoE configs.

    ``mark``, if given, is called with ``"forward"``, ``"backward"`` and
    ``"update"`` as each part of the step has been queued (a profiler's
    hook: the caller may record a CUDA event there)."""
    def note(name):
        if mark is not None:
            mark(name)

    def grads_of(params, batch, placements):
        loss, aux = loss_fn(params, batch, config, placements, remat=remat)
        note("forward")
        grads = torch.autograd.grad(loss, leaves(params))
        note("backward")
        return loss.detach(), aux, grads

    def train_step(state, batch, placements=None):
        params = state["params"]
        for p in leaves(params):
            p.requires_grad_(True)
        if accum_steps == 1:
            loss, aux, grads = grads_of(params, batch, placements)
        else:
            def micro(i):
                return {k: t.reshape(accum_steps, t.shape[0] // accum_steps,
                                     *t.shape[1:])[i]
                        for k, t in batch.items()}

            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves(params)]
            loss = 0.0
            for i in range(accum_steps):
                mloss, aux, mgrads = grads_of(params, micro(i), placements)
                for a, g in zip(acc, mgrads):
                    a.add_(g)
                loss = loss + mloss
                del mgrads
            loss = loss / accum_steps
            grads = [a.div_(accum_steps) for a in acc]
        grads = _unflatten(params, list(grads))
        if opt_cfg.compress:
            grads, _ = compress_grads(grads, state["ef_residual"],
                                      opt_cfg.compress_bits)
        _, _, opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg)
        del grads
        note("update")
        metrics = {"loss": loss, **opt_metrics}
        if config.is_moe and aux:
            metrics["moe_dropped"] = aux["dropped"].detach()
            metrics["expert_counts"] = aux["expert_counts"]
        return state, metrics

    return train_step


def _unflatten(skeleton, flat: list):
    """Leaves in :func:`leaves` order → ``skeleton``'s nesting."""
    if isinstance(skeleton, dict):
        return {k: _unflatten(skeleton[k], flat) for k in sorted(skeleton)}
    return flat.pop(0)
