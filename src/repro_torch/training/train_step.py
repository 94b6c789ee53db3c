"""Training step: loss → grads → AdamW, with gradient accumulation and
compression (port of ``repro/training/train_step.py``).

The state is the JAX layout, ``{"params", "opt": {"mu", "nu", "step"},
["ef_residual"]}``, so that checkpoint paths match across the packages.
The step runs autograd over :func:`repro_torch.models.loss_fn` (through
the kernels' ``torch.autograd.Function``s in the MoE layers) and updates
the state in place. MoE configs take the (L, E_v) placement tables and
report per-layer expert counts, GEM's Step-1 trace, as in serving.

**Under a policy with a mesh** (JAX's ``make_train_step(config, policy,
…)``) each rank keeps its shard of every leaf, with its gradients and
moments (:func:`~repro_torch.sharding.param_specs`: its experts, its
columns or rows of the projections, its vocabulary). Each rank runs the
backward of its tokens' share of the global loss
(:func:`~repro_torch.models.loss_fn` under the policy; its rows of the
batch and, under a model axis, its block of the sequence); then, once a
step and after accumulation, every leaf's gradient is summed over the
data axes in fp32 (:func:`_reduce_grads`). Under FSDP (ZeRO-3:
``policy.fsdp``, which ``policy_for(mesh, step_kind="train")`` sets) the
projections, the vocabulary and the expert stacks are also stored over
``data``, with their moments: the model gathers a layer's blocks before
it runs, and the gathers' adjoints reduce-scatter the gradients, which
arrive complete and in the leaves' layout (never whole). The update runs
on the rank's own leaves, with the global gradient norm
(:func:`~repro_torch.training.optimizer.adamw_update`).
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..models.model import loss_fn
from ..sharding.policy import is_expert_leaf, param_specs, spec_axes
from ..tree import leaf_paths, leaves, leaves_along, tree_map, unflatten
from .optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_state_specs,
    adamw_update,
    compress_grads,
)

__all__ = ["init_train_state", "make_train_step", "train_state_specs"]


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


def train_state_specs(state, policy, config, *,
                      num_slots: int | None = None):
    """The specs of a train state's leaves, mirroring it: ``config``'s
    parameters' (:func:`~repro_torch.sharding.param_specs`, of a rank's
    own tensors with the pool's global ``num_slots``), the same for the
    moments and the error-feedback residual, and a whole step count. What
    :meth:`~repro_torch.checkpoint.CheckpointManager.save` and
    ``restore_sharded`` take under a mesh."""
    specs = param_specs(state["params"], policy, config,
                        num_slots=num_slots)
    out = {"params": specs, "opt": adamw_state_specs(specs)}
    if "ef_residual" in state:
        out["ef_residual"] = specs
    return out


def make_train_step(config: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    *, policy=None, accum_steps: int = 1, remat: bool = True,
                    mark=None):
    """Returns ``train_step(state, batch, placements=None) → (state,
    metrics)``; the state is updated in place and returned.

    ``batch`` is a dict of tensors (``tokens``, ``labels``, optional
    ``patches`` and ``loss_mask``). ``accum_steps > 1`` splits it on the
    leading axis into microbatches whose fp32 gradients are summed and
    divided once, where JAX runs a ``lax.scan``; the loss is their mean and
    the aux the last microbatch's. The metrics are ``loss``, ``grad_norm``
    (device scalars) and ``lr`` (a float), plus ``moe_dropped`` and
    ``expert_counts`` (L, E) for MoE configs.

    ``policy``: a :class:`~repro_torch.sharding.ShardingPolicy`. With a
    mesh every rank passes the whole global batch and the state of its
    own leaves (``init_train_state`` of the rank's parameters); the
    metrics are the global ones, the same on every rank. Without one,
    the MoE layers dispatch in its ``data_axis_size`` groups.

    ``mark``, if given, is called with ``"forward"``, ``"backward"`` and
    ``"update"`` as each part of the step has been queued (a profiler's
    hook: the caller may record a CUDA event there)."""
    mesh = None if policy is None else policy.mesh
    num_slots = config.num_virtual_experts if config.is_moe else None

    def note(name):
        if mark is not None:
            mark(name)

    def grads_of(params, batch, placements):
        loss, aux = loss_fn(params, batch, config, placements, remat=remat,
                            policy=policy, num_slots=num_slots)
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
        specs = None
        if mesh is not None:
            specs = param_specs(params, policy, config, num_slots=num_slots)
            grads = _reduce_grads(list(grads), params, specs, policy)
        grads = unflatten(params, list(grads))
        if opt_cfg.compress:
            grads, _ = compress_grads(grads, state["ef_residual"],
                                      opt_cfg.compress_bits, policy=policy,
                                      specs=specs)
        _, _, opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg,
                                         policy=policy, specs=specs)
        del grads
        note("update")
        metrics = {"loss": loss, **opt_metrics}
        if config.is_moe and aux:
            metrics["moe_dropped"] = aux["dropped"].detach()
            metrics["expert_counts"] = aux["expert_counts"]
        return state, metrics

    return train_step


def _reduce_grads(grads: list, params, specs, policy) -> list:
    """Sum each rank's gradients (in :func:`leaves` order) over the ranks
    that hold the leaf alike, fp32, in rank order, one leaf at a time.
    Each leaf's case follows from where the forward uses it:

    * a leaf stored over ``data`` (FSDP, ZeRO-3) arrives summed over the
      data ranks already, by the adjoints of its gathers
      (:func:`~repro_torch.kernels.sharded.gather_fsdp`), and is not
      summed over ``data`` again;
    * a leaf sharded over the model axis (the projections, the vocabulary,
      the expert slots) is complete on its rank once the adjoints of its
      gathers have summed the model ranks' shares
      (:mod:`repro_torch.kernels.sharded`): summed over the data axes only;
    * a whole-stored expert stack (a pool the model axis does not divide),
      whose rows each model rank computes apart: summed over the model
      axis too;
    * a whole leaf applied to a rank's block of the sequence (the norm
      scales under sequence parallelism) arrives summed over every rank's
      rows already, by its use's adjoint (``scale_rows``); a whole leaf
      inside a replicated region (the router, and every whole leaf where
      every rank runs every row) arrives whole on every model rank.
      Either way the model ranks hold the same gradient, but on a card a
      backward that adds with atomics (the gathers', the embedding's) may
      part their last bits, and replicas updated from them would part: it
      is taken from the axis's first rank on all of them (a broadcast: the
      same bits on the CPU), then summed over the data axes."""
    mesh = policy.mesh
    data = tuple(policy.batch_axes) if policy.data_axis_size > 1 else ()
    model = policy.model_axis if policy.model_axis_size > 1 else None
    out = []
    for path, spec, g in zip(leaf_paths(params), leaves_along(params, specs),
                             grads):
        named = spec_axes(spec)
        axes = tuple(a for a in data if a not in named)
        if model and model not in named:
            if is_expert_leaf(path):
                axes += (model,)
            else:
                g = mesh.broadcast(g, model)
        if axes:
            g = mesh.all_reduce(g, axes, dtype=torch.float32)
        out.append(g)
    return out
