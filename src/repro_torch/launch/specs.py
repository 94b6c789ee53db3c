"""``input_specs()``: meta-device stand-ins for every step the dry run runs.

The port's counterpart of ``repro/launch/specs.py``. Where the JAX package
hands ``jax.ShapeDtypeStruct``s with shardings to ``jit(...).lower``, the
port builds the same trees of tensors on ``torch.device("meta")``: shapes
and dtypes only, nothing allocated, nothing drawn. The leaf paths, shapes
and dtypes are the JAX trees' (``tests/test_torch_dryrun.py`` holds them
against ``repro.launch.specs.input_specs(..., host_policy())`` on every
applicable cell).

Under a ``policy`` with a mesh (a :class:`~repro_torch.launch.meta_mesh.
MetaMesh` at one rank of a production mesh, in the dry run) every tree is
**one rank's**: the parameters and moments in their shards
(:func:`~repro_torch.sharding.param_specs`), the caches in the rank's rows
(:func:`~repro_torch.models.model.decode_cache_rows`), heads and block of
positions (:func:`~repro_torch.sharding.kv_shard`), and the batch in the
rank's rows over the batch axes: the shapes of JAX's
``NamedSharding.shard_shape`` of the same cell
(``tests/test_torch_dryrun_mesh.py``).

Per shape kind:

* train_*    → ``train_step(state, batch[, placements])``
* prefill_*  → ``prefill(params, batch[, placements])``
* decode_* / long_* → ``decode_step(params, caches, cur_len, tokens[,
  placements])`` on the *dense* caches of ``init_decode_cache`` (one
  panel or ring per slot, as the JAX dry run lowers it; not the serving
  engine's paged pool)

Modality frontends are stubbed as in the JAX package: vision batches carry
precomputed patch embeddings (B, P, D); audio tokens are the code stream.

One leaf differs in where it lives, not in its shape or dtype: the
optimizer's ``step`` count is a CPU int32 scalar, as in the port's train
state (the update reads it without a device sync; see
:func:`repro_torch.training.optimizer.adamw_init`).
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..models.model import decode_cache_rows, init_decode_cache, init_params
from ..tree import tree_map

__all__ = [
    "abstract_params",
    "batch_rows",
    "abstract_opt_state",
    "abstract_state",
    "cache_specs",
    "batch_specs",
    "placement_specs",
    "input_specs",
]

META = torch.device("meta")


def abstract_params(config: ModelConfig, dtype=torch.bfloat16, policy=None):
    """The parameter tree on meta: :func:`init_params`'s shapes (a rank's
    shards under ``policy``), no draw."""
    return init_params(config, device=META, dtype=dtype, policy=policy)


def abstract_opt_state(param_shapes) -> dict[str, Any]:
    """AdamW's state around ``param_shapes``: fp32 ``mu`` and ``nu`` on meta
    and the int32 ``step`` count on the host."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device=META)

    return {
        "mu": tree_map(f32, param_shapes),
        "nu": tree_map(f32, param_shapes),
        "step": torch.zeros((), dtype=torch.int32),
    }


def abstract_state(config: ModelConfig, dtype=torch.bfloat16, policy=None):
    """The train state ``{params, opt{mu, nu, step}}`` on meta (a rank's
    under ``policy``)."""
    params = abstract_params(config, dtype, policy)
    return {"params": params, "opt": abstract_opt_state(params)}


def cache_specs(config: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, policy=None):
    """The dense decode caches of ``batch`` slots of ``max_len`` positions:
    ``{"attn": {"k", "v"}}``, ``{"ssm": {…}}``, or for the hybrid
    ``{"ssm_staged", "attn"[, "ssm_tail"]}``; a rank's rows, heads and
    positions of them under ``policy``."""
    rows = decode_cache_rows(policy, batch)
    if rows is not None:
        batch = rows.stop - rows.start
    return init_decode_cache(config, batch, max_len, device=META, dtype=dtype,
                             policy=policy)


def batch_rows(policy, batch: int) -> int:
    """The rows of a ``batch``-row input a rank holds: its block over the
    policy's batch axes (JAX's ``P(policy.batch, …)``), all of them
    without a mesh or batch axes. Raises where they do not divide."""
    if policy is None or policy.mesh is None or not policy.batch_axes:
        return batch
    d = policy.data_axis_size
    if batch % d:
        raise ValueError(f"a batch of {batch} rows does not shard over "
                         f"{policy.batch_axes!r} ({d} ranks)")
    return batch // d


def batch_specs(config: ModelConfig, shape: ShapeSpec,
                policy=None) -> dict[str, Any]:
    """A training or prefill batch: ``tokens`` (B, S − P) int32 after the
    vision frontend's P patch embeddings ``patches`` (B, P, D) bf16; for
    training ``labels`` (B, S) int32 and, with the vision frontend, a
    ``loss_mask`` (B, S) fp32. Under ``policy`` B is the rank's rows
    (:func:`batch_rows`)."""
    B, S = batch_rows(policy, shape.global_batch), shape.seq_len
    P_tok = S
    out: dict[str, Any] = {}
    if config.frontend == "vision":
        P_tok = S - config.num_patches
        out["patches"] = torch.empty((B, config.num_patches, config.d_model),
                                     dtype=torch.bfloat16, device=META)
    out["tokens"] = torch.empty((B, P_tok), dtype=torch.int32, device=META)
    if shape.kind == "train":
        out["labels"] = torch.empty((B, S), dtype=torch.int32, device=META)
        if config.frontend == "vision":
            out["loss_mask"] = torch.empty((B, S), dtype=torch.float32,
                                           device=META)
    return out


def placement_specs(config: ModelConfig):
    """The (L, E_v) int32 expert→slot tables of a MoE config."""
    return torch.empty((config.num_layers, config.num_virtual_experts),
                       dtype=torch.int32, device=META)


def input_specs(config: ModelConfig, shape: ShapeSpec, policy=None, *,
                dtype=torch.bfloat16) -> dict[str, Any]:
    """The keyword arguments of the step of ``shape.kind`` (see
    :func:`repro_torch.launch.dryrun.build_step_fn`), on meta: one rank's
    under ``policy``; the parameters and caches in ``dtype`` (JAX's dry
    run: bf16)."""
    if shape.kind == "train":
        out = {"state": abstract_state(config, dtype, policy),
               "batch": batch_specs(config, shape, policy)}
    elif shape.kind == "prefill":
        out = {"params": abstract_params(config, dtype, policy),
               "batch": batch_specs(config, shape, policy)}
    elif shape.kind == "decode":
        B = batch_rows(policy, shape.global_batch)
        out = {
            "params": abstract_params(config, dtype, policy),
            "caches": cache_specs(config, shape.global_batch, shape.seq_len,
                                  dtype, policy),
            "cur_len": torch.empty((), dtype=torch.int32, device=META),
            "tokens": torch.empty((B, 1), dtype=torch.int32, device=META),
        }
    else:
        raise ValueError(shape.kind)
    if config.is_moe:
        out["placements"] = placement_specs(config)
    return out
