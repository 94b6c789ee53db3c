"""Mixture-of-Experts layer with GEM placement (port of ``repro/models/moe.py``).

Expert weights are stacked ``(L, E_v, D, F_v)`` / ``(L, E_v, F_v, D)`` with
``E_v = num_experts · expert_tp`` virtual experts, each an F-slice of a
real expert. A placement is a permutation of virtual-expert *slots*: slot
``s`` holds virtual expert ``slot_to_expert[s]``. The weights are permuted
once (:func:`apply_placement`) and the router's choice is remapped through
the (E_v,) ``expert_to_slot`` table, so outputs do not depend on the
placement; only where each expert's tokens land does.

Under the replication plane the pool has S = E_v + G·replica_slots rows a
layer (``slot_to_expert`` repeats the experts that have copies) and the
router remaps through an (E_v, P) replica-split table; the layer reads S
off the stacked weights, so one code path serves both pools.

:func:`moe_layer` composes the four stages of
:mod:`repro_torch.models.dispatch`.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..configs.base import ModelConfig
from .dispatch import (
    MoEAux,
    build_dispatch,
    combine,
    dense_mix,
    expert_compute,
    route,
)
from .layers import normal_init

__all__ = [
    "init_moe",
    "moe_layer",
    "apply_placement",
    "apply_layer_permutation",
    "identity_placement",
    "moe_layer_dense_ref",
    "MoEAux",
]


def init_moe(config: ModelConfig, *, num_layers: int, dtype, device,
             generator: torch.Generator):
    D = config.d_model
    E = config.num_experts
    Ev = config.num_virtual_experts
    Fv = config.expert_d_ff // config.expert_tp
    s_in = float(1.0 / np.sqrt(D))
    s_out = float(1.0 / np.sqrt(config.expert_d_ff))

    def normal(shape, scale):
        return normal_init(shape, scale, dtype=dtype, device=device,
                           generator=generator)

    return {
        "router": normal((num_layers, D, E), s_in),
        "w_gate": normal((num_layers, Ev, D, Fv), s_in),
        "w_up": normal((num_layers, Ev, D, Fv), s_in),
        "w_down": normal((num_layers, Ev, Fv, D), s_out),
    }


def identity_placement(config: ModelConfig, num_layers: int, *,
                       device=None) -> torch.Tensor:
    """(L, E_v) expert→slot tables of the linear layout."""
    Ev = config.num_virtual_experts
    return torch.arange(Ev, dtype=torch.int32, device=device).repeat(
        num_layers, 1
    )


def apply_placement(moe_params, slot_to_expert):
    """Gather the stacked expert weights into placement order: slot ``s``
    of layer ``l`` takes virtual expert ``slot_to_expert[l, s]``. The
    (L, S) map may repeat experts (S > E_v), which expands the pool into
    a replicated one."""
    out = dict(moe_params)
    for name in ("w_gate", "w_up", "w_down"):
        w = moe_params[name]
        s2e = torch.as_tensor(slot_to_expert, device=w.device).long()
        out[name] = torch.take_along_dim(w, s2e[:, :, None, None], dim=1)
    return out


_WARNED: set = set()


def _warn_once(key, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def apply_layer_permutation(moe_params, layer: int, perm, *,
                            via: str = "host", stats_out: list | None = None):
    """Apply one layer's row-source map to the stacked expert rows: row
    ``s`` ← old row ``perm[s]`` (the online plane's partial placement
    application, between decode steps). Returns a new dict whose three
    expert weights are new tensors; ``moe_params`` is left as it was.

    ``via``: ``"host"`` is one row gather per weight. ``"collective"`` asks
    for the exchange over an interconnect; one card has no expert
    sharding, so it warns once and takes the same gather, bit for bit,
    and appends nothing to ``stats_out`` — what the JAX version does when
    its policy has no live expert sharding. (The serving engine rewrites
    its pool in place through
    :class:`~repro_torch.kernels.collective.MigrationExecutable` instead.)
    """
    if via not in ("host", "collective"):
        raise ValueError(f"via={via!r} not in ('host', 'collective')")
    names = ("w_gate", "w_up", "w_down")
    if via == "collective":
        num_slots = int(moe_params[names[0]].shape[1])
        _warn_once(
            ("collective_fallback", num_slots),
            "apply_layer_permutation(via='collective'): no live expert "
            "sharding (one card) — falling back to the host row gather",
        )
    out = dict(moe_params)
    for name in names:
        w = moe_params[name]
        rows = torch.as_tensor(np.asarray(perm), device=w.device).long()
        new = w.clone()
        new[layer] = w[layer].index_select(0, rows)
        out[name] = new
    return out


def moe_layer(x, p, expert_to_slot, config: ModelConfig, *,
              capacity_factor: float | None = None, shed_enable=None):
    """x (B, T, D) → (y (B, T, D), :class:`MoEAux`) for one layer's params
    ``p`` and its (E_v,) ``expert_to_slot`` table or (E_v, P) replica-split
    table. One dispatch group (a single device), so Gd = 1.
    ``shed_enable`` (a 0/1 scalar tensor, or None to leave the pass out)
    turns on the shed pass of :func:`build_dispatch`."""
    B, T, D = x.shape
    # `is None`, not falsy-or: an explicit 0.0 means "minimum capacity"
    cf = capacity_factor if capacity_factor is not None else config.capacity_factor
    xg = x.reshape(1, B * T, D)
    router = route(xg, p["router"], config)
    plan = build_dispatch(
        router, expert_to_slot, config, capacity_factor=cf,
        num_slots=int(p["w_gate"].shape[0]), shed_enable=shed_enable,
    )
    y_e = expert_compute(xg, plan, p, config)
    y = combine(y_e, plan, (B, T, D))
    return y, MoEAux(
        expert_counts=router.expert_counts,
        aux_loss=router.aux_loss,
        dropped=plan.dropped,
        dropped_tokens=plan.dropped_tokens,
        overflow_tokens=plan.overflow_tokens,
        shed_tokens=plan.shed_tokens,
        shed_delta=plan.shed_delta,
    )


def moe_layer_dense_ref(x, p, config: ModelConfig):
    """Oracle: every expert on every token, mixed (capacity-free, weights in
    identity placement)."""
    B, T, D = x.shape
    xg = x.reshape(1, B * T, D)
    router = route(xg, p["router"], config)
    table = identity_placement(config, 1, device=x.device)[0]
    return dense_mix(xg, p, router, table, config).reshape(B, T, D)
