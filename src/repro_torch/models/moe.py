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

**Backends.** ``ModelConfig.moe_backend`` (or the layer's ``backend``
argument, which wins) takes the JAX package's three names
(:data:`~repro_torch.configs.base.MOE_BACKENDS`). ``"einsum"`` and
``"pallas"`` both run the staged plane, whose kernels the tensor's device
picks (K1 and K2 on the card). ``"dense_ref"`` is the capacity-free
oracle: the router (K2 on the card) and then
:func:`~repro_torch.models.dispatch.dense_mix`, every expert on every
token, with no dispatch, so no assignment is dropped, overflows or is
shed; the router's statistics still flow, so GEM's Step-1 trace and the
engine's telemetry keep running.

**Under a policy with a mesh** (:mod:`repro_torch.sharding`): each rank
stores the slots ``[d·S/m, (d+1)·S/m)`` of the pool, d its model-axis
position (:func:`~repro_torch.sharding.local_expert_slots`; a pool the
axis does not divide is stored whole), and the router tables name global
slots. Under FSDP each rank also stores its block of ``d_model`` of each
slot's rows (JAX's ``w_expert`` spec), gathered whole over ``data`` a
layer at a time before K1 runs (:func:`~repro_torch.models.model.
decode_step` and the training stack), so K1 always sees whole ``D`` and
``F`` on the rank's slots, as under JAX's ``shard_map``. The dispatch
groups shard over the data axes, and :func:`apply_layer_permutation`
moves rows between ranks as collectives
(:mod:`repro_torch.kernels.collective`): under FSDP each rank moves its
``d_model`` block of the rows within its data row.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..configs.base import MOE_BACKENDS, ModelConfig
from ..kernels.sharded import gather_cat, gather_over, take_block
from ..sharding.policy import model_axis
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
    "resolve_moe_backend",
    "MoEAux",
]


def resolve_moe_backend(backend: str | None, config: ModelConfig,
                        policy=None) -> str:
    """Effective backend for this call: explicit arg > config."""
    del policy  # kept in the signature, as the JAX package keeps it
    backend = backend if backend is not None else config.moe_backend
    if backend not in MOE_BACKENDS:
        raise ValueError(f"moe_backend={backend!r} not in {MOE_BACKENDS}")
    return backend


def init_moe(config: ModelConfig, *, num_layers: int, dtype, device,
             generator: torch.Generator, shard=None):
    """Random MoE weights. ``shard``, given a leaf's name, returns the
    function that keeps a rank's block of one layer of it (its slots of
    the pool, and under FSDP its block of ``d_model``), or None for a
    whole leaf: each such expert stack is drawn a layer at a time and
    keeps only that block of each layer
    (:func:`~repro_torch.models.layers.normal_init` with ``keep``), so no
    rank holds a whole stack."""
    D = config.d_model
    E = config.num_experts
    Ev = config.num_virtual_experts
    Fv = config.expert_d_ff // config.expert_tp
    s_in = float(1.0 / np.sqrt(D))
    s_out = float(1.0 / np.sqrt(config.expert_d_ff))

    def normal(shape, scale, name=None):
        keep = None if name is None or shard is None else shard(name)
        return normal_init(shape, scale, dtype=dtype, device=device,
                           generator=generator, keep=keep)

    return {
        "router": normal((num_layers, D, E), s_in),
        "w_gate": normal((num_layers, Ev, D, Fv), s_in, "w_gate"),
        "w_up": normal((num_layers, Ev, D, Fv), s_in, "w_up"),
        "w_down": normal((num_layers, Ev, Fv, D), s_out, "w_down"),
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
                            via: str = "host", policy=None,
                            stats_out: list | None = None):
    """Apply one layer's row-source map to the stacked expert rows: row
    ``s`` ← old row ``perm[s]`` (the online plane's partial placement
    application, between decode steps). Returns a new dict whose three
    expert weights are new tensors; ``moe_params`` is left as it was.

    ``via``: ``"host"`` is one row gather per weight. ``"collective"``
    moves the rows over the policy's model axis
    (:func:`~repro_torch.kernels.collective.apply_row_sources`: a local
    pre-batch gather, then the schedule's rounds as paired send/recv) and
    appends the executed schedule's
    :class:`~repro_torch.kernels.collective.CollectiveStats` to
    ``stats_out``. Without a live expert sharding (no mesh, a 1-wide model
    axis, an indivisible slot count) it warns once and takes the host
    gather, bit for bit, appending nothing, as the JAX version does. A
    pool sharded over ranks moves over the axis under either ``via``
    (no rank holds the rows another needs); only ``"collective"``
    reports what crossed.
    """
    if via not in ("host", "collective"):
        raise ValueError(f"via={via!r} not in ('host', 'collective')")
    names = ("w_gate", "w_up", "w_down")
    num_slots = len(np.asarray(perm))  # the map names global slots
    axis = None if policy is None else policy.expert_collective_axis(num_slots)
    if via == "collective" and axis is None:
        _warn_once(
            ("collective_fallback", num_slots),
            "apply_layer_permutation(via='collective'): no live expert "
            "sharding (mesh absent, 1-wide model axis, or slot count "
            f"{num_slots} not divisible) — falling back to the host row "
            "gather",
        )
    out = dict(moe_params)
    if axis is not None:
        from ..kernels.collective import apply_row_sources

        arrays = tuple(moe_params[n][layer] for n in names)
        new_arrays, stats = apply_row_sources(arrays, perm, mesh=policy.mesh,
                                              axis=axis)
        if via == "collective" and stats_out is not None:
            stats_out.append(stats)
        for name, a in zip(names, new_arrays):
            new = moe_params[name].clone()
            new[layer] = a
            out[name] = new
        return out
    for name in names:
        w = moe_params[name]
        rows = torch.as_tensor(np.asarray(perm), device=w.device).long()
        new = w.clone()
        new[layer] = w[layer].index_select(0, rows)
        out[name] = new
    return out


def moe_layer(x, p, expert_to_slot, config: ModelConfig, policy=None, *,
              capacity_factor: float | None = None, shed_enable=None,
              global_batch: int | None = None, num_slots: int | None = None,
              seq_sharded: bool = False, backend: str | None = None):
    """x (B, T, D) → (y (B, T, D), :class:`MoEAux`) for one layer's params
    ``p`` and its (E_v,) ``expert_to_slot`` table or (E_v, P) replica-split
    table. ``shed_enable`` (a 0/1 scalar tensor, or None to leave the pass
    out) turns on the shed pass of :func:`build_dispatch`.

    Dispatch is grouped by data shard, as in JAX: ``Gd`` is the policy's
    data-axis size when it divides the batch, else 1 (warned once under a
    mesh). ``global_batch`` is the batch over all data ranks when ``x``
    holds only this rank's rows (the model's decode step passes its
    ``B/d`` rows); with None, ``x`` is the whole batch and, when the groups
    shard, the layer computes its own group's rows and all-gathers ``y``
    over the data axes. Either way the aux counts are the totals over all
    groups, the same on every rank. Training hands the layer its rows with
    ``global_batch`` set, as JAX shards the batch
    (:func:`~repro_torch.models.model.forward_train`); under a gradient
    the gather of ``y`` gives each rank its own rows' cotangent back
    (:func:`~repro_torch.kernels.sharded.gather_over`).

    ``num_slots`` is the pool's global slot count S. With None it is the
    rows ``p`` holds, which is S wherever the pool is whole; under a
    model axis wider than 1 it must be given, since a rank's S/m rows of a
    sharded pool cannot be told from a whole pool by their count.

    ``seq_sharded``: x holds this rank's block of the sequence over the
    model axis (a sequence-parallel region). The layer is then one
    replicated region: the blocks are gathered over the axis in front of
    the router (the gather's adjoint keeps the rank's rows), every rank
    runs the same dispatch on the whole sequence (capacity and drops are
    decided over the whole group), and the rank's block of the output is
    taken after it (the take's adjoint gathers the cotangent's rows), so
    that the backward inside the region sees the whole cotangent on every
    rank, as the sharded kernels' adjoints expect (JAX's
    ``seq_sharded_out``).

    ``backend`` overrides ``config.moe_backend`` for this call
    (:func:`resolve_moe_backend`). With ``"dense_ref"`` the layer routes,
    then mixes every expert's output (:func:`~repro_torch.models.dispatch.
    dense_mix`) under the same grouping over data and the same sequence
    gather; its aux has ``dropped`` 0.0, no dropped, overflow or shed
    assignment and a zero ``shed_delta``, as JAX's oracle reports, and
    ``capacity_factor`` and ``shed_enable`` have nothing to act on."""
    backend = resolve_moe_backend(backend, config, policy)
    axis = model_axis(policy) if seq_sharded else None
    if axis is not None:
        x = gather_cat(x, policy.mesh, axis, 1)
        y, aux = moe_layer(x, p, expert_to_slot, config, policy,
                           capacity_factor=capacity_factor,
                           shed_enable=shed_enable, global_batch=global_batch,
                           num_slots=num_slots, backend=backend)
        return take_block(y, policy.mesh, axis, 1), aux
    B, T, D = x.shape
    # `is None`, not falsy-or: an explicit 0.0 means "minimum capacity"
    cf = capacity_factor if capacity_factor is not None else config.capacity_factor
    mesh = None if policy is None else policy.mesh
    B_all = B if global_batch is None else global_batch
    Gd = 1 if policy is None else policy.data_axis_size
    if B_all % Gd:
        _warn_once(
            ("gd_collapse", B_all, Gd),
            f"moe_layer: batch B={B_all} does not divide the data-axis "
            f"size Gd={Gd}; collapsing to Gd=1 — data-parallel dispatch "
            "grouping is lost and every data rank computes the whole batch",
        )
        Gd = 1
    Ev = config.num_virtual_experts
    data_spec = None if mesh is None else policy.moe_shard_spec(Gd, Ev)[0]
    gather_out = False
    G = Gd
    if data_spec is not None:
        G = 1  # Gd groups over Gd = d data ranks
        if global_batch is None:  # the whole batch: keep this group's rows
            rows = B // Gd
            lo = mesh.index(data_spec) * rows
            x = x[lo:lo + rows]
            gather_out = True
    xg = x.reshape(G, -1, D)
    router = route(xg, p["router"], config, policy, groups=Gd)
    S = num_slots
    if S is None:
        if mesh is not None and policy.model_axis_size > 1:
            raise ValueError(
                "moe_layer: num_slots must be given under a model axis of "
                f"size {policy.model_axis_size} (a rank stores S/m rows of "
                "a pool the axis divides, all S of one it does not)")
        S = int(p["w_gate"].shape[0])
    if backend == "dense_ref":
        y = dense_mix(xg, p, router, expert_to_slot, config, policy,
                      num_slots=S).reshape(x.shape)
        if gather_out:
            y = gather_over(y, mesh, data_spec).reshape(B, T, D)
        zero = torch.zeros((), dtype=torch.int32, device=x.device)
        return y, MoEAux(
            expert_counts=router.expert_counts,
            aux_loss=router.aux_loss,
            dropped=torch.zeros((), dtype=torch.float32, device=x.device),
            dropped_tokens=zero,
            overflow_tokens=zero,
            shed_tokens=zero,
            shed_delta=torch.zeros((S,), dtype=torch.int32, device=x.device),
        )
    plan = build_dispatch(
        router, expert_to_slot, config, policy, capacity_factor=cf,
        num_slots=S, shed_enable=shed_enable, groups=Gd,
    )
    y_e = expert_compute(xg, plan, p, config, policy, groups=Gd)
    y = combine(y_e, plan, tuple(x.shape))
    if gather_out:  # the backward keeps this group's rows' cotangent
        y = gather_over(y, mesh, data_spec).reshape(B, T, D)
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
    table = identity_placement(config, 1, device=x.device)[0]
    return moe_layer(x, p, table, config, backend="dense_ref")[0]
