"""Model assembly for every family: embed → layers → norm → logits.

Port of ``repro/models/model.py``. Parameters are a plain dict in the JAX
pytree's layout, per-layer weights stacked on a leading L dim::

    {"embed": (V_pad, D), "final_norm": (D,), ["lm_head": (D, V_pad)],
     "blocks": {"ln1", "ln2": (L, D), "attn": {"wq", "wk", "wv", "wo", …},
                "moe": {"router", "w_gate", "w_up", "w_down"}   # moe
                | "mlp": {"w_gate", "w_up", "w_down"}},          # dense
     # ssm / hybrid: "blocks": {"ln": (L, D), "ssm": {…}}
     # hybrid only: "shared": {"ln1", "ln2": (1, D), "attn", "mlp"}}

Families:

* dense / audio / vlm: [ln → attn → ln → mlp] × L (vlm: patch embeddings
  prepended to the token embeddings);
* moe: [ln → attn → ln → moe] × L, placement tables threaded;
* ssm: [ln → mamba2] × L;
* hybrid (zamba2): stages of ``attn_every`` mamba blocks, each followed by
  one *shared-weight* attention + MLP block (one weight copy, a KV cache per
  stage), then the leftover mamba blocks.

The layer stack is a Python loop over layers, the JAX package's
``"python"`` mode; :class:`DecodeGraph` is its ``"scan"`` mode: the same
decode step over static buffers, captured once as a CUDA graph and replayed
every step. Caches are updated in place.

Training (:func:`forward_train`, :func:`loss_fn`) and :func:`prefill` run
the same blocks over the full sequence (:func:`_stack_forward`); autograd
differentiates them, through the kernels' ``torch.autograd.Function``s in
the MoE layers. No train path reaches the decode steps' in-place writes.
Under a policy with a mesh each data rank trains on its rows of the
batch and :func:`loss_fn` returns JAX's global loss on every rank.

**Under a model axis** the attention families store the projections and
the vocabulary sharded (:func:`~repro_torch.sharding.param_specs`), and
prefill and training keep the residual stream sequence-sharded between
blocks, each model rank holding its block of S/M rows (M from
:func:`~repro_torch.models.attention.sequence_shards`: the axis's extent
where it divides S, else 1 and every rank runs every row). A whole leaf
applied to a rank's rows (the norm scales) would send back only its
rows' share of the gradient, so its use sums the gradient over every
rank's rows (:func:`~repro_torch.kernels.sharded.scale_rows`). The SSM
and hybrid families keep every leaf and cache whole.

**Under FSDP** (a policy with ``fsdp``, ZeRO-3) the same leaves are also
stored over ``data``. Each layer's blocks are gathered whole over
``data`` as the layer starts (:func:`_gather_layer`, inside the remat
body, so that the backward gathers again rather than keep them), and the
embedding and the head as the step starts: a stacked leaf is never
gathered whole, and the model-axis code runs on the gathered layer as
before. The gathers' adjoints reduce-scatter the gradients, so that each
leaf's gradient leaves the backward complete and sharded. Under
replicated-activation decode (``batch_axes=()``, the cache's rows over
``cache_batch_axes``) every rank runs every row and holds, writes and
attends only its rows of the dense KV cache (:func:`decode_cache_rows`).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import launches
from ..kernels.sharded import gather_cat, gather_fsdp, sum_over, take_block
from ..sharding.policy import (
    fsdp_dim,
    fsdp_gather_axis,
    kv_shard,
    model_axis,
    param_specs,
    shard_range,
    spec_axes,
    take_shard,
)
from .attention import (
    attention_decode,
    attention_decode_paged,
    attention_train,
    init_attention,
    sequence_shards,
)
from .layers import (
    mean_nll,
    token_nll,
    embed_tokens,
    gated_mlp,
    init_gated_mlp,
    lm_logits,
    normal_init,
    rms_norm,
)
from .moe import MoEAux, identity_placement, init_moe, moe_layer
from .ssm import init_ssm, ssm_cache_zeros, ssm_decode, ssm_train

__all__ = [
    "data_rows",
    "decode_cache_rows",
    "init_params",
    "forward_train",
    "loss_fn",
    "prefill",
    "init_decode_cache",
    "init_paged_decode_cache",
    "decode_step",
    "DecodeGraph",
]


def _hybrid_split(config: ModelConfig) -> tuple[int, int]:
    """(layers inside the stages, leftover trailing mamba layers)."""
    n_stages = config.num_layers // config.attn_every
    staged = n_stages * config.attn_every
    return staged, config.num_layers - staged


def init_params(config: ModelConfig, *, seed: int = 0, device=None,
                dtype=torch.bfloat16, policy=None):
    """Random weights from a generator seeded with ``seed``, made on
    ``device`` (the card unless ``device="cpu"``). On ``device="meta"``
    the tree holds shapes and dtypes only, and nothing is drawn.

    Under a ``policy`` with a mesh every rank makes the same draws and
    keeps its shard of each leaf by :func:`~repro_torch.sharding.
    param_specs` (its ZeRO block under FSDP): each leaf is drawn as one
    device draws it and sliced at once, and each sharded expert stack
    (:func:`~repro_torch.models.moe.init_moe`) is drawn a layer at a time,
    each layer sliced as it is drawn."""
    L, D, V = config.num_layers, config.d_model, config.padded_vocab
    device = resolve_device(device)
    g = None
    if device.type != "meta":
        g = torch.Generator(device=device)
        g.manual_seed(seed)
    specs = {}
    if policy is not None and policy.mesh is not None:
        specs = param_specs(init_params(config, device="meta", dtype=dtype),
                            policy, config)

    def shard(*path, layer: bool = False):
        """The function that keeps the rank's block of a leaf (with
        ``layer``, of one layer of a stacked leaf), or None."""
        spec = specs
        for k in path:
            spec = spec.get(k, {}) if isinstance(spec, dict) else None
        if not spec_axes(spec if isinstance(spec, tuple) else None):
            return None
        spec = spec[1:] if layer else spec
        return lambda w: take_shard(w, spec, policy.mesh,
                                    leaf="/".join(path))

    def normal(shape, scale, *path):
        return normal_init(shape, scale, dtype=dtype, device=device,
                           generator=g, shard=shard(*path))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def sharder(*prefix):
        return lambda name: shard(*prefix, name)

    params: dict[str, Any] = {"embed": normal((V, D), 0.02, "embed")}
    if not config.tie_embeddings:
        params["lm_head"] = normal((D, V), 0.02, "lm_head")
    params["final_norm"] = zeros(D)
    if config.ssm_state > 0:
        blocks = {"ln": zeros(L, D),
                  "ssm": init_ssm(config, num_layers=L, dtype=dtype,
                                  device=device, generator=g,
                                  shard=sharder("blocks", "ssm"))}
    else:
        blocks = {
            "ln1": zeros(L, D),
            "ln2": zeros(L, D),
            "attn": init_attention(config, num_layers=L, dtype=dtype,
                                   device=device, generator=g,
                                   shard=sharder("blocks", "attn")),
        }
        if config.is_moe:
            blocks["moe"] = init_moe(
                config, num_layers=L, dtype=dtype, device=device,
                generator=g,
                shard=lambda name: shard("blocks", "moe", name, layer=True))
        else:
            blocks["mlp"] = init_gated_mlp(D, config.d_ff, num_layers=L,
                                           dtype=dtype, device=device,
                                           generator=g,
                                           shard=sharder("blocks", "mlp"))
    params["blocks"] = blocks
    if config.is_hybrid:
        params["shared"] = {
            "ln1": zeros(1, D),
            "ln2": zeros(1, D),
            "attn": init_attention(config, num_layers=1, dtype=dtype,
                                   device=device, generator=g,
                                   shard=sharder("shared", "attn")),
            "mlp": init_gated_mlp(D, config.d_ff, num_layers=1, dtype=dtype,
                                  device=device, generator=g,
                                  shard=sharder("shared", "mlp")),
        }
    return params


def _layer(tree, i):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _unbind(tree) -> list:
    """A stacked tree → one dict of views per layer. One ``unbind`` a leaf:
    its backward stacks the layers' gradients once, where indexing each
    layer (:func:`_layer`) would add L full-size gradients of the stack."""
    if not isinstance(tree, dict):
        return tree.unbind(0)
    per = {k: _unbind(v) for k, v in tree.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _stack(trees: list):
    """Per-layer dicts of tensors → one dict of (n, …) stacks."""
    return {k: (_stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees]))
            for k in trees[0]}


def _stack_aux(auxes: list[MoEAux]) -> MoEAux:
    """Per-layer aux → one MoEAux with (L, …) fields."""
    return MoEAux(*(
        torch.stack([getattr(a, f) for a in auxes])
        for f in MoEAux.__dataclass_fields__
    ))


def _gather_layer(lp, policy, config: ModelConfig):
    """One layer's leaves (a dict of views of the stacks under
    ``blocks``) with every block stored over ``data`` gathered whole
    along its FSDP dim (:func:`~repro_torch.kernels.sharded.gather_fsdp`);
    ``lp`` itself without FSDP."""
    axis = fsdp_gather_axis(policy)
    if axis is None:
        return lp

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        dim = fsdp_dim(path, tree.dim() + 1, tied=config.tie_embeddings)
        if dim is None:
            return tree
        return gather_fsdp(tree, policy.mesh, axis, dim - 1)

    return walk(lp, ("blocks",))


def _gather_top(params, policy, config: ModelConfig):
    """``params`` with the embedding (and an untied head) gathered whole
    over ``data`` under FSDP, else ``params``."""
    axis = fsdp_gather_axis(policy)
    if axis is None:
        return params
    out = dict(params)
    for name in ("embed", "lm_head"):
        if name in params:
            dim = fsdp_dim((name,), params[name].dim(),
                           tied=config.tie_embeddings)
            out[name] = gather_fsdp(params[name], policy.mesh, axis, dim)
    return out


def _embed_input(params, tokens, config: ModelConfig, patches=None,
                 policy=None):
    """tokens (B, S) (+ vision patch embeddings (B, P, D), prepended) →
    (B, P + S, D), whole on every rank."""
    x = embed_tokens(tokens, params["embed"], config, policy)
    if config.frontend == "vision" and patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return x


def _remat(body, on: bool):
    """``jax.checkpoint`` of a layer body: with ``on``, its activations are
    not kept for the backward but recomputed there (the kernels launch
    again)."""
    if not on:
        return body

    def recomputed(*args):
        return checkpoint(body, *args, use_reentrant=False)

    return recomputed


def _ssm_block_train(x, lp, config: ModelConfig, *, return_cache: bool,
                     policy=None, seq_sharded: bool = False):
    """ln → mamba2; with ``seq_sharded`` x is the rank's block of the
    sequence over the model axis (the block gathers it whole)."""
    axis = model_axis(policy)
    rows = (policy.mesh, axis) if seq_sharded and axis is not None else None
    lp = _gather_layer(lp, policy, config)
    h = rms_norm(x, lp["ln"], config.norm_eps, rows=rows)
    y, cache = ssm_train(h, lp["ssm"], config, return_cache=return_cache,
                         policy=policy, seq_sharded=seq_sharded)
    return x + y, cache


def _attn_block_train(x, lp, placement_l, config: ModelConfig, *,
                      return_cache: bool, policy=None, num_slots=None,
                      global_batch=None, seq_sharded: bool = False):
    """ln → attention → ln → MoE layer (a MoE config's blocks, under the
    layer's (E_v,) table ``placement_l``) or gated MLP (the dense blocks
    and zamba2's shared block); returns (x, {"k", "v"} | None, MoEAux |
    None). With ``seq_sharded`` x is the rank's block of the sequence
    over the model axis."""
    axis = model_axis(policy)
    rows = (policy.mesh, axis) if seq_sharded and axis is not None else None
    lp = _gather_layer(lp, policy, config)
    h = rms_norm(x, lp["ln1"], config.norm_eps, rows=rows)
    a, kv = attention_train(h, lp["attn"], config, return_cache=return_cache,
                            policy=policy, seq_sharded=seq_sharded)
    cache = {"k": kv[0], "v": kv[1]} if return_cache else None
    x = x + a
    h2 = rms_norm(x, lp["ln2"], config.norm_eps, rows=rows)
    aux = None
    if "moe" in lp:
        y, aux = moe_layer(h2, lp["moe"], placement_l, config, policy,
                           num_slots=num_slots, global_batch=global_batch,
                           seq_sharded=seq_sharded)
    else:
        y = gated_mlp(h2, lp["mlp"], activation=config.mlp_activation,
                      policy=policy, rows="block" if seq_sharded else "all")
    return x + y, cache, aux


def _stack_forward(x, params, placements, config: ModelConfig, *,
                   return_cache: bool, remat: bool, policy=None,
                   num_slots=None, global_batch=None,
                   seq_sharded: bool = False):
    """The whole layer stack over a full sequence, as the JAX
    ``_stack_forward``: (x, caches | None, [MoEAux per layer] | None).

    ``remat`` recomputes each layer body in the backward
    (``torch.utils.checkpoint``), where JAX wraps it in ``jax.checkpoint``:
    the attention families' whole layer, and each mamba block and the
    shared block of the hybrid. The MoE layers run under the (L, E_v)
    expert→slot tables ``placements`` (identity when None) over weights
    already in slot order; the capacity factor is the config's. Under a
    ``policy`` with a mesh the MoE layers run their sharded data plane
    over a pool of ``num_slots`` slots: on the whole batch ``x`` with
    ``global_batch=None``, or on this rank's rows of a batch of
    ``global_batch`` (:func:`~repro_torch.models.moe.moe_layer`). With
    ``seq_sharded`` (a model axis that divides S) ``x`` and the result
    are the rank's block of the sequence, the K/V caches its block of
    positions and the SSM caches its heads over the whole sequence."""
    L = config.num_layers
    blocks = _unbind(params["blocks"])

    def ssm_block(xc, lp):
        return _ssm_block_train(xc, lp, config, return_cache=return_cache,
                                policy=policy, seq_sharded=seq_sharded)

    def attn_block(xc, lp, placement_l):
        return _attn_block_train(xc, lp, placement_l, config,
                                 return_cache=return_cache, policy=policy,
                                 num_slots=num_slots,
                                 global_batch=global_batch,
                                 seq_sharded=seq_sharded)

    ssm_block, attn_block = _remat(ssm_block, remat), _remat(attn_block, remat)
    if config.is_hybrid:
        staged, _ = _hybrid_split(config)
        n_stages = staged // config.attn_every
        sp = _layer(params["shared"], 0)
        stage_ssm, stage_attn = [], []
        for s in range(n_stages):
            inner = []
            for j in range(config.attn_every):
                x, c = ssm_block(x, blocks[s * config.attn_every + j])
                inner.append(c)
            x, kv, _ = attn_block(x, sp, None)
            stage_ssm.append(inner)
            stage_attn.append(kv)
        tail = []
        for i in range(staged, L):
            x, c = ssm_block(x, blocks[i])
            tail.append(c)
        caches = None
        if return_cache:
            caches = {"ssm_staged": _stack([_stack(c) for c in stage_ssm]),
                      "attn": _stack(stage_attn),
                      "ssm_tail": _stack(tail) if tail else None}
        return x, caches, None
    if config.is_ssm:
        ssm = []
        for i in range(L):
            x, c = ssm_block(x, blocks[i])
            ssm.append(c)
        return x, ({"ssm": _stack(ssm)} if return_cache else None), None
    if config.is_moe and placements is None:
        placements = identity_placement(config, L, device=x.device)
    kvs, auxes = [], []
    for i in range(L):
        x, kv, aux = attn_block(x, blocks[i],
                                placements[i] if config.is_moe else None)
        kvs.append(kv)
        auxes.append(aux)
    caches = {"attn": _stack(kvs)} if return_cache else None
    return x, caches, (auxes if config.is_moe else None)


def forward_train(params, batch, config: ModelConfig, placements=None, *,
                  remat: bool = True, policy=None, num_slots=None):
    """batch: ``tokens`` (B, S) int, ``labels`` (B, P + S), for the vision
    frontend ``patches`` (B, P, D) (and a ``loss_mask``); ``placements``
    the (L, E_v) expert→slot tables of a MoE config.

    Returns (logits (B, P + S, V_pad) fp32, aux): for a MoE config
    ``expert_counts`` (L, E) i32, the mean ``aux_loss`` and ``dropped``
    over the layers and the summed ``dropped_tokens``, as the JAX
    ``forward_train`` gives them; else an empty dict.

    Under a ``policy`` with a mesh whose data axes are wider than one
    rank, each rank embeds and runs its ``B/d`` rows (:func:`data_rows`;
    the batch must divide) and its logits are those rows'; the MoE layers
    dispatch them as the rank's group of the global batch, so the aux is
    the global one, the same on every rank. Under a model axis that
    divides the sequence (:func:`sequence_shards`) the logits are the
    rank's block of its rows' sequence. ``num_slots`` is the expert
    pool's global slot count, which the MoE layers need under a model
    axis. A policy without a mesh runs the whole batch in the policy's
    ``data_axis_size`` dispatch groups."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    rows = _train_rows(policy, B)
    patches = batch.get("patches")
    if rows is not None:
        tokens = tokens[rows]
        patches = None if patches is None else patches[rows]
    params = _gather_top(params, policy, config)
    x = _embed_input(params, tokens, config, patches, policy)
    sp = sequence_shards(policy, x.shape[1]) > 1
    if sp:
        x = take_block(x, policy.mesh, policy.model_axis, 1)
    x, _, auxes = _stack_forward(
        x, params, placements, config, return_cache=False, remat=remat,
        policy=policy, num_slots=num_slots,
        global_batch=None if rows is None else B, seq_sharded=sp)
    x = rms_norm(x, params["final_norm"], config.norm_eps,
                 rows=(policy.mesh, policy.model_axis) if sp else None)
    logits = lm_logits(x, params, config, policy, mode="train",
                       seq_sharded=sp)
    aux = {}
    if auxes is not None:
        moe = _stack_aux(auxes)
        aux["expert_counts"] = moe.expert_counts
        aux["aux_loss"] = torch.mean(moe.aux_loss)
        aux["dropped"] = torch.mean(moe.dropped)
        aux["dropped_tokens"] = torch.sum(moe.dropped_tokens).to(torch.int32)
    return logits, aux


def _train_rows(policy, batch: int) -> slice | None:
    """This rank's rows of a training batch (:func:`data_rows`); raises
    where data axes wider than one rank do not divide the batch."""
    rows = data_rows(policy, batch)
    if (rows is None and policy is not None and policy.mesh is not None
            and policy.data_axis_size > 1):
        raise ValueError(
            f"a training batch of {batch} rows does not shard over the "
            f"{policy.data_axis_size} data ranks")
    return rows


def loss_fn(params, batch, config: ModelConfig, placements=None, *,
            remat: bool = True, policy=None, num_slots=None):
    """(cross entropy over ``labels`` under the optional ``loss_mask`` +
    ``router_aux_coef`` · aux loss for a MoE config, aux); the JAX
    ``loss_fn``.

    Under a ``policy`` whose data axes shard the batch (:func:`forward_train`)
    the loss is JAX's global mean: the rank's sum of token losses, summed
    over the data ranks (:func:`~repro_torch.kernels.sharded.sum_over`),
    over the global token count (the ``loss_mask``'s global sum), plus the
    aux term once. Where the model axis shards the sequence, the ranks'
    blocks of token losses are first gathered whole over it. Every rank
    returns the same value; its backward carries only the rank's own
    tokens, so that the gradients summed over the ranks are the global
    loss's."""
    logits, aux = forward_train(params, batch, config, placements,
                                remat=remat, policy=policy,
                                num_slots=num_slots)
    labels, mask = batch["labels"], batch.get("loss_mask")
    B, S = labels.shape
    rows = _train_rows(policy, B)
    if rows is not None:
        labels = labels[rows]
        mask = None if mask is None else mask[rows]
    if sequence_shards(policy, S) > 1:
        # the rows' losses whole on every model rank, reduced as one
        # device reduces them; each rank's backward keeps its block
        axis = policy.model_axis
        block = shard_range(S, axis, policy.mesh, leaf="labels", dim=1)
        nll = gather_cat(token_nll(logits, labels[:, block]), policy.mesh,
                         axis, 1)
    else:
        nll = token_nll(logits, labels)
    if rows is None:
        loss = mean_nll(nll, mask)
    else:
        mesh, axes = policy.mesh, policy.batch
        if mask is None:
            count = float(nll.numel() * policy.data_axis_size)
            loss = sum_over(torch.sum(nll), mesh, axes) / count
        else:
            m = mask.to(nll.dtype)
            count = torch.clamp(mesh.all_reduce(torch.sum(m), axes), min=1.0)
            loss = sum_over(torch.sum(nll * m), mesh, axes) / count
    if config.is_moe:
        loss = loss + config.router_aux_coef * aux["aux_loss"]
    return loss, aux


def prefill(params, tokens, config: ModelConfig, placements=None, *,
            patches=None, policy=None, num_slots=None):
    """tokens (B, S) (and, for the vision frontend, ``patches`` (B, P, D))
    → (last-position logits (B, V_pad) fp32, caches).

    ``placements``: (L, E_v) expert→slot tables or (L, E_v, P) replica-split
    tables for a MoE config (the prefill never runs the shed pass).
    caches, shaped as the JAX ``prefill``'s: ``{"attn": {"k", "v": (L, B, S,
    KV, hd)}}`` for the attention families, ``{"ssm": {"state", "conv_x",
    "conv_b", "conv_c": (L, B, …)}}`` for ssm, and for hybrid
    ``{"ssm_staged": (n_stages, attn_every, B, …), "attn": (n_stages, B, S,
    KV, hd), "ssm_tail": (leftover, B, …) or None}``.

    Under a ``policy`` with a mesh every rank runs the whole batch (the
    engine prefills one request, which no data axis divides: its MoE layers
    collapse to one dispatch group, as in JAX) through the sharded MoE
    layers, and every rank returns the same logits. Under a model axis
    that divides S (:func:`sequence_shards`) the stack runs
    sequence-parallel and the caches hold the rank's block of S/M
    positions; else every rank returns the whole caches.
    ``num_slots``: the expert pool's global slot count, which
    :func:`~repro_torch.models.moe.moe_layer` needs under a model axis.
    """
    params = _gather_top(params, policy, config)
    x = _embed_input(params, tokens, config, patches, policy)
    sp = sequence_shards(policy, x.shape[1]) > 1
    if sp:
        x = take_block(x, policy.mesh, policy.model_axis, 1)
    x, caches, _ = _stack_forward(x, params, placements, config,
                                  return_cache=True, remat=False,
                                  policy=policy, num_slots=num_slots,
                                  seq_sharded=sp)
    last = rms_norm(x[:, -1:], params["final_norm"], config.norm_eps)
    if sp:  # the last position is the last rank's
        last = policy.mesh.all_gather(last, policy.model_axis)[-1]
    logits = lm_logits(last, params, config, policy)
    return logits[:, 0], caches


def init_decode_cache(config: ModelConfig, batch: int, max_len: int, *,
                      device, dtype=torch.bfloat16, policy=None):
    """Zero dense caches for :func:`decode_step` without block tables: a
    (B, S_max, KV, hd) panel per slot and attention site, S_max =
    min(window, max_len) under a sliding window (a ring), else max_len;
    SSM state and conv buffers per slot. The JAX ``init_decode_cache``'s
    tree. Under a ``policy`` whose ``kv_seq`` axes are wider than one rank
    (:func:`~repro_torch.sharding.kv_shard`) each panel holds the rank's
    block of the S_max positions (raises where they do not divide)."""
    window = config.sliding_window
    attn_len = min(window, max_len) if window else max_len
    kv_axes = kv_shard(policy)
    if kv_axes is not None:
        block = shard_range(attn_len, kv_axes, policy.mesh,
                            leaf="the dense KV cache", dim=2)
        attn_len = block.stop - block.start

    def kv(*leading):
        shape = (*leading, batch, attn_len, config.num_kv_heads,
                 config.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def ssm(*leading):
        return ssm_cache_zeros(config, batch, leading, dtype=dtype,
                               device=device, policy=policy)

    if config.is_hybrid:
        staged, leftover = _hybrid_split(config)
        n_stages = staged // config.attn_every
        caches = {"ssm_staged": ssm(n_stages, config.attn_every),
                  "attn": kv(n_stages)}
        if leftover:
            caches["ssm_tail"] = ssm(leftover)
        return caches
    if config.is_ssm:
        return {"ssm": ssm(config.num_layers)}
    return {"attn": kv(config.num_layers)}


def init_paged_decode_cache(config: ModelConfig, num_blocks: int,
                            block_size: int, *, device, dtype=torch.bfloat16):
    """Paged KV pools ``(L, N, block_size, KV, hd)`` per K/V: attention
    families without a sliding window only."""
    if config.is_ssm or config.is_hybrid:
        raise ValueError("paged KV cache requires an attention-family arch")
    if config.sliding_window > 0:
        raise ValueError("paged KV cache does not support sliding windows")
    shape = (config.num_layers, num_blocks, block_size, config.num_kv_heads,
             config.head_dim)
    return {"attn": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }}


def _ssm_block_decode(x, lp, cache, config: ModelConfig, policy, rows):
    lp = _gather_layer(lp, policy, config)
    h = rms_norm(x, lp["ln"], config.norm_eps)
    return x + ssm_decode(h, lp["ssm"], cache, config, policy, rows=rows)


def data_rows(policy, batch: int) -> slice | None:
    """The rows of a ``batch``-row decode step that this rank runs, or None
    when every rank runs them all: the batch shards over the policy's data
    axes when their extent (> 1) divides it, the condition under which
    JAX's MoE layers shard their dispatch groups."""
    if policy is None or policy.mesh is None:
        return None
    d = policy.data_axis_size
    if d <= 1 or batch % d:
        return None
    rows = batch // d
    lo = policy.mesh.index(policy.batch) * rows
    return slice(lo, lo + rows)


def decode_cache_rows(policy, batch: int) -> slice | None:
    """The rows of a ``batch``-row dense decode cache that this rank
    holds, or None for all of them: the rows it runs where the batch
    shards (:func:`data_rows`); else its block of the rows over
    ``cache_batch_axes`` when their extent (> 1) divides ``batch``: the
    replicated-activation decode of an FSDP policy (``batch_axes=()``),
    where every rank runs every row and attends (or steps the SSM state
    of) only its cache rows. Every cache of every family."""
    rows = data_rows(policy, batch)
    if (rows is not None or policy is None or policy.mesh is None
            or not policy.cache_batch_axes):
        return rows
    axes = tuple(policy.cache_batch_axes)
    n = policy.mesh.size(axes)
    if n <= 1 or batch % n:
        return None
    per = batch // n
    lo = policy.mesh.index(axes) * per
    return slice(lo, lo + per)


def decode_step(params, caches, cur_len, tokens, config: ModelConfig,
                placements=None, *, block_tables=None, shed_enables=None,
                policy=None, num_slots=None):
    """One serving step: tokens (B, 1) int32.

    Dense mode (``block_tables=None``): ``cur_len`` is a 0-d int32 tensor
    shared by the batch and ``caches`` are :func:`init_decode_cache`'s
    per-slot panels. Paged mode (attention families without a window):
    ``block_tables`` (B, n_max) int32 and ``cur_len`` (B,) int32 route each
    row through its own block table. ``placements``: (L, E_v) or (L, E_v,
    P) tables of a MoE config; ``shed_enables``: (L,) 0/1 int32 per-layer
    switches of the shed pass, or None to leave the pass out of the step.

    Returns (logits (B, V_pad) fp32, caches, moe aux with (L, …) fields or
    None for a config without MoE layers). The caches are updated in place
    and returned, where the JAX version returns new ones.

    Under a ``policy`` with a mesh whose data axes divide the batch
    (:func:`data_rows`) each data rank runs its ``B/d`` rows: ``caches``
    hold only those rows (the dense cache; the paged pools are indexed by
    the rows' own block tables), the MoE layers dispatch them as the
    rank's group, and the logits are all-gathered over the data axes, so
    every rank returns all ``B`` rows and the same aux. ``num_slots`` is
    the expert pool's global slot count, as :func:`prefill` takes it.
    Under a model axis the projections, the MLP and the vocabulary are
    the rank's shards and the dense caches the rank's block of positions
    (:func:`~repro_torch.models.attention.attention_decode`). Under FSDP
    each layer's blocks are gathered whole over ``data`` before it runs.
    Where every rank runs every row but the dense cache holds only the
    rank's rows (:func:`decode_cache_rows`: an FSDP policy's replicated
    activations), each rank attends its rows and the attention outputs
    are gathered over the cache-batch axes in row order.
    """
    if block_tables is not None and (config.is_ssm or config.is_hybrid):
        raise ValueError("paged decode requires an attention-family arch")
    L = config.num_layers
    B = tokens.shape[0]
    blocks = params["blocks"]
    rows = data_rows(policy, B)
    if rows is not None:
        tokens = tokens[rows]
        if block_tables is not None:
            block_tables, cur_len = block_tables[rows], cur_len[rows]
    # the dense cache's rows of a batch every rank runs whole
    kv_rows = None
    if rows is None and block_tables is None:
        kv_rows = decode_cache_rows(policy, B)
    params = _gather_top(params, policy, config)
    x = embed_tokens(tokens, params["embed"], config, policy)
    moe_aux = None
    if config.is_hybrid:
        staged, _ = _hybrid_split(config)
        n_stages = staged // config.attn_every
        attn = caches["attn"]
        sp = _gather_layer(_layer(params["shared"], 0), policy, config)
        for s in range(n_stages):
            for j in range(config.attn_every):
                x = _ssm_block_decode(
                    x, _layer(blocks, s * config.attn_every + j),
                    _layer(caches["ssm_staged"], (s, j)), config, policy,
                    kv_rows)
            h = rms_norm(x, sp["ln1"], config.norm_eps)
            x = x + attention_decode(h, sp["attn"], attn["k"][s],
                                     attn["v"][s], cur_len, config, policy,
                                     rows=kv_rows)
            h2 = rms_norm(x, sp["ln2"], config.norm_eps)
            x = x + gated_mlp(h2, sp["mlp"], activation=config.mlp_activation,
                              policy=policy)
        for t, i in enumerate(range(staged, L)):
            x = _ssm_block_decode(x, _layer(blocks, i),
                                  _layer(caches["ssm_tail"], t), config,
                                  policy, kv_rows)
    elif config.is_ssm:
        for i in range(L):
            x = _ssm_block_decode(x, _layer(blocks, i),
                                  _layer(caches["ssm"], i), config, policy,
                                  kv_rows)
    else:
        if config.is_moe and placements is None:
            placements = identity_placement(config, L, device=tokens.device)
        pools = caches["attn"]
        auxes = []
        for i in range(L):
            lp = _gather_layer(_layer(blocks, i), policy, config)
            h = rms_norm(x, lp["ln1"], config.norm_eps)
            if block_tables is not None:
                a = attention_decode_paged(
                    h, lp["attn"], pools["k"][i], pools["v"][i], block_tables,
                    cur_len, config, policy,
                )
            else:
                a = attention_decode(h, lp["attn"], pools["k"][i],
                                     pools["v"][i], cur_len, config, policy,
                                     rows=kv_rows)
            x = x + a
            h2 = rms_norm(x, lp["ln2"], config.norm_eps)
            if config.is_moe:
                y, aux = moe_layer(
                    h2, lp["moe"], placements[i], config, policy,
                    capacity_factor=config.decode_capacity_factor,
                    shed_enable=(None if shed_enables is None
                                 else shed_enables[i]),
                    global_batch=B, num_slots=num_slots,
                )
                auxes.append(aux)
            else:
                y = gated_mlp(h2, lp["mlp"], activation=config.mlp_activation,
                              policy=policy)
            x = x + y
        if auxes:
            moe_aux = _stack_aux(auxes)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = lm_logits(x, params, config, policy)[:, 0]
    if rows is not None:
        logits = policy.mesh.all_gather(logits, policy.batch).reshape(B, -1)
    return logits, caches, moe_aux


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _idle_writes(caches, *, paged: bool) -> list:
    """Views of the cache entries that :func:`decode_step` writes with every
    input at zero (every row idle, ``cur_len`` 0): on the paged cache only
    the null block, which no row reads, so none; on the dense cache index 0
    of each K/V panel or ring, and the SSM state and conv buffers whole."""
    if paged:
        return []
    views = []
    for name, sub in caches.items():
        if name == "attn":
            views += [t.select(-3, 0) for t in _leaves(sub)]
        else:
            views += list(_leaves(sub))
    return views


class DecodeGraph:
    """The port's counterpart of ``decode_mode="scan"``: the whole
    :func:`decode_step` over static buffers, captured once as a CUDA graph
    and replayed every step.

    The JAX package lowers the decode step to one executable whose
    placements, block tables and lengths are operands. Here everything the
    step reads stays at one address for the life of the graph: the step's
    host inputs are copied into :attr:`tokens` (B, 1) and :attr:`cur_len`
    — (B,) per-row lengths beside :attr:`block_tables` (B, n_max) on the
    paged cache, or one 0-d length shared by the batch on the dense cache
    (``n_max=None``), from which the step computes the ring's write index,
    the RoPE position and the valid mask on the device — views of one
    int32 device buffer filled by one copy a step. The weights, the caches
    (paged pools, dense panels and rings, SSM states and conv buffers) and,
    for a MoE config, the (L, E_v) expert→slot tables (or (L, E_v, P)
    replica-split tables) are the caller's tensors, which the caller and
    the step update in place (``copy_``) and never rebind. With
    ``shed=True`` the same buffer also holds :attr:`shed_enables` (L,), the
    per-layer switches of the shed pass, copied in with the other inputs
    each step; with ``shed=False`` the captured step holds no shed
    operation at all.

    Binding happens at construction, with the static inputs at zero (every
    row idle). On a CUDA device it runs the body once on a side stream,
    which loads the kernels' libraries, sets up cuBLAS there and makes K2's
    arrival counter for that stream, runs it again under
    ``torch.cuda.set_sync_debug_mode("error")`` so that a host sync fails
    before the capture, then captures one body with ``torch.cuda.CUDAGraph``
    on the same stream. The two bodies write into the caches, so what an
    idle step writes is copied aside first and restored after (see
    :func:`_idle_writes`): binding leaves the caches as it found them, and
    holds no second copy of a KV cache while it binds. Each call replays the graph and adds the
    kernel launches the capture recorded to
    :mod:`repro_torch.kernels.launches`. A capture or replay error raises:
    there is no eager fallback on the card. On the CPU there is nothing to
    capture, and each call runs the same body eagerly.

    :attr:`builds` counts bindings (captures on the card). A call whose
    weights, caches or tables are other tensors than the bound ones binds
    again and counts it, so a graph never reads stale pointers.
    :attr:`pool_bytes` is the device memory the capture reserved for its
    private pool (the step's intermediates and outputs).

    Under a ``policy`` with a mesh the body is :func:`decode_step` with the
    policy and ``num_slots``, whose collectives the capture records: NCCL's run inside a
    CUDA graph. A ``gloo`` mesh on a CUDA device stages its collectives
    through host buffers, which no graph can hold, so that pairing raises
    ``ValueError`` here (the eager ``"python"`` mode serves it); on the
    CPU the body runs eagerly with any backend. A graph that holds NCCL's
    kernels must be freed before its process groups are destroyed
    (:func:`repro_torch.launch.mesh.spawn` collects it first): NCCL's
    teardown waits on it.
    """

    def __init__(self, params, caches, placements, config: ModelConfig, *,
                 batch: int, n_max: int | None, device, shed: bool = False,
                 policy=None, num_slots: int | None = None):
        self.config = config
        self.device = torch.device(device)
        self.batch, self.n_max = batch, n_max
        self.policy, self.num_slots = policy, num_slots
        cuda = self.device.type == "cuda"
        mesh = None if policy is None else policy.mesh
        if cuda and mesh is not None and mesh.backend == "gloo":
            raise ValueError(
                "decode_mode='scan' on a CUDA device needs backend='nccl': a "
                "gloo collective stages through the host and cannot be "
                "captured in a CUDA graph (use decode_mode='python')")
        paged = n_max is not None
        self._cur_end = 2 * batch if paged else batch + 1
        self._rows = self._cur_end + (batch * n_max if paged else 0)
        words = self._rows + (config.num_layers if shed else 0)
        self._host = torch.zeros(words, dtype=torch.int32, pin_memory=cuda)
        self._host_np = self._host.numpy()
        self._inputs = torch.zeros(words, dtype=torch.int32, device=self.device)
        self.tokens = self._inputs[:batch].view(batch, 1)
        self.cur_len = (self._inputs[batch:self._cur_end] if paged
                        else self._inputs[batch])
        self.block_tables = (
            self._inputs[self._cur_end:self._rows].view(batch, n_max)
            if paged else None)
        self.shed_enables = self._inputs[self._rows:] if shed else None
        self._staged = torch.cuda.Event() if cuda else None
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self.builds = 0
        self.pool_bytes = 0
        self._graph = self._out = self._tally = self._key = None
        self._bind(params, caches, placements)

    @staticmethod
    def _pointers(params, caches, placements) -> tuple[int, ...]:
        return tuple(t.data_ptr()
                     for t in _leaves({"p": params, "c": caches,
                                       "t": placements}))

    def _body(self):
        return decode_step(
            self._params, self._caches, self.cur_len, self.tokens,
            self.config, self._placements, block_tables=self.block_tables,
            shed_enables=self.shed_enables, policy=self.policy,
            num_slots=self.num_slots,
        )

    def _bind(self, params, caches, placements) -> None:
        self._params, self._caches, self._placements = params, caches, placements
        self._key = self._pointers(params, caches, placements)
        self.builds += 1
        if self._stream is not None:
            self._capture()

    def _capture(self) -> None:
        dev, stream = self.device, self._stream
        self._graph = self._out = None  # an earlier capture's pool goes first
        written = _idle_writes(self._caches, paged=self.n_max is not None)
        saved = [t.clone() for t in written]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._body()  # set-up: libraries, cuBLAS, K2's counter, RoPE
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._body()  # what the graph holds may not sync
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            for t, old in zip(written, saved):
                t.copy_(old)
        torch.cuda.synchronize(dev)
        del saved
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with launches.recording() as tally:
            with torch.cuda.graph(graph, stream=stream):
                out = self._body()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._graph, self._out, self._tally = graph, out, tally

    def _stage(self, cur_len, tokens, block_tables, shed_enables) -> None:
        """Host inputs → the static device buffer, one copy."""
        if (shed_enables is None) != (self.shed_enables is None):
            raise ValueError(
                "DecodeGraph: shed_enables must be given exactly when the "
                "graph was built with shed=True")
        if (block_tables is None) != (self.block_tables is None):
            raise ValueError(
                "DecodeGraph: block_tables must be given exactly when the "
                "graph was built for the paged cache (n_max)")
        if self._staged is not None:
            self._staged.synchronize()  # the last step's copy has left it
        B, h = self.batch, self._host_np
        h[:B] = np.asarray(tokens).reshape(B)
        h[B:self._cur_end] = np.asarray(cur_len).reshape(-1)
        if block_tables is not None:
            h[self._cur_end:self._rows] = np.asarray(block_tables).reshape(-1)
        if shed_enables is not None:
            h[self._rows:] = np.asarray(shed_enables).reshape(-1)
        self._inputs.copy_(self._host, non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def __call__(self, params, caches, cur_len, tokens, config: ModelConfig,
                 placements, *, block_tables=None, shed_enables=None):
        """:func:`decode_step`'s signature and results, with ``cur_len``,
        ``tokens``, ``block_tables`` and ``shed_enables`` as host arrays.
        The logits and aux are the graph's static outputs: the next call
        overwrites them."""
        if config is not self.config and config != self.config:
            raise ValueError("DecodeGraph: called with another model config")
        self._stage(cur_len, tokens, block_tables, shed_enables)
        if self._pointers(params, caches, placements) != self._key:
            self._bind(params, caches, placements)
        if self._graph is None:
            out = self._body()
        else:
            self._graph.replay()
            launches.replayed(self._tally)
            out = self._out
        logits, _, aux = out
        return logits, caches, aux
