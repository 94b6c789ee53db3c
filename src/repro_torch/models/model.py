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
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import launches
from .attention import (
    attention_decode,
    attention_decode_paged,
    attention_train,
    init_attention,
)
from .layers import (
    cross_entropy_loss,
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
                dtype=torch.bfloat16):
    """Random weights from a generator seeded with ``seed``, made on
    ``device`` (the card unless ``device="cpu"``)."""
    L, D, V = config.num_layers, config.d_model, config.padded_vocab
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(shape, scale):
        return normal_init(shape, scale, dtype=dtype, device=device,
                           generator=g)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    params: dict[str, Any] = {"embed": normal((V, D), 0.02)}
    if not config.tie_embeddings:
        params["lm_head"] = normal((D, V), 0.02)
    params["final_norm"] = zeros(D)
    if config.ssm_state > 0:
        blocks = {"ln": zeros(L, D),
                  "ssm": init_ssm(config, num_layers=L, dtype=dtype,
                                  device=device, generator=g)}
    else:
        blocks = {
            "ln1": zeros(L, D),
            "ln2": zeros(L, D),
            "attn": init_attention(config, num_layers=L, dtype=dtype,
                                   device=device, generator=g),
        }
        if config.is_moe:
            blocks["moe"] = init_moe(config, num_layers=L, dtype=dtype,
                                     device=device, generator=g)
        else:
            blocks["mlp"] = init_gated_mlp(D, config.d_ff, num_layers=L,
                                           dtype=dtype, device=device,
                                           generator=g)
    params["blocks"] = blocks
    if config.is_hybrid:
        params["shared"] = {
            "ln1": zeros(1, D),
            "ln2": zeros(1, D),
            "attn": init_attention(config, num_layers=1, dtype=dtype,
                                   device=device, generator=g),
            "mlp": init_gated_mlp(D, config.d_ff, num_layers=1, dtype=dtype,
                                  device=device, generator=g),
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


def _embed_input(params, tokens, config: ModelConfig, patches=None):
    """tokens (B, S) (+ vision patch embeddings (B, P, D), prepended) →
    (B, P + S, D)."""
    x = embed_tokens(tokens, params["embed"], config)
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


def _ssm_block_train(x, lp, config: ModelConfig, *, return_cache: bool):
    h = rms_norm(x, lp["ln"], config.norm_eps)
    y, cache = ssm_train(h, lp["ssm"], config, return_cache=return_cache)
    return x + y, cache


def _attn_block_train(x, lp, placement_l, config: ModelConfig, *,
                      return_cache: bool):
    """ln → attention → ln → MoE layer (a MoE config's blocks, under the
    layer's (E_v,) table ``placement_l``) or gated MLP (the dense blocks
    and zamba2's shared block); returns (x, {"k", "v"} | None, MoEAux |
    None)."""
    h = rms_norm(x, lp["ln1"], config.norm_eps)
    a, kv = attention_train(h, lp["attn"], config, return_cache=return_cache)
    cache = {"k": kv[0], "v": kv[1]} if return_cache else None
    x = x + a
    h2 = rms_norm(x, lp["ln2"], config.norm_eps)
    aux = None
    if "moe" in lp:
        y, aux = moe_layer(h2, lp["moe"], placement_l, config)
    else:
        y = gated_mlp(h2, lp["mlp"], activation=config.mlp_activation)
    return x + y, cache, aux


def _stack_forward(x, params, placements, config: ModelConfig, *,
                   return_cache: bool, remat: bool):
    """The whole layer stack over a full sequence, as the JAX
    ``_stack_forward``: (x, caches | None, [MoEAux per layer] | None).

    ``remat`` recomputes each layer body in the backward
    (``torch.utils.checkpoint``), where JAX wraps it in ``jax.checkpoint``:
    the attention families' whole layer, and each mamba block and the
    shared block of the hybrid. The MoE layers run under the (L, E_v)
    expert→slot tables ``placements`` (identity when None) over weights
    already in slot order; the capacity factor is the config's."""
    L = config.num_layers
    blocks = _unbind(params["blocks"])

    def ssm_block(xc, lp):
        return _ssm_block_train(xc, lp, config, return_cache=return_cache)

    def attn_block(xc, lp, placement_l):
        return _attn_block_train(xc, lp, placement_l, config,
                                 return_cache=return_cache)

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
                  remat: bool = True):
    """batch: ``tokens`` (B, S) int, ``labels`` (B, P + S), for the vision
    frontend ``patches`` (B, P, D) (and a ``loss_mask``); ``placements``
    the (L, E_v) expert→slot tables of a MoE config.

    Returns (logits (B, P + S, V_pad) fp32, aux): for a MoE config
    ``expert_counts`` (L, E) i32, the mean ``aux_loss`` and ``dropped``
    over the layers and the summed ``dropped_tokens``, as the JAX
    ``forward_train`` gives them; else an empty dict."""
    x = _embed_input(params, batch["tokens"], config, batch.get("patches"))
    x, _, auxes = _stack_forward(x, params, placements, config,
                                 return_cache=False, remat=remat)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = lm_logits(x, params, config)
    aux = {}
    if auxes is not None:
        moe = _stack_aux(auxes)
        aux["expert_counts"] = moe.expert_counts
        aux["aux_loss"] = torch.mean(moe.aux_loss)
        aux["dropped"] = torch.mean(moe.dropped)
        aux["dropped_tokens"] = torch.sum(moe.dropped_tokens).to(torch.int32)
    return logits, aux


def loss_fn(params, batch, config: ModelConfig, placements=None, *,
            remat: bool = True):
    """(cross entropy over ``labels`` under the optional ``loss_mask`` +
    ``router_aux_coef`` · aux loss for a MoE config, aux); the JAX
    ``loss_fn``."""
    logits, aux = forward_train(params, batch, config, placements,
                                remat=remat)
    loss = cross_entropy_loss(logits, batch["labels"],
                              mask=batch.get("loss_mask"))
    if config.is_moe:
        loss = loss + config.router_aux_coef * aux["aux_loss"]
    return loss, aux


def prefill(params, tokens, config: ModelConfig, placements=None, *,
            patches=None):
    """tokens (B, S) (and, for the vision frontend, ``patches`` (B, P, D))
    → (last-position logits (B, V_pad) fp32, caches).

    ``placements``: (L, E_v) expert→slot tables or (L, E_v, P) replica-split
    tables for a MoE config (the prefill never runs the shed pass).
    caches, shaped as the JAX ``prefill``'s: ``{"attn": {"k", "v": (L, B, S,
    KV, hd)}}`` for the attention families, ``{"ssm": {"state", "conv_x",
    "conv_b", "conv_c": (L, B, …)}}`` for ssm, and for hybrid
    ``{"ssm_staged": (n_stages, attn_every, B, …), "attn": (n_stages, B, S,
    KV, hd), "ssm_tail": (leftover, B, …) or None}``.
    """
    x = _embed_input(params, tokens, config, patches)
    x, caches, _ = _stack_forward(x, params, placements, config,
                                  return_cache=True, remat=False)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = lm_logits(x[:, -1:], params, config)
    return logits[:, 0], caches


def init_decode_cache(config: ModelConfig, batch: int, max_len: int, *,
                      device, dtype=torch.bfloat16):
    """Zero dense caches for :func:`decode_step` without block tables: a
    (B, S_max, KV, hd) panel per slot and attention site, S_max =
    min(window, max_len) under a sliding window (a ring), else max_len;
    SSM state and conv buffers per slot. The JAX ``init_decode_cache``'s
    tree."""
    window = config.sliding_window
    attn_len = min(window, max_len) if window else max_len

    def kv(*leading):
        shape = (*leading, batch, attn_len, config.num_kv_heads,
                 config.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def ssm(*leading):
        return ssm_cache_zeros(config, batch, leading, dtype=dtype,
                               device=device)

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


def _ssm_block_decode(x, lp, cache, config: ModelConfig):
    h = rms_norm(x, lp["ln"], config.norm_eps)
    return x + ssm_decode(h, lp["ssm"], cache, config)


def decode_step(params, caches, cur_len, tokens, config: ModelConfig,
                placements=None, *, block_tables=None, shed_enables=None):
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
    """
    if block_tables is not None and (config.is_ssm or config.is_hybrid):
        raise ValueError("paged decode requires an attention-family arch")
    L = config.num_layers
    blocks = params["blocks"]
    x = embed_tokens(tokens, params["embed"], config)
    moe_aux = None
    if config.is_hybrid:
        staged, _ = _hybrid_split(config)
        n_stages = staged // config.attn_every
        sp = _layer(params["shared"], 0)
        attn = caches["attn"]
        for s in range(n_stages):
            for j in range(config.attn_every):
                x = _ssm_block_decode(
                    x, _layer(blocks, s * config.attn_every + j),
                    _layer(caches["ssm_staged"], (s, j)), config)
            h = rms_norm(x, sp["ln1"], config.norm_eps)
            x = x + attention_decode(h, sp["attn"], attn["k"][s],
                                     attn["v"][s], cur_len, config)
            h2 = rms_norm(x, sp["ln2"], config.norm_eps)
            x = x + gated_mlp(h2, sp["mlp"], activation=config.mlp_activation)
        for t, i in enumerate(range(staged, L)):
            x = _ssm_block_decode(x, _layer(blocks, i),
                                  _layer(caches["ssm_tail"], t), config)
    elif config.is_ssm:
        for i in range(L):
            x = _ssm_block_decode(x, _layer(blocks, i),
                                  _layer(caches["ssm"], i), config)
    else:
        if config.is_moe and placements is None:
            placements = identity_placement(config, L, device=tokens.device)
        pools = caches["attn"]
        auxes = []
        for i in range(L):
            lp = _layer(blocks, i)
            h = rms_norm(x, lp["ln1"], config.norm_eps)
            if block_tables is not None:
                a = attention_decode_paged(
                    h, lp["attn"], pools["k"][i], pools["v"][i], block_tables,
                    cur_len, config,
                )
            else:
                a = attention_decode(h, lp["attn"], pools["k"][i],
                                     pools["v"][i], cur_len, config)
            x = x + a
            h2 = rms_norm(x, lp["ln2"], config.norm_eps)
            if config.is_moe:
                y, aux = moe_layer(
                    h2, lp["moe"], placements[i], config,
                    capacity_factor=config.decode_capacity_factor,
                    shed_enable=(None if shed_enables is None
                                 else shed_enables[i]),
                )
                auxes.append(aux)
            else:
                y = gated_mlp(h2, lp["mlp"], activation=config.mlp_activation)
            x = x + y
        if auxes:
            moe_aux = _stack_aux(auxes)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = lm_logits(x, params, config)
    return logits[:, 0], caches, moe_aux


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
    """

    def __init__(self, params, caches, placements, config: ModelConfig, *,
                 batch: int, n_max: int | None, device, shed: bool = False):
        self.config = config
        self.device = torch.device(device)
        self.batch, self.n_max = batch, n_max
        cuda = self.device.type == "cuda"
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
            shed_enables=self.shed_enables,
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
