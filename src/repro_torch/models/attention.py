"""Attention: causal (optionally sliding-window) prefill over a whole
prompt, decode against a dense per-slot cache (a ring under a sliding
window), and paged decode.

Plain torch products, as the JAX package leaves them to XLA
(``repro/models/attention.py``): there is no attention kernel to port.
Weights keep the JAX layouts — ``wq`` (D, H·hd), ``wk``/``wv`` (D, KV·hd),
``wo`` (H·hd, D) — the dense cache is (B, S_max, KV, hd) per layer and the
paged pool (N, bs, KV, hd) per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.sharded import (
    gather_cat,
    rows_attention,
    rows_linear,
    sum_over,
)
from ..sharding.policy import kv_shard, model_axis
from .layers import apply_rope, normal_init, rms_norm, rope

__all__ = [
    "init_attention",
    "attention_train",
    "attention_decode",
    "attention_decode_paged",
]

NEG_INF = -1e30


def init_attention(config: ModelConfig, *, num_layers: int, dtype, device,
                   generator: torch.Generator, shard=None):
    """Random projections (and zero biases and norm scales). ``shard``,
    given a leaf's name, returns the function that keeps a rank's block of
    it (:func:`~repro_torch.models.layers.normal_init`), or None for a
    whole leaf."""
    D = config.d_model
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    s = float(1.0 / np.sqrt(D))
    so = float(1.0 / np.sqrt(H * hd))
    shard = shard or (lambda name: None)

    def normal(name, shape, scale):
        return normal_init(shape, scale, dtype=dtype, device=device,
                           generator=generator, shard=shard(name))

    def zeros(name, shape):
        t = torch.zeros(shape, dtype=dtype, device=device)
        keep = shard(name)
        return t if keep is None else keep(t).contiguous()

    params = {
        "wq": normal("wq", (num_layers, D, H * hd), s),
        "wk": normal("wk", (num_layers, D, KV * hd), s),
        "wv": normal("wv", (num_layers, D, KV * hd), s),
        "wo": normal("wo", (num_layers, H * hd, D), so),
    }
    if config.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            params[name] = zeros(name, (num_layers, width))
    if config.qk_norm:
        for name in ("q_norm", "k_norm"):
            params[name] = zeros(name, (num_layers, hd))
    return params


_QKV = ("wq", "wk", "wv", "bq", "bk", "bv")


def _heads(q, k, v, p, config: ModelConfig, rows=None):
    """Flat q (B,S,H·hd), k/v (B,S,KV·hd) → heads, with ``qk_norm``
    (``rows``: :func:`~repro_torch.models.layers.rms_norm`'s)."""
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    B, S = q.shape[:2]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if config.qk_norm:
        q = rms_norm(q, p["q_norm"], config.norm_eps, rows=rows)
        k = rms_norm(k, p["k_norm"], config.norm_eps, rows=rows)
    return q, k, v


def _linear_qkv(x, p, config: ModelConfig):
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if config.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _project_qkv(x, p, config: ModelConfig, policy=None):
    """x (B, S, D) → q (B,S,H,hd), k/v (B,S,KV,hd) (pre-RoPE). Under a
    model axis the rank's columns are projected and the three gathered
    whole in one all-gather (decode: no gradient)."""
    q, k, v = _linear_qkv(x, p, config)
    axis = model_axis(policy)
    if axis is not None:
        widths = (q.shape[-1], k.shape[-1], v.shape[-1])
        parts = policy.mesh.all_gather(torch.cat([q, k, v], dim=-1), axis)
        m = parts.shape[0]
        flat = parts.movedim(0, -2)  # (B, S, m, wq + wk + wv)
        q, k, v = (t.reshape(*t.shape[:-2], m * w) for t, w in zip(
            flat.split(widths, dim=-1), widths))
    return _heads(q, k, v, p, config)


def _gathered(p, policy):
    """The layer's projections with the rank's shards gathered whole (the
    flat output dim of q/k/v and their biases, the input dim of ``wo``)."""
    mesh, axis = policy.mesh, model_axis(policy)
    out = dict(p)
    for name in _QKV:
        if name in p:
            out[name] = gather_cat(p[name], mesh, axis, -1)
    out["wo"] = gather_cat(p["wo"], mesh, axis, 0)
    return out


def sequence_shards(policy, seq_len: int) -> int:
    """M, the blocks the model axis cuts a ``seq_len``-row sequence into
    in prefill and training: the axis's extent where it divides
    ``seq_len`` (JAX's ``S % M`` condition), else 1. Always 1 without a
    model axis."""
    if model_axis(policy) is None:
        return 1
    m = policy.model_axis_size
    return m if seq_len % m == 0 else 1


def attention_train(x, p, config: ModelConfig, *, return_cache: bool = False,
                    policy=None, seq_sharded: bool = False):
    """Causal self-attention over the whole sequence; with
    ``config.sliding_window`` w > 0, query q sees keys k with q − k < w.

    x (B, S, D) → (out (B, S, D), (k, v) each (B, S, KV, hd) | None). The
    JAX version chunks queries to bound its score matrix, and under a
    window gathers a static-width key block per chunk; masked keys get
    ``exp(−1e30 − m) = 0`` in either layout, so one masked pass over the
    whole row gives each row the same softmax.

    Under a ``policy`` with a model axis the projections are gathered
    whole. With ``seq_sharded`` x holds the rank's block of the sequence
    (S/M rows at global positions r·S/M…): the projections are
    :func:`~repro_torch.kernels.sharded.rows_linear`, the attention
    :func:`~repro_torch.kernels.sharded.rows_attention` and
    ``q_norm``/``k_norm`` :func:`~repro_torch.kernels.sharded.scale_rows`
    (every gradient summed over all ranks' rows in one device's order, the
    rank's block kept); the output is the rank's rows and the cache its
    rows' K/V. Without it every rank runs every row alike and the gathers'
    adjoints keep the rank's block.
    """
    B, S, _ = x.shape
    hd = config.head_dim
    axis = model_axis(policy)
    sp = axis is not None and seq_sharded
    base, rows = 0, None
    if sp:
        mesh = policy.mesh
        rows = (mesh, axis)
        base = mesh.index(axis) * S
        q, k, v = (rows_linear(x, p[w], p.get(b), mesh, axis, wdim=1)
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    else:
        if axis is not None:  # every rank runs every row alike
            p = _gathered(p, policy)
        q, k, v = _linear_qkv(x, p, config)
    q, k, v = _heads(q, k, v, p, config, rows=rows)
    cos, sin = rope(base + torch.arange(S, device=x.device), hd,
                    config.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    def core(q, k, v, base):
        return _attend(q, k, v, base, config)

    if sp:
        out = rows_attention(q, k, v, mesh, axis, core)
        y = rows_linear(out, p["wo"], None, mesh, axis, wdim=0)
    else:
        y = torch.matmul(core(q, k, v, 0), p["wo"])
    return y, ((k, v) if return_cache else None)


def _attend(q, k, v, base: int, config: ModelConfig):
    """Queries q (B, Sq, H, hd) at positions base… against keys and values
    (B, S, KV, hd) at 0…S−1: the causal (and windowed) softmax, (B, Sq,
    H·hd)."""
    B, Sq = q.shape[:2]
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    G = H // KV
    pos_q = base + torch.arange(Sq, device=q.device)
    pos_k = torch.arange(k.shape[1], device=q.device)
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    mask = pos_q[:, None] >= pos_k[None, :]  # (q, s)
    if config.sliding_window > 0:
        mask &= (pos_q[:, None] - pos_k[None, :]) < config.sliding_window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H * hd)


def _output(out, p, policy):
    """out (B, 1, H·hd) whole → ``out · wo``: row-parallel under a model
    axis (the rank's columns of ``out`` times its rows of ``wo``, each
    partial in fp32 and summed over the axis in rank order, then cast
    back: one rounding to x's dtype, as one device's product makes)."""
    axis = model_axis(policy)
    if axis is None:
        return torch.matmul(out, p["wo"])
    w = p["wo"].shape[0]
    cols = out[..., policy.mesh.index(axis) * w:][..., :w]
    part = torch.matmul(cols.float(), p["wo"].float())
    return sum_over(part, policy.mesh, axis).to(out.dtype)


def _combine(s_cache, v_cache, s_new, v_new, mesh, axes):
    """The two-piece softmax's output (B, KV, G, hd) fp32 over a cache whose
    positions are split over ``axes``: each rank's partial max, sum and
    weighted V over its positions (``s_cache`` (B, KV, G, S_loc) fp32,
    masked), gathered and combined in rank order with the new token's term
    (``s_new`` (B, KV, G, 1), ``v_new`` (B, KV, hd)). A rank whose
    positions are all masked holds max −1e30: its weight exp(−1e30 − m)
    is 0, so it adds nothing (and no NaN)."""
    m_loc = s_cache.max(dim=-1, keepdim=True).values
    e = torch.exp(s_cache - m_loc)
    l_loc = e.sum(dim=-1, keepdim=True)
    o_loc = torch.einsum("bkgs,bskd->bkgd", e.to(v_cache.dtype).float(),
                         v_cache.float())
    parts = mesh.all_gather(torch.cat([m_loc, l_loc, o_loc], dim=-1), axes)
    m = torch.maximum(parts[..., :1].amax(dim=0), s_new)
    e_new = torch.exp(s_new - m)
    denom, num = e_new, e_new * v_new[:, :, None].float()
    for part in parts.unbind(0):
        w = torch.exp(part[..., :1] - m)
        denom = denom + part[..., 1:2] * w
        num = num + part[..., 2:] * w
    return num / denom


def attention_decode(x, p, k_cache, v_cache, cur_len, config: ModelConfig,
                     policy=None, *, rows: slice | None = None):
    """One decode step against one layer's dense cache.

    x (B, 1, D); ``k_cache``/``v_cache`` (B, S_max, KV, hd), one panel per
    slot; ``cur_len`` a 0-d int32 tensor shared by the batch: the number of
    positions already written. The new K/V goes to ``cur_len`` — modulo
    S_max under a sliding window, where the cache is a ring of S_max =
    min(window, max_len) entries and the valid entries are those written
    1 … min(cur_len, window − 1) steps ago (``age = (write_pos − pos) mod
    S_max``); the new token attends to itself. Returns out (B, 1, D).

    Everything about the position — RoPE, the write index and the valid
    mask — is computed on the device from ``cur_len``, so a captured step
    reads it from a static buffer. The new K/V is written **in place**
    (the JAX ``decode_cache_update="dus"``; its ``"onehot"`` blend writes
    the same values) after the scores have read the cache.

    Under a ``policy`` (see the module's notes) the panels are the rank's
    block of S_max positions over ``kv_seq`` and the projections its
    shards. ``rows``: the rows of x whose panels the cache holds, when it
    holds only those (:func:`~repro_torch.models.model.decode_cache_rows`,
    under replicated activations): the rank projects every row, attends and
    writes its rows, and their outputs are gathered over the policy's
    cache-batch axes in row order before ``wo``.
    """
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    G = H // KV
    S_loc = k_cache.shape[-3]
    kv = kv_shard(policy)
    n = 1 if kv is None else policy.mesh.size(kv)
    lo = 0 if kv is None else policy.mesh.index(kv) * S_loc
    S_max = S_loc * n
    q, k_new, v_new = _project_qkv(x, p, config, policy)
    if rows is not None:
        q, k_new, v_new = q[rows], k_new[rows], v_new[rows]
    B = q.shape[0]
    cur = cur_len.reshape(1).long()
    cos, sin = rope(cur, hd, config.rope_theta)  # (1, hd/2)
    q = apply_rope(q, cos[None], sin[None])
    k_new = apply_rope(k_new, cos[None], sin[None])

    window = config.sliding_window if config.sliding_window > 0 else 0
    # past the panel's end the index is clamped, as dynamic_update_slice
    # clamps its start
    write_pos = (torch.remainder(cur, S_max) if window
                 else torch.clamp(cur, max=S_max - 1))  # (1,)

    qg = q.reshape(B, KV, G, hd)
    scale = 1.0 / np.sqrt(hd)
    s_cache = torch.einsum(
        "bkgd,bskd->bkgs", qg.to(k_cache.dtype).float(), k_cache.float()
    ) * scale  # (B, KV, G, S_loc) fp32
    pos = lo + torch.arange(S_loc, device=x.device)
    if window:
        age = torch.remainder(write_pos - pos, S_max)
        valid = (age >= 1) & (age <= torch.clamp(cur, max=window - 1))
    else:
        valid = pos < cur
    s_cache = torch.where(valid, s_cache, torch.full_like(s_cache, NEG_INF))
    s_new = torch.einsum(
        "bkgd,bkd->bkg", qg.float(), k_new[:, 0].float()
    )[..., None] * scale  # (B, KV, G, 1)

    if kv is None:
        # two-piece softmax, as the JAX decode path writes it
        m = torch.maximum(s_cache.max(dim=-1, keepdim=True).values, s_new)
        e_cache = torch.exp(s_cache - m)
        e_new = torch.exp(s_new - m)
        denom = e_cache.sum(dim=-1, keepdim=True) + e_new
        out_cache = torch.einsum(
            "bkgs,bskd->bkgd", e_cache.to(v_cache.dtype).float(),
            v_cache.float())
        out = (out_cache + e_new * v_new[:, 0, :, None].float()) / denom
    else:
        out = _combine(s_cache, v_cache, s_new, v_new[:, 0], policy.mesh, kv)
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    if rows is not None:
        out = gather_cat(out, policy.mesh, policy.cache_batch, 0)
    y = _output(out, p, policy)

    if kv is None:
        k_cache.index_copy_(1, write_pos, k_new.to(k_cache.dtype))
        v_cache.index_copy_(1, write_pos, v_new.to(v_cache.dtype))
    else:
        # the owner of write_pos writes it; every other rank writes its
        # clamped slot's own value back
        local = write_pos - lo
        mine = ((local >= 0) & (local < S_loc)).reshape(1, 1, 1, 1)
        idx = torch.clamp(local, 0, S_loc - 1)
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            keep = cache.index_select(1, idx)
            cache.index_copy_(1, idx, torch.where(mine, new.to(cache.dtype),
                                                  keep))
    return y


def attention_decode_paged(x, p, k_pool, v_pool, block_tables, cur_len,
                           config: ModelConfig, policy=None):
    """One decode step against one layer's paged KV pool.

    x (B, 1, D); ``k_pool``/``v_pool`` (N, bs, KV, hd); ``block_tables``
    (B, n_max) int32 maps each row's logical positions onto physical blocks
    (block 0 is the null block); ``cur_len`` (B,) int32 per-row lengths.
    Returns out (B, 1, D).

    The new K/V is written **in place** into the pools at physical
    ``(table[cur_len // bs], cur_len % bs)`` after the cached view has been
    gathered (the JAX version returns new pools instead). Rows whose entry
    is the null block may collide there; masked scores never read it.
    Under a ``policy`` the projections are the rank's shards and the pool
    is whole on every rank, as JAX's is.
    """
    B = x.shape[0]
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    G = H // KV
    bs = k_pool.shape[-3]
    n_max = block_tables.shape[-1]
    S_v = n_max * bs

    q, k_new, v_new = _project_qkv(x, p, config, policy)
    cos, sin = rope(cur_len, hd, config.rope_theta)  # (B, hd/2)
    q = apply_rope(q, cos[:, None], sin[:, None])
    k_new = apply_rope(k_new, cos[:, None], sin[:, None])

    tables = block_tables.long()
    k_view = k_pool[tables].reshape(B, S_v, KV, hd)
    v_view = v_pool[tables].reshape(B, S_v, KV, hd)

    qg = q.reshape(B, KV, G, hd)
    scale = 1.0 / np.sqrt(hd)
    s_cache = torch.einsum(
        "bkgd,bskd->bkgs", qg.to(k_view.dtype).float(), k_view.float()
    ) * scale  # (B, KV, G, S_v) fp32
    pos = torch.arange(S_v, device=x.device)
    valid = pos[None, :] < cur_len[:, None].long()
    s_cache = torch.where(
        valid[:, None, None, :], s_cache, torch.full_like(s_cache, NEG_INF)
    )
    s_new = torch.einsum(
        "bkgd,bkd->bkg", qg.float(), k_new[:, 0].float()
    )[..., None] * scale  # (B, KV, G, 1)

    # two-piece softmax, as the JAX decode path writes it
    m = torch.maximum(s_cache.max(dim=-1, keepdim=True).values, s_new)
    e_cache = torch.exp(s_cache - m)
    e_new = torch.exp(s_new - m)
    denom = e_cache.sum(dim=-1, keepdim=True) + e_new
    out_cache = torch.einsum(
        "bkgs,bskd->bkgd", e_cache.to(v_view.dtype).float(), v_view.float()
    )
    out = (out_cache + e_new * v_new[:, 0, :, None].float()) / denom
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    y = _output(out, p, policy)

    rows = torch.arange(B, device=x.device)
    blk = tables[rows, (cur_len // bs).long()]
    off = (cur_len % bs).long()
    k_pool[blk, off] = k_new[:, 0].to(k_pool.dtype)
    v_pool[blk, off] = v_new[:, 0].to(v_pool.dtype)
    return y
