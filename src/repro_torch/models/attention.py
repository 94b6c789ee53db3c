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
from .layers import apply_rope, normal_init, rms_norm, rope

__all__ = [
    "init_attention",
    "attention_train",
    "attention_decode",
    "attention_decode_paged",
]

NEG_INF = -1e30


def init_attention(config: ModelConfig, *, num_layers: int, dtype, device,
                   generator: torch.Generator):
    D = config.d_model
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    s = float(1.0 / np.sqrt(D))
    so = float(1.0 / np.sqrt(H * hd))

    def normal(shape, scale):
        return normal_init(shape, scale, dtype=dtype, device=device,
                           generator=generator)

    params = {
        "wq": normal((num_layers, D, H * hd), s),
        "wk": normal((num_layers, D, KV * hd), s),
        "wv": normal((num_layers, D, KV * hd), s),
        "wo": normal((num_layers, H * hd, D), so),
    }
    if config.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            params[name] = torch.zeros((num_layers, width), dtype=dtype,
                                       device=device)
    if config.qk_norm:
        for name in ("q_norm", "k_norm"):
            params[name] = torch.zeros((num_layers, hd), dtype=dtype,
                                       device=device)
    return params


def _project_qkv(x, p, config: ModelConfig):
    """x (B, S, D) → q (B,S,H,hd), k/v (B,S,KV,hd) (pre-RoPE)."""
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if config.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    B, S = x.shape[:2]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if config.qk_norm:
        q = rms_norm(q, p["q_norm"], config.norm_eps)
        k = rms_norm(k, p["k_norm"], config.norm_eps)
    return q, k, v


def attention_train(x, p, config: ModelConfig, *, return_cache: bool = False):
    """Causal self-attention over the whole sequence; with
    ``config.sliding_window`` w > 0, query q sees keys k with q − k < w.

    x (B, S, D) → (out (B, S, D), (k, v) each (B, S, KV, hd) | None). The
    JAX version chunks queries to bound its score matrix, and under a
    window gathers a static-width key block per chunk; masked keys get
    ``exp(−1e30 − m) = 0`` in either layout, so one masked pass over the
    whole row gives each row the same softmax.
    """
    B, S, _ = x.shape
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    G = H // KV
    q, k, v = _project_qkv(x, p, config)
    cos, sin = rope(torch.arange(S, device=x.device), hd, config.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, S, KV, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    pos = torch.arange(S, device=x.device)
    mask = pos[:, None] >= pos[None, :]  # (q, s)
    if config.sliding_window > 0:
        mask &= (pos[:, None] - pos[None, :]) < config.sliding_window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    out = out.reshape(B, S, H * hd)
    y = torch.matmul(out, p["wo"])
    return y, ((k, v) if return_cache else None)


def attention_decode(x, p, k_cache, v_cache, cur_len, config: ModelConfig):
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
    """
    B = x.shape[0]
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    G = H // KV
    S_max = k_cache.shape[-3]
    q, k_new, v_new = _project_qkv(x, p, config)
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
    ) * scale  # (B, KV, G, S_max) fp32
    pos = torch.arange(S_max, device=x.device)
    if window:
        age = torch.remainder(write_pos - pos, S_max)
        valid = (age >= 1) & (age <= torch.clamp(cur, max=window - 1))
    else:
        valid = pos < cur
    s_cache = torch.where(valid, s_cache, torch.full_like(s_cache, NEG_INF))
    s_new = torch.einsum(
        "bkgd,bkd->bkg", qg.float(), k_new[:, 0].float()
    )[..., None] * scale  # (B, KV, G, 1)

    # two-piece softmax, as the JAX decode path writes it
    m = torch.maximum(s_cache.max(dim=-1, keepdim=True).values, s_new)
    e_cache = torch.exp(s_cache - m)
    e_new = torch.exp(s_new - m)
    denom = e_cache.sum(dim=-1, keepdim=True) + e_new
    out_cache = torch.einsum(
        "bkgs,bskd->bkgd", e_cache.to(v_cache.dtype).float(), v_cache.float()
    )
    out = (out_cache + e_new * v_new[:, 0, :, None].float()) / denom
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    y = torch.matmul(out, p["wo"])

    k_cache.index_copy_(1, write_pos, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, write_pos, v_new.to(v_cache.dtype))
    return y


def attention_decode_paged(x, p, k_pool, v_pool, block_tables, cur_len,
                           config: ModelConfig):
    """One decode step against one layer's paged KV pool.

    x (B, 1, D); ``k_pool``/``v_pool`` (N, bs, KV, hd); ``block_tables``
    (B, n_max) int32 maps each row's logical positions onto physical blocks
    (block 0 is the null block); ``cur_len`` (B,) int32 per-row lengths.
    Returns out (B, 1, D).

    The new K/V is written **in place** into the pools at physical
    ``(table[cur_len // bs], cur_len % bs)`` after the cached view has been
    gathered (the JAX version returns new pools instead). Rows whose entry
    is the null block may collide there; masked scores never read it.
    """
    B = x.shape[0]
    H, KV, hd = config.num_heads, config.num_kv_heads, config.head_dim
    G = H // KV
    bs = k_pool.shape[-3]
    n_max = block_tables.shape[-1]
    S_v = n_max * bs

    q, k_new, v_new = _project_qkv(x, p, config)
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
    y = torch.matmul(out, p["wo"])

    rows = torch.arange(B, device=x.device)
    blk = tables[rows, (cur_len // bs).long()]
    off = (cur_len % bs).long()
    k_pool[blk, off] = k_new[:, 0].to(k_pool.dtype)
    v_pool[blk, off] = v_new[:, 0].to(v_pool.dtype)
    return y
