"""Attention: causal prefill over a whole prompt and paged decode.

Plain torch products, as the JAX package leaves them to XLA
(``repro/models/attention.py``): there is no attention kernel to port.
Weights keep the JAX layouts — ``wq`` (D, H·hd), ``wk``/``wv`` (D, KV·hd),
``wo`` (H·hd, D) — and the paged pool is (N, bs, KV, hd) per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .layers import apply_rope, rms_norm, rope

__all__ = [
    "init_attention",
    "attention_train",
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
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

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
    """Causal self-attention over the whole sequence (full attention only).

    x (B, S, D) → (out (B, S, D), (k, v) each (B, S, KV, hd) | None). The
    JAX version chunks queries to bound its score matrix; each row's
    softmax is the same, so one chunk gives the same numbers.
    """
    if config.sliding_window > 0:
        raise NotImplementedError("sliding-window attention is not ported yet")
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
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    out = out.reshape(B, S, H * hd)
    y = torch.matmul(out, p["wo"])
    return y, ((k, v) if return_cache else None)


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
