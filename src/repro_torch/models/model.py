"""Model assembly for the MoE family: embed → layers → norm → logits.

Port of the MoE path of ``repro/models/model.py``. Parameters are a plain
dict in the JAX pytree's layout, per-layer weights stacked on a leading L
dim::

    {"embed": (V_pad, D), "final_norm": (D,),
     "blocks": {"ln1": (L, D), "ln2": (L, D),
                "attn": {"wq", "wk", "wv", "wo"},
                "moe": {"router", "w_gate", "w_up", "w_down"}}}

(plus ``"lm_head"`` (D, V_pad) for untied configs). The layer stack is a
Python loop over layers, the JAX package's ``"python"`` mode.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import attention_decode_paged, attention_train, init_attention
from .layers import embed_tokens, lm_logits, rms_norm
from .moe import MoEAux, identity_placement, init_moe, moe_layer

__all__ = [
    "init_params",
    "prefill",
    "init_paged_decode_cache",
    "decode_step",
]


def _check_family(config: ModelConfig) -> None:
    if not config.is_moe or config.is_ssm or config.is_hybrid:
        raise NotImplementedError(
            f"{config.name}: only the MoE attention family is ported yet"
        )


def init_params(config: ModelConfig, *, seed: int = 0, device=None,
                dtype=torch.bfloat16):
    """Random weights from a generator seeded with ``seed``, made on
    ``device`` (the card unless ``device="cpu"``)."""
    _check_family(config)
    L, D, V = config.num_layers, config.d_model, config.padded_vocab
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(shape, scale):
        w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    params: dict[str, Any] = {"embed": normal((V, D), 0.02)}
    if not config.tie_embeddings:
        params["lm_head"] = normal((D, V), 0.02)
    params["final_norm"] = torch.zeros((D,), dtype=dtype, device=device)
    params["blocks"] = {
        "ln1": torch.zeros((L, D), dtype=dtype, device=device),
        "ln2": torch.zeros((L, D), dtype=dtype, device=device),
        "attn": init_attention(config, num_layers=L, dtype=dtype,
                               device=device, generator=g),
        "moe": init_moe(config, num_layers=L, dtype=dtype, device=device,
                        generator=g),
    }
    return params


def _layer(tree, i: int):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _stack_aux(auxes: list[MoEAux]) -> MoEAux:
    """Per-layer aux → one MoEAux with (L, …) fields."""
    return MoEAux(*(
        torch.stack([getattr(a, f) for a in auxes])
        for f in MoEAux.__dataclass_fields__
    ))


def prefill(params, tokens, config: ModelConfig, placements=None):
    """tokens (B, S) → (last-position logits (B, V_pad) fp32, caches).

    caches: ``{"attn": {"k": (L, B, S, KV, hd), "v": …}}``.
    """
    _check_family(config)
    L = config.num_layers
    if placements is None:
        placements = identity_placement(config, L, device=tokens.device)
    blocks = params["blocks"]
    x = embed_tokens(tokens, params["embed"], config)
    ks, vs = [], []
    for i in range(L):
        lp = _layer(blocks, i)
        h = rms_norm(x, lp["ln1"], config.norm_eps)
        a, (k, v) = attention_train(h, lp["attn"], config, return_cache=True)
        ks.append(k)
        vs.append(v)
        x = x + a
        h2 = rms_norm(x, lp["ln2"], config.norm_eps)
        y, _ = moe_layer(h2, lp["moe"], placements[i], config)
        x = x + y
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = lm_logits(x[:, -1:], params, config)
    return logits[:, 0], {"attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def init_paged_decode_cache(config: ModelConfig, num_blocks: int,
                            block_size: int, *, device, dtype=torch.bfloat16):
    """Paged KV pools ``(L, N, block_size, KV, hd)`` per K/V."""
    _check_family(config)
    if config.sliding_window > 0:
        raise ValueError("paged KV cache does not support sliding windows")
    shape = (config.num_layers, num_blocks, block_size, config.num_kv_heads,
             config.head_dim)
    return {"attn": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }}


def decode_step(params, caches, cur_len, tokens, config: ModelConfig,
                placements=None, *, block_tables):
    """One serving step on the paged cache: tokens (B, 1) int32,
    ``cur_len`` (B,) int32, ``block_tables`` (B, n_max) int32.

    Returns (logits (B, V_pad) fp32, caches, moe aux with (L, …) fields).
    The pools in ``caches`` are updated in place (each layer writes its new
    K/V row) and returned, where the JAX version returns new pools.
    """
    _check_family(config)
    L = config.num_layers
    if placements is None:
        placements = identity_placement(config, L, device=tokens.device)
    blocks = params["blocks"]
    pools = caches["attn"]
    x = embed_tokens(tokens, params["embed"], config)
    auxes = []
    for i in range(L):
        lp = _layer(blocks, i)
        h = rms_norm(x, lp["ln1"], config.norm_eps)
        a = attention_decode_paged(
            h, lp["attn"], pools["k"][i], pools["v"][i], block_tables,
            cur_len, config,
        )
        x = x + a
        h2 = rms_norm(x, lp["ln2"], config.norm_eps)
        y, aux = moe_layer(
            h2, lp["moe"], placements[i], config,
            capacity_factor=config.decode_capacity_factor,
        )
        auxes.append(aux)
        x = x + y
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = lm_logits(x, params, config)
    return logits[:, 0], caches, _stack_aux(auxes)
