"""Model FLOPs of a configuration's forward pass.

A frozen copy of the port's ``ModelConfig.param_count`` and
``active_param_count`` (attention and MoE families): two FLOPs a token
for each parameter a token touches, plus attention's score and value
products, 4·H·hd FLOPs for each key a query attends to, per layer.
``model`` is the ``"model"`` object of a configuration file."""
from __future__ import annotations


def _head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def param_count(m: dict) -> int:
    D, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    total = V * D if m.get("tie_embeddings") else 2 * V * D
    hd, H, KV = _head_dim(m), m["num_heads"], m["num_kv_heads"]
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    E = m.get("num_experts", 0)
    if E:
        ffn = E * (3 * D * m["expert_d_ff"]) + D * E
    else:
        ffn = 3 * D * m["d_ff"]
    return total + L * (attn + ffn + 2 * D)


def active_param_count(m: dict) -> int:
    E = m.get("num_experts", 0)
    if not E:
        return param_count(m)
    D, L, F = m["d_model"], m["num_layers"], m["expert_d_ff"]
    dense = param_count(m) - L * E * 3 * D * F
    return dense + L * m["experts_per_token"] * 3 * D * F


def attention_flops(m: dict, keys: int) -> float:
    """One query attending to ``keys`` keys, over every layer."""
    return 4.0 * m["num_heads"] * _head_dim(m) * keys * m["num_layers"]


def _keys(m: dict, ctx: int) -> int:
    w = m.get("sliding_window", 0)
    return min(ctx, w) if w else ctx


def prefill_flops(m: dict, prompt_len: int) -> float:
    """A whole prompt: every token's parameters, and causal attention
    (query i sees i + 1 keys, at most the window)."""
    n = active_param_count(m)
    P, w = prompt_len, m.get("sliding_window", 0) or prompt_len
    full = min(P, w)
    att = full * (full + 1) // 2 + (P - full) * w
    return 2.0 * n * P + attention_flops(m, att)


def decode_flops(m: dict, ctx: int) -> float:
    """One decoded token whose query sees ``ctx`` keys (itself included)."""
    return 2.0 * active_param_count(m) + attention_flops(m, _keys(m, ctx))


def train_flops_per_token(m: dict) -> float:
    """6·N_active: forward and backward of the parameters a token
    touches."""
    return 6.0 * active_param_count(m)
