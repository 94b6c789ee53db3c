"""The benchmark's weights, made on the device from ``--seed``.

One ``torch.Generator`` on the device, one draw a leaf (every layer's
slice of a leaf in the same call), in the dtype the configuration serves
in. The same seed on the same device gives the same bits, so the check
that decides ``correct`` makes them again for the plain reference once
the program's copy is freed, in their original (virtual-expert) order.

The tree has the port's layout (``repro_torch.models.model``'s module
notes); nothing here imports the port. The norm gains are drawn too (the
port initialises them to zero, a gain of exactly 1), so that a path that
drops a gain shows in the comparison."""
from __future__ import annotations

import math

import torch

WEIGHT_STREAM = 0x77E1


def padded_vocab(m: dict) -> int:
    return ((m["vocab_size"] + 127) // 128) * 128


def make(m: dict, seed: int, device, dtype) -> dict:
    """The weights of configuration ``m`` (its ``"model"`` object)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + WEIGHT_STREAM) % (2**63))

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype).mul_(scale)

    L, D, V = m["num_layers"], m["d_model"], padded_vocab(m)
    H, KV = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or D // H
    E, tp = m["num_experts"], m["expert_tp"]
    Ev, Fv = E * tp, m["expert_d_ff"] // tp
    params = {"embed": normal((V, D), 0.02)}
    if not m.get("tie_embeddings"):
        params["lm_head"] = normal((D, V), 0.02)
    params["final_norm"] = normal((D,), 0.1)
    params["blocks"] = {
        "ln1": normal((L, D), 0.1),
        "ln2": normal((L, D), 0.1),
        "attn": {
            "wq": normal((L, D, H * hd), 1 / math.sqrt(D)),
            "wk": normal((L, D, KV * hd), 1 / math.sqrt(D)),
            "wv": normal((L, D, KV * hd), 1 / math.sqrt(D)),
            "wo": normal((L, H * hd, D), 1 / math.sqrt(H * hd)),
        },
        "moe": {
            "router": normal((L, D, E), 1 / math.sqrt(D)),
            "w_gate": normal((L, Ev, D, Fv), 1 / math.sqrt(D)),
            "w_up": normal((L, Ev, D, Fv), 1 / math.sqrt(D)),
            "w_down": normal((L, Ev, Fv, D), 1 / math.sqrt(m["expert_d_ff"])),
        },
    }
    return params


def leaves(tree, prefix=""):
    """(path, tensor) pairs in a fixed order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v
