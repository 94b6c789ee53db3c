"""Mamba2 (SSD, state-space duality) blocks: chunked prefill and O(1)
decode. Port of ``repro/models/ssm.py`` in plain torch ops; the reference
is plain XLA too, so there is no kernel to port.

The SSD recurrence per head h with state (hd, N)::

    h_t = exp(dt_t · A) · h_{t-1} + dt_t · (x_t ⊗ B_t)
    y_t = C_t · h_t + D · x_t

The prefill runs the chunked dual form: a loop over chunks of Q tokens,
the quadratic form within a chunk and the linear recurrence across chunks,
in fp32 where the JAX code is. Decode carries the (B, nh, hd, N) fp32 state
and the causal conv's last ``cw − 1`` inputs, and updates both **in
place** (the JAX version returns a new cache), so a captured decode step
reads and writes them at fixed addresses.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import normal_init

__all__ = ["init_ssm", "ssm_train", "ssm_decode", "ssm_cache_zeros"]


def init_ssm(config: ModelConfig, *, num_layers: int, dtype, device,
             generator: torch.Generator):
    D, di, N = config.d_model, config.d_inner, config.ssm_state
    nh, cw = config.ssm_heads, config.ssm_conv
    s = float(1.0 / np.sqrt(D))

    def normal(shape, scale):
        return normal_init(shape, scale, dtype=dtype, device=device,
                           generator=generator)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    a_log = torch.log(torch.arange(1, nh + 1, dtype=torch.float32))
    return {
        "wz": normal((num_layers, D, di), s),
        "wx": normal((num_layers, D, di), s),
        "wb": normal((num_layers, D, N), s),
        "wc": normal((num_layers, D, N), s),
        "wdt": normal((num_layers, D, nh), s),
        "dt_bias": zeros(num_layers, nh),
        "A_log": a_log.repeat(num_layers, 1).to(device=device, dtype=dtype),
        "D": torch.ones((num_layers, nh), dtype=dtype, device=device),
        "conv_x_w": normal((num_layers, cw, di), 0.3),
        "conv_x_b": zeros(num_layers, di),
        "conv_b_w": normal((num_layers, cw, N), 0.3),
        "conv_b_b": zeros(num_layers, N),
        "conv_c_w": normal((num_layers, cw, N), 0.3),
        "conv_c_b": zeros(num_layers, N),
        "gate_norm": zeros(num_layers, di),
        "out_proj": normal((num_layers, di, D), float(1.0 / np.sqrt(di))),
    }


def ssm_cache_zeros(config: ModelConfig, batch: int, leading: tuple, *,
                    dtype, device):
    """The decode cache of ``leading`` SSM blocks: ``state`` (…, B, nh,
    hd, N) fp32 and the conv buffers ``conv_x`` (…, B, cw − 1, d_inner),
    ``conv_b``/``conv_c`` (…, B, cw − 1, N) in ``dtype``."""
    nh, hd, N = config.ssm_heads, config.ssm_head_dim, config.ssm_state
    cw, di = config.ssm_conv, config.d_inner
    shape = (*leading, batch)
    return {
        "state": torch.zeros((*shape, nh, hd, N), dtype=torch.float32,
                             device=device),
        "conv_x": torch.zeros((*shape, cw - 1, di), dtype=dtype, device=device),
        "conv_b": torch.zeros((*shape, cw - 1, N), dtype=dtype, device=device),
        "conv_c": torch.zeros((*shape, cw - 1, N), dtype=dtype, device=device),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B, S, C), w (cw, C), b (C) → (B, S, C)."""
    cw, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def _conv_step(x_t, buf, w, b):
    """One token through the conv: x_t (B, C), buf (B, cw − 1, C) → (out
    (B, C), the next buffer (B, cw − 1, C))."""
    window = torch.cat([buf, x_t[:, None]], dim=1)  # (B, cw, C)
    out = torch.einsum("bwc,wc->bc", window, w) + b
    return out, window[:, 1:]


def _project(x, p):
    z = torch.matmul(x, p["wz"])
    xs = torch.matmul(x, p["wx"])
    Bp = torch.matmul(x, p["wb"])
    Cp = torch.matmul(x, p["wc"])
    dt = torch.matmul(x, p["wdt"]) + p["dt_bias"]
    return z, xs, Bp, Cp, F.softplus(dt.float())


def _gated_out(y, z, p, config: ModelConfig):
    """y (B, S, d_inner) fp32, z (B, S, d_inner) → out (B, S, D): the
    silu(z) gate, an RMS norm per SSD head, the ``1 + gate_norm`` gain."""
    y = y * F.silu(z.float())
    B, S = y.shape[:2]
    nh, hd = config.ssm_heads, config.ssm_head_dim
    yh = y.reshape(B, S, nh, hd)
    var = torch.mean(yh * yh, dim=-1, keepdim=True)
    yh = yh * torch.rsqrt(var + config.norm_eps)
    y = yh.reshape(B, S, nh * hd) * (1.0 + p["gate_norm"].float())
    return torch.matmul(y.to(z.dtype), p["out_proj"])


def ssm_train(x, p, config: ModelConfig, *, return_cache: bool = False):
    """x (B, S, D) → (out (B, S, D), cache dict | None).

    The chunk size Q is the largest divisor of S not above
    ``config.ssm_chunk``, as in the JAX version, so a ragged S gives
    smaller chunks, not a short last one. The cache holds the final state
    and the *pre-activation* conv inputs of the last ``cw − 1`` tokens.
    """
    B, S, _ = x.shape
    nh, hd, N = config.ssm_heads, config.ssm_head_dim, config.ssm_state
    Q = min(config.ssm_chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q

    z, xs, Bp, Cp, dt = _project(x, p)
    xs = F.silu(_causal_conv(xs, p["conv_x_w"], p["conv_x_b"]))
    Bp = F.silu(_causal_conv(Bp, p["conv_b_w"], p["conv_b_b"]))
    Cp = F.silu(_causal_conv(Cp, p["conv_c_w"], p["conv_c_b"]))

    A = -torch.exp(p["A_log"].float())  # (nh,)
    xh = xs.reshape(B, S, nh, hd).float()
    dtx = xh * dt[..., None]  # (B, S, nh, hd)
    dA = dt * A  # (B, S, nh)
    dA_c = dA.reshape(B, nc, Q, nh)
    dtx_c = dtx.reshape(B, nc, Q, nh, hd)
    B_c = Bp.float().reshape(B, nc, Q, N)
    C_c = Cp.float().reshape(B, nc, Q, N)
    tri = (torch.arange(Q, device=x.device)[:, None]
           >= torch.arange(Q, device=x.device)[None, :])[None, ..., None]

    h = torch.zeros((B, nh, hd, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        dA_b, dtx_b, B_b, C_b = dA_c[:, c], dtx_c[:, c], B_c[:, c], C_c[:, c]
        cum = torch.cumsum(dA_b, dim=1)  # (B, Q, nh)
        # within-chunk quadratic form
        scores = torch.einsum("bqn,bkn->bqk", C_b, B_b)
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Q, Q, nh)
        # masked before the exp: above the diagonal seg > 0 can overflow,
        # and where(tri, exp(seg), 0) then has a 0 · inf = NaN gradient
        # (the reference's does); exp(−inf) = 0 gives the same values
        Lmat = torch.exp(seg.masked_fill(~tri, float("-inf")))
        y_diag = torch.einsum("bqk,bqkh,bkhp->bqhp", scores, Lmat, dtx_b)
        # the carried state's contribution
        y_off = torch.einsum("bqn,bqh,bhpn->bqhp", C_b, torch.exp(cum), h)
        # the chunk's state update
        decay_out = torch.exp(cum[:, -1:, :] - cum)  # (B, Q, nh)
        states = torch.einsum("bkn,bkh,bkhp->bhpn", B_b, decay_out, dtx_b)
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + states
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(B, S, nh, hd)
    y = y + xh * p["D"].float()[None, None, :, None]
    out = _gated_out(y.reshape(B, S, nh * hd), z, p, config)

    cache = None
    if return_cache:
        cw = config.ssm_conv
        _, xs2, Bp2, Cp2, _ = _project(x[:, S - (cw - 1):], p)
        cache = {"state": h, "conv_x": xs2, "conv_b": Bp2, "conv_c": Cp2}
    return out, cache


def ssm_decode(x, p, cache, config: ModelConfig):
    """One token: x (B, 1, D) → out (B, 1, D). ``cache`` holds one block's
    ``state`` and conv buffers (:func:`ssm_cache_zeros` without the
    leading dims), updated in place."""
    B = x.shape[0]
    nh, hd = config.ssm_heads, config.ssm_head_dim
    z, xs, Bp, Cp, dt = _project(x, p)
    xs, bx = _conv_step(xs[:, 0], cache["conv_x"], p["conv_x_w"], p["conv_x_b"])
    Bp, bb = _conv_step(Bp[:, 0], cache["conv_b"], p["conv_b_w"], p["conv_b_b"])
    Cp, bc = _conv_step(Cp[:, 0], cache["conv_c"], p["conv_c_w"], p["conv_c_b"])
    xs, Bp, Cp = F.silu(xs), F.silu(Bp), F.silu(Cp)

    A = -torch.exp(p["A_log"].float())
    dt1 = dt[:, 0]  # (B, nh)
    xh = xs.reshape(B, nh, hd).float()
    decay = torch.exp(dt1 * A)[:, :, None, None]  # (B, nh, 1, 1)
    inject = torch.einsum("bh,bhp,bn->bhpn", dt1, xh, Bp.float())
    h_new = cache["state"] * decay + inject
    y = torch.einsum("bn,bhpn->bhp", Cp.float(), h_new)
    y = y + xh * p["D"].float()[None, :, None]
    out = _gated_out(y.reshape(B, 1, nh * hd), z, p, config)
    cache["state"].copy_(h_new)
    cache["conv_x"].copy_(bx)
    cache["conv_b"].copy_(bb)
    cache["conv_c"].copy_(bc)
    return out
