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

**Under a model axis** (JAX's layout, ``repro/models/ssm.py:14-18``) each
rank holds and runs its block of the SSD heads: its columns of ``wz``,
``wx`` and ``wdt``, its heads' ``dt_bias``/``A_log``/``D``, its channels
of the depthwise ``conv_x`` and of ``gate_norm``, its rows of
``out_proj``, its heads of the decode state and its channels of
``conv_x``'s buffer; the B/C projections and their convolutions are whole
on every rank (O(S·N)). The gated norm is per head, so it is exact on a
rank's heads. ``out_proj``'s row partials are summed over the axis in fp32
in rank order and rounded once (one device's product rounds its own fp32
sum once; the order differs). In prefill and training the block takes the
whole sequence: sequence-parallel, it gathers the rank's rows on entry
and reduce-scatters the out-projection
(:func:`~repro_torch.kernels.sharded.scatter_sum`); else every rank holds
every row and the partials are summed whole
(:func:`~repro_torch.kernels.sharded.sum_over`). Each rank's heads give a
part of the input's cotangent and of the B/C activations', which are
summed over the axis in fp32 (:mod:`repro_torch.kernels.sharded`), so
the B/C leaves' gradients are whole and alike on every rank.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.sharded import (
    gather_cat,
    gather_fsdp,
    rows_linear,
    scatter_sum,
    sum_grads_over,
    sum_over,
)
from ..sharding.policy import model_axis, shard_range
from .layers import normal_init

__all__ = ["init_ssm", "ssm_train", "ssm_decode", "ssm_cache_zeros"]


def init_ssm(config: ModelConfig, *, num_layers: int, dtype, device,
             generator: torch.Generator, shard=None):
    """Random projections and convolutions, zero biases and gains,
    ``A_log = log(1…nh)``. ``shard``, given a leaf's name, returns the
    function that keeps a rank's block of it, or None for a whole leaf
    (:func:`~repro_torch.models.attention.init_attention`'s)."""
    D, di, N = config.d_model, config.d_inner, config.ssm_state
    nh, cw = config.ssm_heads, config.ssm_conv
    s = float(1.0 / np.sqrt(D))
    shard = shard or (lambda name: None)

    def normal(name, shape, scale):
        return normal_init(shape, scale, dtype=dtype, device=device,
                           generator=generator, shard=shard(name))

    def made(name, t):
        keep = shard(name)
        return t if keep is None else keep(t).contiguous()

    def zeros(name, *shape):
        return made(name, torch.zeros(shape, dtype=dtype, device=device))

    a_log = torch.log(torch.arange(1, nh + 1, dtype=torch.float32))
    return {
        "wz": normal("wz", (num_layers, D, di), s),
        "wx": normal("wx", (num_layers, D, di), s),
        "wb": normal("wb", (num_layers, D, N), s),
        "wc": normal("wc", (num_layers, D, N), s),
        "wdt": normal("wdt", (num_layers, D, nh), s),
        "dt_bias": zeros("dt_bias", num_layers, nh),
        "A_log": made("A_log", a_log.repeat(num_layers, 1).to(
            device=device, dtype=dtype)),
        "D": made("D", torch.ones((num_layers, nh), dtype=dtype,
                                  device=device)),
        "conv_x_w": normal("conv_x_w", (num_layers, cw, di), 0.3),
        "conv_x_b": zeros("conv_x_b", num_layers, di),
        "conv_b_w": normal("conv_b_w", (num_layers, cw, N), 0.3),
        "conv_b_b": zeros("conv_b_b", num_layers, N),
        "conv_c_w": normal("conv_c_w", (num_layers, cw, N), 0.3),
        "conv_c_b": zeros("conv_c_b", num_layers, N),
        "gate_norm": zeros("gate_norm", num_layers, di),
        "out_proj": normal("out_proj", (num_layers, di, D),
                           float(1.0 / np.sqrt(di))),
    }


def ssm_cache_zeros(config: ModelConfig, batch: int, leading: tuple, *,
                    dtype, device, policy=None):
    """The decode cache of ``leading`` SSM blocks: ``state`` (…, B, nh,
    hd, N) fp32 and the conv buffers ``conv_x`` (…, B, cw − 1, d_inner),
    ``conv_b``/``conv_c`` (…, B, cw − 1, N) in ``dtype``. Under a
    ``policy`` with a model axis, the rank's heads of ``state`` and its
    channels of ``conv_x`` (raises where the axis does not divide them);
    ``batch`` is the rows the rank holds."""
    nh, hd, N = config.ssm_heads, config.ssm_head_dim, config.ssm_state
    cw, di = config.ssm_conv, config.d_inner
    axis = model_axis(policy)
    if axis is not None:
        block = shard_range(nh, axis, policy.mesh, leaf="the SSM state",
                            dim=len(leading) + 1)
        nh = block.stop - block.start
        di = nh * hd
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


def _project_heads(h, p, mesh, axis, seq_sharded: bool):
    """:func:`_project` under a model axis: the rank's columns of z, x
    and dt over every row, B and C whole, and ``h`` over every row.
    ``seq_sharded``: ``h`` is the rank's block of rows, gathered whole for
    the heads' projections (the adjoint sums the ranks' parts), while B
    and C are projected on the block by the whole weights
    (:func:`~repro_torch.kernels.sharded.rows_linear`: their gradients
    over every rank's rows) and gathered; else ``h`` holds every row,
    alike on every rank, and the heads' projections take it through
    :func:`~repro_torch.kernels.sharded.sum_grads_over`."""
    if seq_sharded:
        heads = gather_fsdp(h, mesh, axis, 1)
        wbc = torch.cat([p["wb"], p["wc"]], dim=-1)
        bc = gather_cat(rows_linear(h, wbc, None, mesh, axis, wdim=None),
                        mesh, axis, 1)
        Bp, Cp = bc.split(p["wb"].shape[-1], dim=-1)
    else:
        heads = sum_grads_over(h, mesh, axis)
        Bp, Cp = torch.matmul(h, p["wb"]), torch.matmul(h, p["wc"])
    z = torch.matmul(heads, p["wz"])
    xs = torch.matmul(heads, p["wx"])
    dt = torch.matmul(heads, p["wdt"]) + p["dt_bias"]
    return z, xs, Bp, Cp, F.softplus(dt.float()), heads


def _gated(y, z, p, config: ModelConfig):
    """y (B, S, h·hd) fp32 of h heads, z (B, S, h·hd) → (B, S, h·hd) in
    z's dtype: the silu(z) gate, an RMS norm per SSD head, the ``1 +
    gate_norm`` gain."""
    y = y * F.silu(z.float())
    B, S = y.shape[:2]
    hd = config.ssm_head_dim
    yh = y.reshape(B, S, -1, hd)
    var = torch.mean(yh * yh, dim=-1, keepdim=True)
    yh = yh * torch.rsqrt(var + config.norm_eps)
    y = yh.reshape(B, S, -1) * (1.0 + p["gate_norm"].float())
    return y.to(z.dtype)


def _out_proj(y, p, policy, *, scatter: bool = False):
    """y (B, S, h·hd) → (B, S, D) (``scatter``: the rank's block of S/M
    rows). Under a model axis the rank's rows of ``out_proj`` give an fp32
    partial, summed over the axis in rank order and rounded once."""
    axis = model_axis(policy)
    if axis is None:
        return torch.matmul(y, p["out_proj"])
    part = torch.matmul(y.float(), p["out_proj"].float())
    if scatter:
        return scatter_sum(part, policy.mesh, axis, 1, y.dtype)
    return sum_over(part, policy.mesh, axis).to(y.dtype)


def ssm_train(x, p, config: ModelConfig, *, return_cache: bool = False,
              policy=None, seq_sharded: bool = False):
    """x (B, S, D) → (out (B, S, D), cache dict | None).

    The chunk size Q is the largest divisor of S not above
    ``config.ssm_chunk``, as in the JAX version, so a ragged S gives
    smaller chunks, not a short last one. The cache holds the final state
    and the *pre-activation* conv inputs of the last ``cw − 1`` tokens.

    Under a ``policy`` with a model axis ``p`` holds the rank's heads (see
    the module's notes) and so does the cache's state and ``conv_x``. With
    ``seq_sharded`` x and the output are the rank's block of S/M rows;
    else every rank holds every row.
    """
    axis = model_axis(policy)
    if axis is None:
        z, xs, Bp, Cp, dt = _project(x, p)
    else:  # x: every row, whole
        z, xs, Bp, Cp, dt, x = _project_heads(x, p, policy.mesh, axis,
                                              seq_sharded)
    B, S, _ = z.shape
    hd, N = config.ssm_head_dim, config.ssm_state
    nh = p["A_log"].shape[-1]  # the heads this rank runs
    Q = min(config.ssm_chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q

    xs = F.silu(_causal_conv(xs, p["conv_x_w"], p["conv_x_b"]))
    Bp = F.silu(_causal_conv(Bp, p["conv_b_w"], p["conv_b_b"])).float()
    Cp = F.silu(_causal_conv(Cp, p["conv_c_w"], p["conv_c_b"])).float()
    if axis is not None:  # the rank's heads give a part of B's and C's
        Bp = sum_grads_over(Bp, policy.mesh, axis)  # cotangents
        Cp = sum_grads_over(Cp, policy.mesh, axis)

    A = -torch.exp(p["A_log"].float())  # (nh,)
    xh = xs.reshape(B, S, nh, hd).float()
    dtx = xh * dt[..., None]  # (B, S, nh, hd)
    dA = dt * A  # (B, S, nh)
    dA_c = dA.reshape(B, nc, Q, nh)
    dtx_c = dtx.reshape(B, nc, Q, nh, hd)
    B_c = Bp.reshape(B, nc, Q, N)
    C_c = Cp.reshape(B, nc, Q, N)
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
    out = _out_proj(_gated(y.reshape(B, S, nh * hd), z, p, config), p,
                    policy, scatter=seq_sharded)

    cache = None
    if return_cache:
        # the conv inputs of the last cw − 1 tokens, projected again: only
        # x, B and C (z and dt of those tokens are not kept)
        tail = x[:, S - (config.ssm_conv - 1):]
        cache = {"state": h,
                 "conv_x": torch.matmul(tail, p["wx"]),
                 "conv_b": torch.matmul(tail, p["wb"]),
                 "conv_c": torch.matmul(tail, p["wc"])}
    return out, cache


def ssm_decode(x, p, cache, config: ModelConfig, policy=None, *,
               rows: slice | None = None):
    """One token: x (B, 1, D) → out (B, 1, D). ``cache`` holds one block's
    ``state`` and conv buffers (:func:`ssm_cache_zeros` without the
    leading dims), updated in place.

    Under a ``policy`` with a model axis ``p`` and the cache hold the
    rank's heads (the module's notes). ``rows``: the rows of x whose state
    the cache holds, when it holds only those
    (:func:`~repro_torch.models.model.decode_cache_rows`): the rank
    projects every row, steps its rows' state, and their outputs are
    gathered over the policy's cache-batch axes in row order."""
    hd = config.ssm_head_dim
    nh = p["A_log"].shape[-1]
    z, xs, Bp, Cp, dt = _project(x, p)
    if rows is not None:
        xs, Bp, Cp, dt = xs[rows], Bp[rows], Cp[rows], dt[rows]
    B = xs.shape[0]
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
    y = y.reshape(B, 1, nh * hd)
    if rows is not None:
        y = gather_cat(y, policy.mesh, policy.cache_batch, 0)
    out = _out_proj(_gated(y, z, p, config), p, policy)
    cache["state"].copy_(h_new)
    cache["conv_x"].copy_(bx)
    cache["conv_b"].copy_(bb)
    cache["conv_c"].copy_(bc)
    return out
