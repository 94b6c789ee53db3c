"""A plain PyTorch forward pass of the served MoE transformer, in float32
with TF32 off, over the prompts and served tokens of finished requests.

It follows the architecture the configuration states (pre-norm blocks of
grouped-query attention with rotary positions and a top-k mixture of
SwiGLU experts, RMSNorm with a ``1 + gain`` scale, tied or untied head)
and the serving semantics the engine documents, which decide what a
served token's logits are:

* **prefill** — each prompt alone, causal (and windowed) attention; the
  MoE layer dispatches the prompt as one group, each expert keeping the
  first ``C = ceil(P·k/E·cf)`` of the tokens that chose it, in token
  order, and dropping the rest (``capacity_factor``);
* **decode** — one token a step, attending to the row's cache and to
  itself. On the paged cache a row's keys are its own earlier tokens at
  their positions. On the dense ring (``kv="ring"``) every row of a step
  runs at one length shared by the batch, the longest row's: the token
  takes its rotary position and the ring's write index ``c mod ring``
  from it, and attends over every entry of the row's ring that the mask
  ``1 <= (write - pos) mod ring <= min(c, window - 1)`` keeps, including
  the zero entries past the row's own prompt, which score 0 and add
  nothing to the sum. The shared lengths ``c`` of a row's steps are the
  schedule the run recorded. A decode step's capacity holds the whole
  batch, so nothing is dropped there.

Everything the program derived from the weights (the expert placement,
the permuted pool, the router tables, the caches) is worked out again
here from the original weights and the tokens. ``precision="fp8"`` is the
control: the same pass with every projection's and expert's operands
rounded to float8 e4m3 (per row and per output column scales), the
router and the attention products left in float32.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

NEG = -1e30
F8_MAX = 448.0


@dataclasses.dataclass
class Served:
    """One finished request: its prompt, the tokens the decode steps took
    as input (the prefill's token, then each decoded token but the last),
    the position each decode step ran at, and the served tokens (the
    prefill's, then every decoded one)."""

    prompt: np.ndarray
    decode_inputs: np.ndarray
    decode_pos: np.ndarray
    served: np.ndarray


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Mm:
    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r} not in ('fp32', 'fp8')")
        self.fp8 = precision == "fp8"

    def w(self, w: torch.Tensor) -> torch.Tensor:
        """A (…, in, out) weight as the pass uses it."""
        w = w.float()
        return _q8(w, -2) if self.fp8 else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _q8(x, -1)
        return x @ w


def _norm(x, gain, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
        1.0 + gain.float())


def _rope(x, pos, theta):
    """x (T, n, hd) at positions pos (T,), halves rotated."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd)
    ang = torch.from_numpy(np.asarray(pos, np.float64)[:, None] * inv)
    c = torch.cos(ang).float().to(x.device)[:, None, :]
    s = torch.sin(ang).float().to(x.device)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def ring_sources(prompt_len: int, pos: np.ndarray, ring: int, window: int):
    """For each decode step of a row on the dense cache, the source of each
    entry it attends to: a token index (prompt ``0…P-1``, decode step j's
    input ``P + j``) or ``-1`` for a zero entry. Follows the ring the row
    owns: the prompt at ``[0, P)``, zeros after, and step j writing its
    token at ``c_j mod ring`` (``min(c_j, ring - 1)`` without a window)
    after it has attended."""
    panel = np.full(ring, -1, np.int64)
    panel[:prompt_len] = np.arange(prompt_len)
    idx = np.arange(ring)
    out = []
    for j, c in enumerate(np.asarray(pos, np.int64)):
        if window:
            wp = c % ring
            age = (wp - idx) % ring
            valid = (age >= 1) & (age <= min(c, window - 1))
        else:
            wp = min(c, ring - 1)
            valid = idx < c
        out.append(panel[valid].copy())
        panel[wp] = prompt_len + j
    return out


def _attend(q, keys, vals, mask, G):
    """q (Q, H, hd), keys/vals (Q, S, KV, hd), mask (Q, S) → (Q, H·hd)."""
    Q, H, hd = q.shape
    KV = keys.shape[2]
    qg = q.reshape(Q, KV, G, hd)
    s = torch.einsum("qkgd,qskd->qkgs", qg, keys) / math.sqrt(hd)
    s = s.masked_fill(~mask[:, None, None, :], NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("qkgs,qskd->qkgd", p, vals).reshape(Q, H * hd)


def _attention(q, k, v, seq: Served, m: dict, engine: dict, budget: int):
    """One sequence's attention output (T, H·hd), T = P + n."""
    P = len(seq.prompt)
    n = len(seq.decode_inputs)
    H, KV = m["num_heads"], m["num_kv_heads"]
    G = H // KV
    hd = q.shape[-1]
    window = m.get("sliding_window", 0)
    dev = q.device
    out = torch.empty((P + n, H * hd), dtype=torch.float32, device=dev)
    # the prompt: causal over itself (and the window)
    qc = max(1, budget // max(1, H * P * 4))
    kp = k[:P].repeat_interleave(G, dim=1)
    vp = v[:P].repeat_interleave(G, dim=1)
    pk = torch.arange(P, device=dev)
    for a in range(0, P, qc):
        b = min(P, a + qc)
        pq = torch.arange(a, b, device=dev)
        mask = pq[:, None] >= pk[None, :]
        if window:
            mask &= (pq[:, None] - pk[None, :]) < window
        s = torch.einsum("qhd,shd->hqs", q[a:b], kp) / math.sqrt(hd)
        s = s.masked_fill(~mask[None], NEG)
        out[a:b] = torch.einsum("hqs,shd->qhd", torch.softmax(s, -1),
                                vp).reshape(b - a, H * hd)
    if n == 0:
        return out
    # decode: each step's cache entries, then itself
    if engine["kv"] == "ring":
        srcs = ring_sources(P, seq.decode_pos, engine["ring"], window)
    else:
        srcs = [np.arange(P + j) for j in range(n)]
    zero = P + n
    kz = torch.cat([k, k.new_zeros((1, *k.shape[1:]))])
    vz = torch.cat([v, v.new_zeros((1, *v.shape[1:]))])
    longest = max(len(s) for s in srcs) + 1
    dc = max(1, budget // max(1, longest * KV * hd * 4 * 2))
    for a in range(0, n, dc):
        b = min(n, a + dc)
        idx = np.full((b - a, longest), zero, np.int64)
        mask = np.zeros((b - a, longest), bool)
        for i, j in enumerate(range(a, b)):
            s = srcs[j]
            idx[i, : len(s)] = np.where(s < 0, zero, s)
            mask[i, : len(s)] = True
            idx[i, len(s)] = P + j  # the token itself
            mask[i, len(s)] = True
        it = torch.from_numpy(idx).to(dev)
        mt = torch.from_numpy(mask).to(dev)
        out[P + a:P + b] = _attend(q[P + a:P + b], kz[it], vz[it], mt, G)
    return out


def _moe(x, lw, m: dict, groups, mm: _Mm):
    """x (T, D) normed tokens of every sequence; ``groups`` a list of
    (start, end, capacity or None) token ranges: a prompt's group drops
    past its capacity, a decode range drops nothing."""
    E, k, tp = m["num_experts"], m["experts_per_token"], m["expert_tp"]
    logits = x @ lw["router"]
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    ids = order[:, :k]
    gates = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True)
    keep = torch.ones_like(ids, dtype=torch.bool)
    for a, b, cap in groups:
        if cap is None:
            continue
        onehot = torch.zeros((b - a, E), dtype=torch.long, device=x.device)
        onehot.scatter_(1, ids[a:b], 1)
        rank = torch.cumsum(onehot, 0) - onehot  # earlier tokens per expert
        keep[a:b] = torch.gather(rank, 1, ids[a:b]) < cap
    y = torch.zeros_like(x)
    for e in range(E):
        sel = (ids == e) & keep
        rows = sel.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        g = (gates * sel).sum(-1)[rows]
        xe = x[rows]
        ye = torch.zeros_like(xe)
        for j in range(tp):
            v = e * tp + j
            h = torch.nn.functional.silu(mm(xe, lw["w_gate"][v])) * mm(
                xe, lw["w_up"][v])
            ye += mm(h, lw["w_down"][v])
        y.index_add_(0, rows, ye * g[:, None])
    return y


def served_logits(weights: dict, m: dict, engine: dict, seqs: list[Served],
                  *, precision: str = "fp32", budget: int = 1 << 29
                  ) -> list[torch.Tensor]:
    """For each sequence, the (n + 1, vocab_size) float32 logits from which
    its served tokens were chosen: the prompt's last position, then each
    decode step. ``engine``: ``kv`` ("paged" or "ring"), ``ring`` (the
    ring's entries), ``capacity_factor`` (the prefill's). ``budget`` bounds
    the bytes of one attention block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _served_logits(weights, m, engine, seqs, precision, budget)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _served_logits(weights, m, engine, seqs, precision, budget):
    mm = _Mm(precision)
    dev = weights["embed"].device
    D, L = m["d_model"], m["num_layers"]
    H, KV = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or D // H
    eps = m.get("norm_eps", 1e-6)
    theta = m.get("rope_theta", 10_000.0)
    E, k = m["num_experts"], m["experts_per_token"]
    cf = engine["capacity_factor"]
    ids, pos, groups, spans = [], [], [], []
    t = 0
    for s in seqs:
        P, n = len(s.prompt), len(s.decode_inputs)
        ids.append(np.concatenate([s.prompt, s.decode_inputs]))
        pos.append(np.concatenate([np.arange(P), s.decode_pos]))
        groups.append((t, t + P, max(int(math.ceil(P * k / E * cf)), 1)))
        if n:
            groups.append((t + P, t + P + n, None))
        spans.append((t, P, n))
        t += P + n
    tok = torch.from_numpy(np.concatenate(ids).astype(np.int64)).to(dev)
    x = weights["embed"][tok].float()
    blocks = weights["blocks"]
    for layer in range(L):
        aw = {n: mm.w(w[layer]) for n, w in blocks["attn"].items()}
        h = _norm(x, blocks["ln1"][layer], eps)
        q, kk, vv = (mm(h, aw[n]) for n in ("wq", "wk", "wv"))
        att = torch.empty((x.shape[0], H * hd), device=dev)
        for (a, P, n), s, p in zip(spans, seqs, pos):
            b = a + P + n
            qs = _rope(q[a:b].reshape(-1, H, hd), p, theta)
            ks = _rope(kk[a:b].reshape(-1, KV, hd), p, theta)
            att[a:b] = _attention(qs, ks, vv[a:b].reshape(-1, KV, hd), s,
                                  m, engine, budget)
        x = x + mm(att, aw["wo"])
        del aw, h, q, kk, vv, att
        mw = {n: (w[layer].float() if n == "router" else mm.w(w[layer]))
              for n, w in blocks["moe"].items()}
        x = x + _moe(_norm(x, blocks["ln2"][layer], eps), mw, m, groups, mm)
        del mw
    rows = torch.cat([torch.arange(a + P - 1, a + P + n, device=dev)
                      for a, P, n in spans])
    xf = _norm(x[rows], weights["final_norm"], eps)
    head = (weights["embed"].t() if m.get("tie_embeddings")
            else weights["lm_head"])
    logits = mm(xf, mm.w(head))[:, : m["vocab_size"]]
    out, i = [], 0
    for _, _, n in spans:
        out.append(logits[i:i + n + 1])
        i += n + 1
    return out


def gaps(ref: torch.Tensor, tokens) -> torch.Tensor:
    """How far each chosen token's logit lies below the reference's best at
    its position."""
    t = torch.as_tensor(np.asarray(tokens, np.int64), device=ref.device)
    return ref.max(dim=1).values - ref.gather(1, t[:, None])[:, 0]


def widest_gap(ref: torch.Tensor, tokens) -> float:
    """The widest of :func:`gaps`."""
    return float(gaps(ref, tokens).max())
