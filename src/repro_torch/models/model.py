"""Model assembly for the MoE family: embed → layers → norm → logits.

Port of the MoE path of ``repro/models/model.py``. Parameters are a plain
dict in the JAX pytree's layout, per-layer weights stacked on a leading L
dim::

    {"embed": (V_pad, D), "final_norm": (D,),
     "blocks": {"ln1": (L, D), "ln2": (L, D),
                "attn": {"wq", "wk", "wv", "wo"},
                "moe": {"router", "w_gate", "w_up", "w_down"}}}

(plus ``"lm_head"`` (D, V_pad) for untied configs). The layer stack is a
Python loop over layers, the JAX package's ``"python"`` mode;
:class:`DecodeGraph` is its ``"scan"`` mode: the same decode step over
static buffers, captured once as a CUDA graph and replayed every step.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import launches
from .attention import attention_decode_paged, attention_train, init_attention
from .layers import embed_tokens, lm_logits, rms_norm
from .moe import MoEAux, identity_placement, init_moe, moe_layer

__all__ = [
    "init_params",
    "prefill",
    "init_paged_decode_cache",
    "decode_step",
    "DecodeGraph",
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

    ``placements``: (L, E_v) expert→slot tables or (L, E_v, P) replica-split
    tables (the prefill never runs the shed pass).
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
                placements=None, *, block_tables, shed_enables=None):
    """One serving step on the paged cache: tokens (B, 1) int32,
    ``cur_len`` (B,) int32, ``block_tables`` (B, n_max) int32.
    ``placements``: (L, E_v) or (L, E_v, P) tables; ``shed_enables``: (L,)
    0/1 int32 per-layer switches of the shed pass, or None to leave the
    pass out of the step.

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
            shed_enable=None if shed_enables is None else shed_enables[i],
        )
        auxes.append(aux)
        x = x + y
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = lm_logits(x, params, config)
    return logits[:, 0], caches, _stack_aux(auxes)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class DecodeGraph:
    """The port's counterpart of ``decode_mode="scan"``: the whole
    :func:`decode_step` over static buffers, captured once as a CUDA graph
    and replayed every step.

    The JAX package lowers the decode step to one executable whose
    placements, block tables and lengths are operands. Here everything the
    step reads stays at one address for the life of the graph: the step's
    host inputs are copied into :attr:`tokens` (B, 1), :attr:`cur_len`
    (B,) and :attr:`block_tables` (B, n_max), views of one int32 device
    buffer filled by one copy a step; the weights, the paged KV pools and
    the (L, E_v) expert→slot tables (or (L, E_v, P) replica-split tables)
    are the caller's tensors, which the caller updates in place (``copy_``)
    and never rebinds. With ``shed=True`` the same buffer also holds
    :attr:`shed_enables` (L,), the per-layer switches of the shed pass,
    copied in with the other inputs each step; with ``shed=False`` the
    captured step holds no shed operation at all.

    Binding happens at construction, with the static inputs at zero (every
    row idle: it reads and writes only the null KV block). On a CUDA device
    it runs the body once on a side stream, which loads the kernels'
    libraries, sets up cuBLAS there and makes K2's arrival counter for that
    stream, runs it again under ``torch.cuda.set_sync_debug_mode("error")``
    so that a host sync fails before the capture, then captures one body
    with ``torch.cuda.CUDAGraph`` on the same stream. Each call replays the
    graph and adds the kernel launches the capture recorded to
    :mod:`repro_torch.kernels.launches`. A capture or replay error raises:
    there is no eager fallback on the card. On the CPU there is nothing to
    capture, and each call runs the same body eagerly.

    :attr:`builds` counts bindings (captures on the card). A call whose
    weights, pools or tables are other tensors than the bound ones binds
    again and counts it, so a graph never reads stale pointers.
    :attr:`pool_bytes` is the device memory the capture reserved for its
    private pool (the step's intermediates and outputs).
    """

    def __init__(self, params, caches, placements, config: ModelConfig, *,
                 batch: int, n_max: int, device, shed: bool = False):
        _check_family(config)
        self.config = config
        self.device = torch.device(device)
        self.batch, self.n_max = batch, n_max
        cuda = self.device.type == "cuda"
        rows = batch * (2 + n_max)
        words = rows + (config.num_layers if shed else 0)
        self._host = torch.zeros(words, dtype=torch.int32, pin_memory=cuda)
        self._host_np = self._host.numpy()
        self._inputs = torch.zeros(words, dtype=torch.int32, device=self.device)
        self.tokens = self._inputs[:batch].view(batch, 1)
        self.cur_len = self._inputs[batch:2 * batch]
        self.block_tables = self._inputs[2 * batch:rows].view(batch, n_max)
        self.shed_enables = self._inputs[rows:] if shed else None
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
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._body()  # set-up: libraries, cuBLAS, K2's counter, RoPE
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._body()  # what the graph holds may not sync
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize(dev)
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
        if self._staged is not None:
            self._staged.synchronize()  # the last step's copy has left it
        B, h = self.batch, self._host_np
        rows = B * (2 + self.n_max)
        h[:B] = np.asarray(tokens).reshape(B)
        h[B:2 * B] = np.asarray(cur_len).reshape(B)
        h[2 * B:rows] = np.asarray(block_tables).reshape(-1)
        if shed_enables is not None:
            h[rows:] = np.asarray(shed_enables).reshape(-1)
        self._inputs.copy_(self._host, non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def __call__(self, params, caches, cur_len, tokens, config: ModelConfig,
                 placements, *, block_tables, shed_enables=None):
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
