"""Sharding policy: one object that owns every partition decision (port of
``repro/sharding/policy.py``).

* Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
  multi-pod (:mod:`repro_torch.launch.mesh`); ``pod`` folds into the batch
  axes.
* A spec is a plain tuple with one entry per dimension: an axis name, a
  tuple of axis names, or None (replicated), where JAX builds a
  ``PartitionSpec`` from the same entries. Every spec method returns what
  JAX's returns.
* What the port honours under a mesh (:func:`param_specs`): JAX's specs
  leaf for leaf, every family. Over ``model``: ``wq``/``wk``/``wv`` and
  the gated MLP's gate/up by their flat output dim (``w_col``), ``wo``
  and the MLP's down projection by their input dim (``w_row``), the
  q/k/v biases, the tied embedding by vocabulary, an untied one by
  ``d_model``, ``lm_head`` by vocabulary, the expert pool's slot dim
  (:func:`local_expert_slots`), and the SSD blocks by head
  (``repro/models/ssm.py:63-80``: ``wz``/``wx``/``wdt`` by their output
  dim, ``dt_bias``/``A_log``/``D``/``conv_x_b``/``gate_norm`` and
  ``conv_x_w``'s channels, ``out_proj`` by its input dim; the B/C
  projections and their convolutions whole). zamba2's shared block
  (leading dim 1) is laid out as the attention families' blocks are.
  Under ``fsdp`` (ZeRO-3) the same leaves are also stored over ``data``
  on their other dim (:func:`fsdp_dim`: the projections', the SSD
  projections' (``wb``/``wc`` too) and the experts' ``d_model``, the
  embedding's and the head's other dim); the model gathers one layer's
  block whole over ``data`` just before it uses it
  (:func:`~repro_torch.kernels.sharded.gather_fsdp`, whose adjoint
  reduce-scatters the gradient). The dense KV cache's sequence is stored
  over ``kv_seq`` (:func:`kv_shard`), the SSM state's heads and
  ``conv_x``'s channels over ``model``, and every cache's rows over the
  cache-batch axes (:func:`repro_torch.models.model.decode_cache_rows`);
  the batch and the MoE dispatch groups over the batch axes
  (:meth:`ShardingPolicy.moe_shard_spec`). One divergence: a pool the
  model axis does not divide is whole over ``model`` (JAX pads it
  through the dead-slot pad alike; its ``data`` entry is honoured).
* PyTorch runs eagerly: there is no compiler to hand a layout to, so
  :meth:`ShardingPolicy.constrain` and the ``act_*``/``kv_cache`` helpers
  return their input. The model moves data between ranks itself, through
  the collectives of :mod:`repro_torch.kernels.sharded`.

The policy is mesh-optional: with ``mesh=None`` there is one rank and the
same model code runs on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ShardingPolicy", "fsdp_dim", "fsdp_gather_axis",
           "host_policy", "kv_shard", "local_expert_slots", "model_axis",
           "model_dim", "param_specs", "shard_range", "spec_axes",
           "take_shard"]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any = None  # repro_torch.launch.mesh.Mesh, or anything with
    # ``shape`` and ``axis_names`` for the spec methods alone
    batch_axes: tuple[str, ...] = ("data",)  # ("pod","data") on multi-pod;
    # () when global_batch < data-axis size (long-context decode)
    model_axis: str = "model"
    kv_seq_axes: tuple[str, ...] = ("model",)
    fsdp: bool = False  # also shard params over the data axis (training)
    # None → same as batch_axes
    cache_batch_axes: tuple[str, ...] | None = None

    # ---- spec construction -------------------------------------------------
    @property
    def batch(self):
        if not self.batch_axes:
            return None
        return self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]

    @property
    def cache_batch(self):
        axes = self.cache_batch_axes
        if axes is None:
            return self.batch
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    @property
    def kv_seq(self):
        if len(self.kv_seq_axes) == 1:
            return self.kv_seq_axes[0]
        return self.kv_seq_axes

    @property
    def data_axis_size(self) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for a in self.batch_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def all_data_axes(self) -> tuple[str, ...]:
        """Every non-model axis of the mesh (for full-fleet seq sharding)."""
        if self.mesh is None:
            return ()
        return tuple(a for a in self.mesh.axis_names if a != self.model_axis)

    @property
    def model_axis_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape[self.model_axis]

    def spec(self, *parts) -> tuple:
        return tuple(parts)

    def named(self, *parts) -> tuple | None:
        """The spec of ``parts`` when a mesh is present, None otherwise
        (JAX's ``NamedSharding``, whose mesh is the policy's)."""
        if self.mesh is None:
            return None
        return tuple(parts)

    # ---- per-shard kernel dispatch -----------------------------------------
    def moe_shard_spec(self, Gd: int, Ev: int) -> tuple:
        """(data_spec, expert_spec) for the per-rank MoE kernels.

        ``data_spec`` shards the leading dispatch-group dim of the
        (Gd, E_v, C, D) expert buffers / (Gd, Ng, E) router logits over the
        batch axes — ``None`` (replicate) when the batch collapsed to a
        single group (B didn't divide the data extent) or there are no batch
        axes (replicated-activation decode). ``expert_spec`` shards E_v over
        the model axis — ``None`` when E_v doesn't divide the model extent.
        """
        if self.mesh is None:
            return None, None
        data_spec = (
            self.batch if (Gd > 1 and Gd == self.data_axis_size) else None
        )
        expert_spec = (
            self.model_axis if Ev % self.model_axis_size == 0 else None
        )
        return data_spec, expert_spec

    def expert_collective_axis(self, num_slots: int) -> str | None:
        """Mesh axis for collective expert-row migration, or ``None``.

        Collectives apply exactly when the slot dim of the stacked expert
        weights is sharded: a real mesh, a model axis wider than one rank,
        and a slot count the axis divides."""
        if self.mesh is None or self.model_axis_size <= 1:
            return None
        if num_slots % self.model_axis_size != 0:
            return None
        return self.model_axis

    def moe_expert_pad(self, Ev: int) -> tuple[int, Any]:
        """(padded E_v, expert spec) for the per-rank kernels when ``Ev``
        doesn't divide the model-axis extent: dead slots — zero weight rows
        and zero buffers whose FFN output is exactly zero and is sliced back
        off — pad the expert dim to the next multiple of the axis. Returns
        ``(Ev, None)`` with no mesh or a 1-wide model axis."""
        if self.mesh is None or self.model_axis_size <= 1:
            return Ev, None
        pad = (-Ev) % self.model_axis_size
        return Ev + pad, self.model_axis

    # ---- activation constraints: the identity in eager PyTorch -------------
    def constrain(self, x, *parts):
        """The identity: JAX's ``with_sharding_constraint`` hints a layout
        to its compiler, and eager PyTorch has none to hint."""
        del parts
        return x

    def act_bsd(self, x):
        """(B, S, D): batch over data, replicated over model (identity)."""
        return self.constrain(x, self.batch, None, None)

    def act_seq_sharded(self, x):
        """(B, S, D): sequence over model in JAX (identity here)."""
        return self.constrain(x, self.batch, self.model_axis, None)

    def act_ff_sharded(self, x):
        """(B, S, F): TP intermediate in JAX (identity here)."""
        return self.constrain(x, self.batch, None, self.model_axis)

    def act_vocab_sharded(self, x):
        """(B, S, V): logits, vocab over model in JAX (identity here)."""
        return self.constrain(x, self.batch, None, self.model_axis)

    def kv_cache(self, x):
        """(L, B, S, KV, hd): KV sequence over kv_seq in JAX (identity
        here)."""
        return self.constrain(x, None, self.cache_batch, self.kv_seq, None, None)

    # ---- parameter specs ---------------------------------------------------
    def _fsdp_axis(self):
        return "data" if (self.fsdp and self.mesh is not None) else None

    def w_col(self, stacked: bool = True) -> tuple:
        """(…, D, F): input dim optionally FSDP-sharded, output dim over model."""
        core = (self._fsdp_axis(), self.model_axis)
        return ((None,) if stacked else ()) + core

    def w_row(self, stacked: bool = True) -> tuple:
        """(…, F, D): input dim over model, output dim optionally FSDP."""
        core = (self.model_axis, self._fsdp_axis())
        return ((None,) if stacked else ()) + core

    def w_expert(self, ndim_tail: int = 2, stacked: bool = True) -> tuple:
        """(…, E_virtual, D, F) / (…, E_virtual, F, D): experts over model."""
        core = (self.model_axis,) + (self._fsdp_axis(),) + (None,) * (ndim_tail - 1)
        return ((None,) if stacked else ()) + core

    def w_replicated(self, ndim: int) -> tuple:
        return (None,) * ndim

    def w_vector(self, stacked: bool = True) -> tuple:
        """(…, D) biases/norm scales: replicated."""
        return ((None,) if stacked else ()) + (None,)

    def embed_tied(self) -> tuple:
        """Tied embedding doubles as lm_head: shard vocab over model."""
        return (self.model_axis, self._fsdp_axis())

    def embed_untied(self) -> tuple:
        """Lookup-only table: shard d_model over model."""
        return (self._fsdp_axis(), self.model_axis)

    def lm_head(self) -> tuple:
        return (self._fsdp_axis(), self.model_axis)


def host_policy() -> ShardingPolicy:
    """Policy for one device: every constraint a no-op."""
    return ShardingPolicy(mesh=None)


EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def is_expert_leaf(path) -> bool:
    """Whether a parameter path (its keys, outermost first) names a
    stacked expert weight ``(L, S, …)`` under ``blocks/moe``: the leaves
    whose slot dim a model axis shards, or which it stores whole on every
    rank when it does not divide the pool."""
    return (len(path) >= 2 and path[-2] == "moe"
            and path[-1] in EXPERT_WEIGHTS)


def local_expert_slots(policy: ShardingPolicy | None,
                       num_slots: int) -> slice | None:
    """The slots ``[d·S/m, (d+1)·S/m)`` this rank holds of an S-slot
    expert pool, d being its model-axis position, or None when the pool is
    not sharded (no mesh, a 1-wide model axis, or S indivisible by it:
    every rank then holds all S slots, as JAX replicates them)."""
    if policy is None or policy.expert_collective_axis(num_slots) is None:
        return None
    per = num_slots // policy.model_axis_size
    d = policy.mesh.index(policy.model_axis)
    return slice(d * per, (d + 1) * per)


def model_axis(policy: ShardingPolicy | None) -> str | None:
    """The model axis when ``policy`` has a mesh whose model axis is wider
    than one rank (the projections, the SSD heads and the vocabulary are
    then stored sharded over it), else None."""
    if policy is None or policy.mesh is None or policy.model_axis_size <= 1:
        return None
    return policy.model_axis


def shard_range(size: int, axes, mesh, *, leaf: str = "tensor",
                dim: int = 0) -> slice:
    """This rank's block ``[i·size/n, (i+1)·size/n)`` of a dim of ``size``
    sharded over ``axes`` (a name or a tuple of names) of extent n, i its
    position along them. Raises ``ValueError``, naming ``leaf`` and the
    dim, when n does not divide ``size``: no dim is silently replicated."""
    n = mesh.size(axes)
    if size % n:
        raise ValueError(
            f"{leaf}: dim {dim} of size {size} does not shard over {axes!r} "
            f"({n} ranks)")
    per = size // n
    lo = mesh.index(axes) * per
    return slice(lo, lo + per)


def take_shard(arr, spec, mesh, *, leaf: str = "tensor"):
    """This rank's shard of a whole tensor or numpy array by its spec (one
    entry a dim; None keeps the dim whole)."""
    for dim, axes in enumerate(spec or ()):
        if axes is None:
            continue
        rows = shard_range(arr.shape[dim], axes, mesh, leaf=leaf, dim=dim)
        index = (slice(None),) * dim + (rows,)
        arr = arr[index]
    return arr


def kv_shard(policy: ShardingPolicy | None) -> tuple | None:
    """The axes over which the dense KV cache's sequence is sharded
    (``policy.kv_seq_axes``), or None where each rank holds it whole: no
    mesh, or an extent of 1."""
    if policy is None or policy.mesh is None:
        return None
    axes = tuple(policy.kv_seq_axes)
    if policy.mesh.size(axes) <= 1:
        return None
    return axes


def fsdp_gather_axis(policy: ShardingPolicy | None) -> str | None:
    """``"data"`` when ``policy`` stores a model's leaves over the data
    axis (ZeRO-3: ``fsdp`` on a mesh whose data axis is
    wider than one rank), else None: the axis over which the model
    gathers a layer's blocks before it uses them."""
    if policy is None or policy._fsdp_axis() is None:
        return None
    return "data" if policy.mesh.size("data") > 1 else None


# a leaf's spec by its key path: JAX's ``init_attention``/
# ``init_gated_mlp``/``init_moe``/``init_ssm``/``init_params`` specs, ``f``
# the FSDP axis (None without FSDP)
_COL = ("wq", "wk", "wv", "w_gate", "w_up")
_BIAS = ("bq", "bk", "bv")
# the SSD block's leaves (``repro/models/ssm.py:63-80``): by head over
# ``model``, or whole over it (the B/C projections and convolutions,
# shared by every head)
_SSM_COL = ("wz", "wx", "wdt")
_SSM_HEAD = ("dt_bias", "A_log", "D", "conv_x_b", "gate_norm")


def _leaf_spec(path, ndim: int, m: str, *, tied: bool, pool_divides: bool,
               f: str | None = None):
    none = (None,) * ndim
    name = path[-1]
    if path == ("embed",):
        return (m, f) if tied else (f, m)
    if path == ("lm_head",):
        return (f, m)
    if is_expert_leaf(path):
        e = m if pool_divides else None
        return (None, e, None, f) if name == "w_down" else (None, e, f, None)
    parent = path[-2] if len(path) >= 2 else None
    if parent in ("attn", "mlp"):
        if name in _COL:
            return (None, f, m)
        if name in ("wo", "w_down"):
            return (None, m, f)
        if name in _BIAS:
            return (None, m)
    if parent == "ssm":
        if name in _SSM_COL:
            return (None, f, m)
        if name in ("wb", "wc"):
            return (None, f, None)
        if name in _SSM_HEAD:
            return (None, m)
        if name == "conv_x_w":
            return (None, None, m)
        if name == "out_proj":
            return (None, m, f)
    return none



def model_dim(path, ndim: int, *, tied: bool) -> int | None:
    """The dim of a leaf (by its key path) that JAX's specs shard over the
    model axis, or None for a leaf they keep whole: whatever the mesh,
    the pool's divisibility or the family."""
    spec = _leaf_spec(path, ndim, "model", tied=tied, pool_divides=True)
    return spec.index("model") if "model" in spec else None


def fsdp_dim(path, ndim: int, *, tied: bool) -> int | None:
    """The dim of a leaf (by its key path; ``ndim`` its stacked rank)
    that JAX's FSDP specs shard over ``data``, or None for a leaf FSDP
    keeps whole (the norm scales, the biases, the router)."""
    spec = _leaf_spec(path, ndim, "model", tied=tied, pool_divides=True,
                      f="data")
    return spec.index("data") if "data" in spec else None


def param_specs(params, policy: ShardingPolicy | None, config, *,
                num_slots: int | None = None):
    """The spec of every leaf of ``config``'s parameter tree under
    ``policy``, mirroring the tree: JAX's ``init_params`` specs, a tuple
    with one entry a dim (an axis name, or None for a whole dim), with
    FSDP's ``data`` entries where ``policy.fsdp`` is set. Without a mesh
    every leaf is None (whole).

    One divergence from JAX's specs: a pool the model axis does not
    divide (:func:`local_expert_slots`) is whole over ``model`` (its
    ``data`` entry stays). ``params`` may hold tensors or numpy arrays of
    the full shapes, or a rank's own tensors with ``num_slots``, the
    pool's global slot count (a rank's rows of a sharded pool cannot be
    told from a whole pool by their count)."""
    if policy is None or policy.mesh is None:
        def nothing(tree):
            if isinstance(tree, dict):
                return {k: nothing(v) for k, v in tree.items()}
            return None
        return nothing(params)
    m, f = policy.model_axis, policy._fsdp_axis()

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if tree is None:
            return None
        divides = False
        if is_expert_leaf(path):
            S = int(tree.shape[1]) if num_slots is None else num_slots
            divides = S % policy.model_axis_size == 0
        return _leaf_spec(path, len(tree.shape), m,
                          tied=config.tie_embeddings, pool_divides=divides,
                          f=f)

    return walk(params, ())


def spec_axes(spec) -> tuple[str, ...]:
    """Every mesh axis a spec names, in its order (``()`` for None: a
    whole leaf)."""
    axes = []
    for entry in spec or ():
        if entry is None:
            continue
        axes.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(axes)
