"""Model configuration schema (the port's own copy).

Field for field the same as the JAX package's ``ModelConfig`` except the
Pallas tile sizes, which are TPU-only (the Hopper kernels choose their own
tiles from the shapes they are given).

``moe_backend`` takes the JAX package's three names
(:data:`MOE_BACKENDS`). ``"einsum"`` and ``"pallas"`` name the same plane
here, the staged dispatch (route → build_dispatch → expert_compute →
combine), whose kernels the tensor's device picks: the Hopper kernels on
CUDA, their plain PyTorch versions on the CPU
(:mod:`repro_torch.kernels.ops`). Neither name routes a CUDA tensor onto
a plain version. ``"dense_ref"`` names the capacity-free oracle: every
expert runs on every token, so nothing is dropped
(:func:`repro_torch.models.dispatch.dense_mix`).
:class:`ShapeSpec`, :data:`SHAPES` and :func:`shape_applicable` are the JAX
package's dry-run shape table, copied as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = [
    "ModelConfig", "ShapeSpec", "SHAPES", "shape_applicable", "MOE_BACKENDS",
]

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]

MOE_BACKENDS = ("einsum", "pallas", "dense_ref")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads
    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0  # 0 → full attention
    rope_theta: float = 10_000.0
    # --- MLP ---
    mlp_activation: str = "swiglu"  # swiglu | geglu
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    expert_d_ff: int = 0  # per-expert hidden size (granite: 512)
    expert_tp: int = 1  # virtual-expert factorization degree (models/moe.py)
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    decode_capacity_factor: float = 2.0
    # --- MoE data plane: "einsum" and "pallas" the staged plane (the
    # device picks its kernels), "dense_ref" the capacity-free oracle ---
    moe_backend: str = "einsum"
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # --- hybrid (zamba2-style) ---
    attn_every: int = 0
    # --- modality frontend stub ---
    frontend: str = ""
    num_patches: int = 0
    # --- numerics ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    decode_cache_update: str = "dus"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.moe_backend not in MOE_BACKENDS:
            raise ValueError(
                f"moe_backend={self.moe_backend!r} not in {MOE_BACKENDS}"
            )

    # -- derived quantities --------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 128 (padded logits are masked)."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and self.attn_every == 0

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.attn_every > 0

    @property
    def has_attention(self) -> bool:
        return not self.is_ssm

    @property
    def sub_quadratic(self) -> bool:
        """SSM, hybrid or sliding-window attention."""
        return self.ssm_state > 0 or self.sliding_window > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def num_virtual_experts(self) -> int:
        """E_v = num_experts · expert_tp: the stacked expert rows per layer."""
        return self.num_experts * self.expert_tp

    @property
    def ffn_hidden(self) -> int:
        return self.expert_d_ff if self.is_moe else self.d_ff

    def param_count(self) -> int:
        """Approximate total parameter count, the JAX package's formula."""
        D, V = self.d_model, self.vocab_size
        total = V * D if self.tie_embeddings else 2 * V * D
        if self.ssm_state > 0:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            # in_proj (z, x, B, C, dt) + out_proj + conv + head params
            per_layer_ssm = (D * (2 * di + 2 * ns + nh) + di * D
                             + self.ssm_conv * (di + 2 * ns) + 2 * nh)
        if self.is_ssm:
            return total + self.num_layers * (per_layer_ssm + D)
        hd, H, KV = self.head_dim, self.num_heads, self.num_kv_heads
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.is_moe:
            ffn = self.num_experts * (3 * D * self.expert_d_ff) + D * self.num_experts
        else:
            ffn = 3 * D * self.d_ff
        if self.is_hybrid:
            # ssm blocks every layer + one shared attention+MLP block
            return (total + self.num_layers * (per_layer_ssm + D)
                    + attn + 3 * D * self.d_ff + 2 * D)
        return total + self.num_layers * (attn + ffn + 2 * D)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        D = self.d_model
        dense = self.param_count() - self.num_layers * self.num_experts * (
            3 * D * self.expert_d_ff
        )
        return dense + self.num_layers * self.experts_per_token * (
            3 * D * self.expert_d_ff
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(config: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch × shape) cell runs, per the assignment rules."""
    if shape.name == "long_500k" and not config.sub_quadratic:
        return False, "skipped(full-attn): 500k decode needs sub-quadratic attention"
    return True, ""
