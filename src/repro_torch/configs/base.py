"""Architecture config (port of ``repro.configs.base``).

The same frozen dataclass with every field of the reference, so that
``cfg.replace(dtype=..., page_size=...)`` works as it does there; ``dtype``
is a ``torch.dtype``. Only the dense family runs in the port so far (the
model layers check the family they are handed).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)
    tie_embeddings: bool = False
    # ---- MoE ------------------------------------------------------------
    n_experts: int = 0
    n_experts_padded: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_period: int = 1
    capacity_factor: float = 1.25
    # ---- hybrid (attention + mamba) ---------------------------------------
    attn_period: int = 0
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    # ---- xlstm -----------------------------------------------------------
    slstm_period: int = 0
    # ---- encoder-decoder ---------------------------------------------------
    encdec: bool = False
    n_enc_layers: int = 0
    n_frames: int = 1500
    max_seq: int = 8192
    # ---- numerics ---------------------------------------------------------
    dtype: Any = torch.bfloat16
    remat: str = "block"
    unroll: bool = False
    causal_skip: bool = False
    ssm_bf16: bool = False
    # ---- serving ----------------------------------------------------------
    page_size: int = 64  # KV tokens per page (GPAC's base granule)

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"bad family {self.family}")
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.attn_period and self.n_layers % self.attn_period:
            raise ValueError("n_layers must divide into attn_period groups")
        if self.slstm_period and self.n_layers % self.slstm_period:
            raise ValueError("n_layers must divide into slstm_period groups")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def e_pad(self) -> int:
        """Expert-bank size after EP padding."""
        return self.n_experts_padded or self.n_experts

    @property
    def group_size(self) -> int:
        """Layers per stacked super-block."""
        if self.attn_period:
            return self.attn_period
        if self.slstm_period:
            return self.slstm_period
        if self.is_moe and self.moe_period > 1:
            return self.moe_period
        return 1

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.group_size

    def layer_kind(self, i: int) -> str:
        """Mixer kind of layer i: attn | mamba | mlstm | slstm."""
        if self.family == "ssm":
            return "slstm" if (self.slstm_period and i % self.slstm_period
                               == self.slstm_period - 1) else "mlstm"
        if self.attn_period:
            return "attn" if i % self.attn_period == 0 else "mamba"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        return self.is_moe and (i % self.moe_period == self.moe_period - 1)

    @property
    def attn_layers(self) -> list:
        return [i for i in range(self.n_layers) if self.layer_kind(i) == "attn"]

    @property
    def n_attn_layers(self) -> int:
        return len(self.attn_layers)

    def param_count(self) -> int:
        """Parameters of a dense attention stack (what the port builds)."""
        d, hd, H, KVH = self.d_model, self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KVH * hd + H * hd * d
        if self.qkv_bias:
            attn += (H + 2 * KVH) * hd
        gates = 1 if self.activation == "gelu" else 2
        norm = 2 * d if self.norm == "layernorm" else d
        layer = norm + attn + norm + (gates + 1) * d * self.d_ff
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return embed + self.n_layers * layer + norm

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
