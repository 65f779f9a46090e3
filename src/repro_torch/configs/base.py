"""Architecture config (port of ``repro.configs.base``).

The same frozen dataclass with every field of the reference, so that
``cfg.replace(dtype=..., page_size=...)`` works as it does there; ``dtype``
is a ``torch.dtype``. ``param_count`` is exact for every family against the
model's init (tested against the reference's count).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

# the assigned input shapes: seq_len x global_batch
SHAPE_SPECS = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


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

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM/hybrid families; see DESIGN.md §6)."""
        return self.family in ("ssm", "hybrid")

    def shapes(self) -> list:
        """Assigned shape cells for this arch (long_500k only if subquadratic)."""
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.subquadratic:
            out.append("long_500k")
        return out

    def param_count(self) -> int:
        """Analytical parameter count, exact against the model's init
        (tested)."""
        d, hd = self.d_model, self.hd
        H, KVH = self.n_heads, self.n_kv_heads
        gates = 1 if self.activation == "gelu" else 2
        norm = 2 * d if self.norm == "layernorm" else d

        def attn_p():
            p = d * H * hd + 2 * d * KVH * hd + H * hd * d
            if self.qkv_bias:
                p += (H + 2 * KVH) * hd
            return p

        def mamba_p():
            di = self.ssm_expand * d
            dr = -(-d // 16)  # dt_rank
            p = d * 2 * di  # in_proj
            p += self.ssm_conv * di + di  # conv_w, conv_b
            p += di * (dr + 2 * self.ssm_state)  # x_proj
            p += dr * di + di  # dt_proj, dt_bias
            p += di * self.ssm_state + di  # A_log, D
            p += di * d  # out_proj
            return p

        def mlstm_p():
            di = 2 * d  # q/k/v block-diagonal per head: 3 * di^2 / H
            return (d * 2 * di + 3 * di * di // H + di * 2 * H + 2 * H + di * d)

        def slstm_p():
            di = 2 * d  # gates block-diagonal per head: 4 * di^2 / H
            return d * 2 * di + 4 * di * di // H + 4 * di + 4 * di + di * d

        def mlp_p(ff):
            return (gates + 1) * d * ff

        def moe_p():
            p = d * self.e_pad  # router
            p += self.e_pad * 3 * d * self.d_ff  # expert banks (swiglu)
            if self.n_shared_experts:
                p += 3 * d * self.d_ff * self.n_shared_experts
            return p

        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.encdec:
            total += self.max_seq * d + self.n_frames * d  # learned positions
        mixer = dict(attn=attn_p, mamba=mamba_p, mlstm=mlstm_p, slstm=slstm_p)
        for i in range(self.n_layers):
            total += norm + mixer[self.layer_kind(i)]()
            if self.layer_is_moe(i):
                total += norm + moe_p()
            elif self.d_ff:
                total += norm + mlp_p(self.d_ff)
            if self.encdec:  # cross attention + its norm
                total += norm + attn_p()
        total += norm  # final norm
        if self.encdec:
            for _ in range(self.n_enc_layers):
                total += 2 * norm + attn_p() + mlp_p(self.d_ff)
            total += norm  # encoder final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared instead of all)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        n_moe_layers = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        all_e = n_moe_layers * self.e_pad * 3 * d * self.d_ff
        act_e = n_moe_layers * self.top_k * 3 * d * self.d_ff
        return full - all_e + act_e

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
