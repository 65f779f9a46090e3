"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; hybrid Mamba:attn 7:1
interleave (attention every 8th layer), MoE 16 experts top-2 on every other
layer. Runs ``long_500k`` (sub-quadratic: decode state is SSM + 9 attention
layers' paged KV).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_period=2,
    attn_period=8,
    ssm_state=16,
    ssm_expand=2,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="jamba-reduced", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, n_experts=4, top_k=2, moe_period=2, attn_period=4,
        ssm_state=4, head_dim=16, capacity_factor=8.0,
    )
