"""Kimi K2 1T-A32B [arXiv:2501.kimi2; unverified, paper-table config].

61L d_model=7168 64H (GQA kv=8) vocab=163840; MoE with 384 routed experts
top-8 + 1 shared expert, per-expert d_ff=2048. ~1.0T total params, ~32B
active -- the trillion-parameter MoE stress cell of the assignment.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="kimi-k2-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=256, n_experts=8, n_shared_experts=1, top_k=2, head_dim=16,
        capacity_factor=8.0,
    )
