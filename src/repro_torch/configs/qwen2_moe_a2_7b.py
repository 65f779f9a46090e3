"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) vocab=151936; 60 routed experts top-4 + 4 shared
experts, per-expert d_ff=1408. Experts are padded 60->64 at sharding time so
the expert axis splits over the 16-way model axis (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    n_experts=60,
    n_experts_padded=64,
    n_shared_experts=4,
    top_k=4,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="qwen2-moe-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=256, n_experts=6, n_experts_padded=8, n_shared_experts=2,
        top_k=2, head_dim=16, capacity_factor=8.0,
    )
