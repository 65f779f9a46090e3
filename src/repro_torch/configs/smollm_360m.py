"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M] (llama-arch small).

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152. 15 heads do not divide
the 16-way model axis: attention projections replicate under TP, MLP + vocab
still shard (DESIGN.md §5 head-divisibility rule).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="smollm-reduced", n_layers=2, d_model=60, n_heads=3, n_kv_heads=1,
        d_ff=128, vocab=256, head_dim=16,
    )
