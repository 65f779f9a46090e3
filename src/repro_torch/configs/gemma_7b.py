"""Gemma-7B [arXiv:2403.08295].

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000; GeGLU activation,
head_dim=256 (> d_model/n_heads), tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256000,
    head_dim=256,
    activation="geglu",
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="gemma-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, head_dim=32,
    )
