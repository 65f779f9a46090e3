"""Qwen2-VL-2B backbone [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. M-RoPE (3-section
t/h/w rotary over head_dim=128), QKV bias (Qwen2 style). The vision frontend
is a STUB: ``input_specs`` provides token ids plus 3D position ids as the
dynamic-resolution patch layout would produce them.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),  # head_dim/2 = 64 = 16+24+24
    rope_theta=1_000_000.0,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="qwen2-vl-2b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        mrope_sections=(2, 3, 3),
    )
