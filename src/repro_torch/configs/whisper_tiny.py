"""Whisper-tiny [arXiv:2212.04356; unverified].

Enc-dec: 4 encoder + 4 decoder layers, d_model=384 6H (kv=6) d_ff=1536
vocab=51865, LayerNorm, learned positions. The conv audio frontend is a STUB:
``input_specs`` provides precomputed (batch, 1500, d_model) frame embeddings.

NOTE: Whisper's native decoder context is 448 tokens; the assigned
prefill_32k/decode_32k shapes exceed it, so ``max_seq`` is a 40960-entry
learned-position capacity stand-in (the arch is exercised at the assigned
shapes as the pool requires; the context mismatch is a property of the
assignment, recorded in DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    activation="gelu",
    encdec=True,
    n_enc_layers=4,
    n_frames=1500,
    max_seq=40960,  # learned-position capacity covering the 32k cells
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="whisper-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, n_enc_layers=2, n_frames=16, max_seq=64, head_dim=16,
    )
