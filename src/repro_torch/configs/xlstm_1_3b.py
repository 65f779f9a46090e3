"""xLSTM-1.3B [arXiv:2405.04517; unverified].

48 blocks d_model=2048 4H vocab=50304; mLSTM:sLSTM 7:1 (every 8th block is
sLSTM), d_ff=0 (mixers carry their own up/down projections). Decode state is
constant-size matrix memory -- runs ``long_500k`` with no KV cache at all.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_period=8,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="xlstm-reduced", n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        vocab=256, slstm_period=2, head_dim=32,
    )
