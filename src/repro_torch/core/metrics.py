"""Measurement layer: near-memory usage, hit rates and the calibrated
latency/throughput model (port of ``repro.core.metrics``).

Latency constants (ns per cacheline access) are relative inputs to the
throughput model, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import GpacConfig, TieredState, allocated_hp_mask

TIER_LATENCY_NS = {
    "hbm": 45.0,
    "dram": 90.0,
    "cxl": 220.0,
    "nvmm": 350.0,
}
# paper tier pairs: (near, far)
TIER_PAIRS = {
    "dram_nvmm": ("dram", "nvmm"),
    "dram_cxl": ("dram", "cxl"),
    "hbm_dram": ("hbm", "dram"),
}

# one calibration for every figure (see repro.core.metrics.modeled_throughput)
COMPUTE_NS_PER_OP = 700.0
MEM_ACCESSES_PER_OP = 1.0

# snapshot keys that are float-valued; everything else is an int counter
FLOAT_METRICS = ("near_usage", "near_capacity_used", "hit_rate")


def _ratio(num: torch.Tensor, den) -> torch.Tensor:
    """float32 num / den as jnp's int true-divide rounds it. The divisor is
    a tensor on num's device: a Python-scalar divisor may become a multiply
    by its reciprocal."""
    den = torch.as_tensor(den, device=num.device)
    return num.to(torch.float32) / den.to(torch.float32)


def near_usage(cfg: GpacConfig, state: TieredState) -> torch.Tensor:
    """Fraction of the resident set currently placed in near memory."""
    alloc = allocated_hp_mask(cfg, state)
    in_near = state.block_table < cfg.n_near
    return _ratio((alloc & in_near).sum(), alloc.sum().clamp(min=1))


def near_capacity_used(cfg: GpacConfig, state: TieredState) -> torch.Tensor:
    """Fraction of near-tier capacity occupied by resident data."""
    alloc = allocated_hp_mask(cfg, state)
    in_near = state.block_table < cfg.n_near
    return _ratio((alloc & in_near).sum(), cfg.n_near)


def hit_rate(state: TieredState) -> torch.Tensor:
    h = state.stats["near_hits"]
    f = state.stats["far_hits"]
    return _ratio(h, (h + f).clamp(min=1))


def throughput_from_hits(
    nh: np.ndarray, fh: np.ndarray, tier_pair: str = "dram_nvmm"
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side per-window hit-rate and modeled-throughput series from
    near/far hit counts."""
    near_ns, far_ns = (TIER_LATENCY_NS[t] for t in TIER_PAIRS[tier_pair])
    tot = np.maximum(nh + fh, 1)
    amat = (nh * near_ns + fh * far_ns) / tot
    return nh / tot, 1e9 / (COMPUTE_NS_PER_OP + MEM_ACCESSES_PER_OP * amat)


def device_snapshot(cfg: GpacConfig, state: TieredState) -> dict:
    """A dict of 0-d device tensors: epoch, near usage, hit rate and every
    running stats counter (the engine stacks these per window)."""
    return dict(
        epoch=state.epoch,
        near_usage=near_usage(cfg, state),
        near_capacity_used=near_capacity_used(cfg, state),
        hit_rate=hit_rate(state),
        **state.stats,
    )


def snapshot(cfg: GpacConfig, state: TieredState) -> dict:
    """Device->host pull of the metrics a benchmark window records."""
    d = device_snapshot(cfg, state)
    return {k: (float(v) if k in FLOAT_METRICS else int(v)) for k, v in d.items()}
