"""Measurement layer: near-memory usage, hit rates, skew CDFs and the
calibrated latency/throughput model (port of ``repro.core.metrics``).

Latency constants (ns per cacheline access) are relative inputs to the
throughput model, as in the reference. Float results are float32 computed
in the reference's order of operations, each divide a true division as
eager JAX does it; :func:`near_capacity_used` can instead round as the
reference's jitted engine does (``jit_rounding``).
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


def near_capacity_used(
    cfg: GpacConfig, state: TieredState, jit_rounding: bool = False,
) -> torch.Tensor:
    """Fraction of near-tier capacity occupied by resident data.

    ``jit_rounding`` rounds as the reference's engine collector does: under
    ``jax.jit`` XLA turns the divide by the constant ``n_near`` into a
    multiply by float32(1 / n_near), which can differ from the true quotient
    in the last bit when ``n_near`` is not a power of two. The reciprocal is
    a float32 quotient, passed as a Python float that holds it exactly."""
    alloc = allocated_hp_mask(cfg, state)
    in_near = state.block_table < cfg.n_near
    used = (alloc & in_near).sum()
    if jit_rounding:
        return used.to(torch.float32) * float(np.float32(1) / np.float32(cfg.n_near))
    return _ratio(used, cfg.n_near)


def hit_rate(state: TieredState) -> torch.Tensor:
    h = state.stats["near_hits"]
    f = state.stats["far_hits"]
    return _ratio(h, (h + f).clamp(min=1))


def skew_cdf(per_hp_accessed: np.ndarray, hp_ratio: int) -> np.ndarray:
    """CDF over huge pages of #accessed subpages (paper Fig. 2). Only counts
    huge pages with at least one accessed subpage."""
    counts = per_hp_accessed[per_hp_accessed > 0]
    if counts.size == 0:
        return np.zeros(hp_ratio + 1)
    hist = np.bincount(counts, minlength=hp_ratio + 1)
    return np.cumsum(hist) / counts.size


def skewed_hot_fraction(per_hp_hot: np.ndarray, cl: int) -> float:
    """Fraction of hot huge pages that are skewed (< cl hot subpages)."""
    hot = per_hp_hot[per_hp_hot > 0]
    if hot.size == 0:
        return 0.0
    return float((hot < cl).sum() / hot.size)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def modeled_access_time_ns(state: TieredState, tier_pair: str = "dram_nvmm") -> torch.Tensor:
    """float32 average memory access time under the tier pair's latencies,
    weighted by the running near/far hits."""
    near_t, far_t = (TIER_LATENCY_NS[t] for t in TIER_PAIRS[tier_pair])
    h = state.stats["near_hits"].to(torch.float32)
    f = state.stats["far_hits"].to(torch.float32)
    return (h * near_t + f * far_t) / (h + f).clamp(min=1)


def modeled_throughput(
    state: TieredState,
    tier_pair: str = "dram_nvmm",
    compute_ns_per_op: float = COMPUTE_NS_PER_OP,
    mem_accesses_per_op: float = MEM_ACCESSES_PER_OP,
    migration_ns: float = 0.0,
) -> torch.Tensor:
    """float32 ops/s under the reference's bottleneck model: fixed compute
    + memory accesses at the tier-weighted AMAT + amortized migration."""
    amat = modeled_access_time_ns(state, tier_pair)
    op_ns = compute_ns_per_op + mem_accesses_per_op * amat + migration_ns
    # a tensor numerator: ``scalar / tensor`` is a reciprocal times a
    # multiply in torch, not a true division
    return _f32(1e9, op_ns) / op_ns


def throughput_from_hits(
    nh: np.ndarray, fh: np.ndarray, tier_pair: str = "dram_nvmm"
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side per-window hit-rate and modeled-throughput series from
    near/far hit counts."""
    near_ns, far_ns = (TIER_LATENCY_NS[t] for t in TIER_PAIRS[tier_pair])
    tot = np.maximum(nh + fh, 1)
    amat = (nh * near_ns + fh * far_ns) / tot
    return nh / tot, 1e9 / (COMPUTE_NS_PER_OP + MEM_ACCESSES_PER_OP * amat)


def device_snapshot(cfg: GpacConfig, state: TieredState, jit_rounding: bool = False) -> dict:
    """A dict of 0-d device tensors: epoch, near usage, hit rate and every
    running stats counter (the engine stacks these per window);
    ``jit_rounding`` as in :func:`near_capacity_used`."""
    return dict(
        epoch=state.epoch,
        near_usage=near_usage(cfg, state),
        near_capacity_used=near_capacity_used(cfg, state, jit_rounding),
        hit_rate=hit_rate(state),
        **state.stats,
    )


def snapshot(cfg: GpacConfig, state: TieredState) -> dict:
    """Device->host pull of the metrics a benchmark window records."""
    d = device_snapshot(cfg, state)
    return {k: (float(v) if k in FLOAT_METRICS else int(v)) for k, v in d.items()}
