"""N-tier memory hierarchies: software-defined tiers, inter-tier flows, TCO
(port of ``repro.core.tiers``).

The near/far split is the 2-tier special case of an ordered vector of
tiers:

* :class:`TierSpec` -- one tier: capacity fraction, latency, bandwidth,
  compression factor and a $/GB cost weight;
* :class:`TierVector` -- a resolved hierarchy: the specs plus slot
  boundaries partitioning ``[0, n_slots)`` into contiguous tier ranges
  (tier 0 is the near pool, the last tier the capacity backstop).

Placement runs as flows between adjacent tiers: :func:`flow_tick` runs a
pair policy top-down over each (upper, lower) pair, moving blocks with
``tiering.swap_flow``. The near/far host is the 2-tier vector
(:func:`two_tier`): ``tiering``'s ticks and pressure controller run these
flows and this cascade on it. ``compressed`` (demote-into-compressed, arXiv 2404.13886) and
``hybridtier`` (a moving hot threshold, arXiv 2312.04789) ride the flows;
:func:`pressure_cascade` is the churn engine's pressure controller per
tier, and :func:`tco_metrics` prices a placement (the ``tco`` collector).

In place: ``swap_flow`` writes the block table, the slot owners and both
pools of the state handed in. The host-sharded ``compressed`` tick waits for the sharded engine (ROADMAP
queue 1, item 13).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import metrics
from repro_torch.core.tiering import (
    NEG,
    _in_range,
    _paired_ids,
    block_score_arrays,
    register_policy,
    swap_flow,
)
from repro_torch.core.types import GpacConfig, TieredState, allocated_hp_mask
from repro_torch.data import prng

# default $/GB weights per tier name (the near tier is the expensive one)
DEFAULT_COST = {"hbm": 2.5, "dram": 1.0, "zram": 1.0, "cxl": 0.6, "nvmm": 0.4}


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One software-defined tier. ``capacity`` is a fraction of the
    allocated huge-page demand; ``compression`` multiplies it into an
    effective block count (priced on the physical GB). The last tier of a
    vector is the capacity backstop: its ``capacity`` is ignored."""

    name: str
    capacity: float
    latency_ns: float
    bandwidth_gbps: float = 100.0
    compression: float = 1.0
    cost_per_gb: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.capacity <= 1.0:
            raise ValueError(
                f"TierSpec {self.name!r}: capacity must be in (0, 1], got "
                f"{self.capacity}")
        if self.latency_ns <= 0.0:
            raise ValueError(
                f"TierSpec {self.name!r}: latency_ns must be > 0, got "
                f"{self.latency_ns}")
        if self.bandwidth_gbps <= 0.0:
            raise ValueError(
                f"TierSpec {self.name!r}: bandwidth_gbps must be > 0, got "
                f"{self.bandwidth_gbps}")
        if self.compression < 1.0:
            raise ValueError(
                f"TierSpec {self.name!r}: compression must be >= 1, got "
                f"{self.compression}")
        if self.cost_per_gb < 0.0:
            raise ValueError(
                f"TierSpec {self.name!r}: cost_per_gb must be >= 0, got "
                f"{self.cost_per_gb}")


@dataclasses.dataclass(frozen=True)
class TierVector:
    """A resolved tier hierarchy: tier ``t`` owns slots ``[boundaries[t],
    boundaries[t+1])``; ``boundaries[0] == 0``, ``boundaries[-1] ==
    n_slots``. Hashable (tuples only)."""

    tiers: tuple[TierSpec, ...]
    boundaries: tuple[int, ...]

    def __post_init__(self):
        if len(self.tiers) < 2:
            raise ValueError(
                f"TierVector needs >= 2 tiers, got {len(self.tiers)}")
        if len(self.boundaries) != len(self.tiers) + 1:
            raise ValueError(
                f"TierVector: {len(self.tiers)} tiers need "
                f"{len(self.tiers) + 1} boundaries, got "
                f"{len(self.boundaries)}")
        if self.boundaries[0] != 0:
            raise ValueError(
                f"TierVector: boundaries must start at 0, got "
                f"{self.boundaries[0]}")
        if any(b >= c for b, c in zip(self.boundaries, self.boundaries[1:])):
            raise ValueError(
                f"TierVector: boundaries must be strictly increasing, got "
                f"{self.boundaries}")

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    def bounds(self, t: int) -> tuple[int, int]:
        """Slot range ``[lo, hi)`` of tier ``t``."""
        return self.boundaries[t], self.boundaries[t + 1]


def two_tier(cfg: GpacConfig) -> TierVector:
    """The near/far split as a :class:`TierVector`."""
    return TierVector(
        tiers=(
            TierSpec("dram", 1.0, metrics.TIER_LATENCY_NS["dram"],
                     cost_per_gb=DEFAULT_COST["dram"]),
            TierSpec("nvmm", 1.0, metrics.TIER_LATENCY_NS["nvmm"],
                     cost_per_gb=DEFAULT_COST["nvmm"]),
        ),
        boundaries=(0, cfg.n_near, cfg.n_slots),
    )


def compressed_specs(
    near_fraction: float = 0.15,
    mid_fraction: float = 0.25,
    compression: float = 3.0,
) -> tuple[TierSpec, ...]:
    """A 3-tier DRAM / compressed-DRAM (zram) / NVMM hierarchy: the middle
    tier stores ``mid_fraction x compression`` blocks in ``mid_fraction``
    worth of DRAM, and pays a decompression charge on top of DRAM."""
    return (
        TierSpec("dram", near_fraction, metrics.TIER_LATENCY_NS["dram"],
                 cost_per_gb=DEFAULT_COST["dram"]),
        TierSpec("zram", mid_fraction,
                 metrics.TIER_LATENCY_NS["dram"] + 170.0,
                 compression=compression, cost_per_gb=DEFAULT_COST["zram"]),
        TierSpec("nvmm", 1.0, metrics.TIER_LATENCY_NS["nvmm"],
                 cost_per_gb=DEFAULT_COST["nvmm"]),
    )


def resolve(specs: tuple[TierSpec, ...], n_slots: int, total_need: int) -> TierVector:
    """Capacity fractions into slot boundaries over ``n_slots``: each
    non-final tier gets ``int(capacity * total_need) * compression``
    effective slots (at least one), clamped so every later tier keeps one;
    the final tier takes the rest."""
    specs = tuple(specs)
    n = len(specs)
    if n < 2:
        raise ValueError(f"tier hierarchy needs >= 2 tiers, got {n}")
    if n_slots < n:
        raise ValueError(
            f"{n} tiers need at least {n} slots, got n_slots={n_slots}")
    bounds = [0]
    for t in range(n - 1):
        s = specs[t]
        eff = max(1, int(max(1, int(s.capacity * total_need)) * s.compression))
        bounds.append(min(bounds[-1] + eff, n_slots - (n - 1 - t)))
    bounds.append(n_slots)
    return TierVector(tiers=specs, boundaries=tuple(bounds))


def as_vector(cfg: GpacConfig, tiers: TierVector | None) -> TierVector:
    """``tiers`` if given, else the near/far split (:func:`two_tier`)."""
    return tiers if tiers is not None else two_tier(cfg)


def tier_of_slot(tv: TierVector, slots: torch.Tensor) -> torch.Tensor:
    """Tier index of each slot (int32; a slot past the last boundary counts
    in the last tier)."""
    t = torch.zeros(slots.shape, dtype=torch.int32, device=slots.device)
    for b in tv.boundaries[1:-1]:
        t = t + (slots >= b).to(torch.int32)
    return t


def flow_tick(cfg, state, tiers: TierVector, pair_fn, **kw) -> TieredState:
    """``pair_fn(cfg, state, upper_bounds, lower_bounds, **kw)`` over every
    adjacent tier pair, top-down (a hot block climbs one tier per tick)."""
    for t in range(tiers.n_tiers - 1):
        state = pair_fn(cfg, state, tiers.bounds(t), tiers.bounds(t + 1), **kw)
    return state


# --------------------------------------------------------------------------
# the three builtin policies as adjacent-pair flows
# --------------------------------------------------------------------------
def _gain_k(k, lo_ids, hi_ids, score, vict):
    """``k`` cut to the prefix of strictly improving pairs (pairs come
    best-first, so the prefix is contiguous)."""
    gain = ((lo_ids >= 0) & (hi_ids >= 0)
            & (score[lo_ids.clamp(min=0)] > vict[hi_ids.clamp(min=0)]))
    return torch.minimum(k, gain.to(torch.int32).cumprod(dim=0).sum())


def memtierd_pair(cfg, state, u_bounds, d_bounds, budget: int = 64):
    """``tiering.memtierd_tick`` between one adjacent tier pair."""
    score = block_score_arrays(state.host_counts, state.host_hist)
    alloc = allocated_hp_mask(cfg, state)
    in_u = _in_range(cfg, state.block_table, u_bounds)
    in_d = _in_range(cfg, state.block_table, d_bounds)
    victim_score = torch.where(alloc, score, NEG + 1)
    lo_ids, hi_ids, k = _paired_ids(
        alloc & in_d & (score > 0), score, in_u, victim_score, budget)
    k = _gain_k(k, lo_ids, hi_ids, score, victim_score)
    state = swap_flow(cfg, state, lo_ids, hi_ids, k, u_bounds, d_bounds)

    alloc = allocated_hp_mask(cfg, state)
    in_u = _in_range(cfg, state.block_table, u_bounds)
    in_d = _in_range(cfg, state.block_table, d_bounds)
    score = block_score_arrays(state.host_counts, state.host_hist)
    lo_ids, hi_ids, k = _paired_ids(
        ~alloc & in_d, torch.zeros_like(score), alloc & in_u & (score == 0), score,
        budget)
    return swap_flow(cfg, state, lo_ids, hi_ids, k, u_bounds, d_bounds)


def autonuma_pair(cfg, state, u_bounds, d_bounds, budget: int = 16, pressure: float = 0.95):
    """``tiering.autonuma_tick`` between one adjacent tier pair."""
    alloc = allocated_hp_mask(cfg, state)
    in_u = _in_range(cfg, state.block_table, u_bounds)
    in_d = _in_range(cfg, state.block_table, d_bounds)
    faulting = alloc & in_d & (state.host_counts >= 2)
    pressured = (alloc & in_u).sum() >= int(pressure * (u_bounds[1] - u_bounds[0]))
    lru = state.last_touch_epoch
    victim_ok = in_u & (~alloc | pressured)
    victim_score = torch.where(alloc, lru, NEG + 1)
    lo_ids, hi_ids, k = _paired_ids(
        faulting, state.host_counts, victim_ok, victim_score, budget)
    return swap_flow(cfg, state, lo_ids, hi_ids, k, u_bounds, d_bounds)


def tpp_pair(cfg, state, u_bounds, d_bounds, budget: int = 16, watermark: float = 0.1):
    """``tiering.tpp_tick`` between one adjacent tier pair."""
    alloc = allocated_hp_mask(cfg, state)
    in_u = _in_range(cfg, state.block_table, u_bounds)
    in_d = _in_range(cfg, state.block_table, d_bounds)
    free_u = (in_u & ~alloc).sum()
    want_free = int(watermark * (u_bounds[1] - u_bounds[0]))
    demand = (alloc & in_d & (state.host_counts >= 2)).sum()
    need = torch.maximum(demand.clamp(max=want_free), demand.clamp(max=budget))
    n_demote = (need - free_u).clamp(0, budget)
    lru = state.last_touch_epoch
    lo_free_ids, hi_cold_ids, k_d = _paired_ids(
        in_d & ~alloc, torch.zeros_like(lru), in_u & alloc, lru, budget)
    state = swap_flow(cfg, state, lo_free_ids, hi_cold_ids,
                      torch.minimum(k_d, n_demote), u_bounds, d_bounds)
    alloc = allocated_hp_mask(cfg, state)
    in_u = _in_range(cfg, state.block_table, u_bounds)
    in_d = _in_range(cfg, state.block_table, d_bounds)
    faulting = alloc & in_d & (state.host_counts >= 2)
    lo_ids, hi_ids, k_p = _paired_ids(
        faulting, state.host_counts, in_u & ~alloc, torch.zeros_like(lru), budget)
    return swap_flow(cfg, state, lo_ids, hi_ids, k_p, u_bounds, d_bounds)


_PAIR_FNS = {
    "memtierd": memtierd_pair,
    "autonuma": autonuma_pair,
    "tpp": tpp_pair,
}


# --------------------------------------------------------------------------
# per-tier pressure cascade (tiering.pressure_tick generalized)
# --------------------------------------------------------------------------
def pressure_cascade(
    cfg: GpacConfig,
    state: TieredState,
    tiers: TierVector,
    near_cap,  # int, or int32[] tensor: tier 0's effective capacity
    pressure: torch.Tensor,
    budget: int = 64,
    slack: int = 1,
):
    """Per-tier watermark enforcement, top-down: a tier whose allocated
    usage breaches its cap demotes its coldest blocks into the tier below,
    down to ``cap - slack``. Tier 0's cap is ``near_cap``; a deeper tier's
    is its size minus ``slack``, so a demote wave cascades down. Returns
    ``(state, engaged0, pressure')``, keyed on tier 0.

    Tier 0's usage never exceeds its size, so with a host-side ``near_cap``
    at or above it tier 0 cannot engage and its step (a swap of no pair in
    the reference) is skipped with no device sync; every deeper tier is
    enforced every window."""
    dev = state.device
    engaged0 = torch.zeros((), dtype=torch.bool, device=dev)
    for t in range(tiers.n_tiers - 1):
        u_lo, u_hi = tiers.bounds(t)
        d_bounds = tiers.bounds(t + 1)
        if t == 0:
            cap = near_cap
            if not isinstance(cap, torch.Tensor) and cap >= u_hi - u_lo:
                continue
        else:
            cap = max(u_hi - u_lo - slack, 0)
        alloc = allocated_hp_mask(cfg, state)
        in_u = _in_range(cfg, state.block_table, (u_lo, u_hi))
        in_d = _in_range(cfg, state.block_table, d_bounds)
        usage = (alloc & in_u).sum().to(torch.int32)
        low = (cap - slack).clamp(min=0) if isinstance(cap, torch.Tensor) else max(cap - slack, 0)
        engaged = usage > cap
        n_demote = torch.where(engaged, (usage - low).clamp(0, budget), 0)
        score = block_score_arrays(state.host_counts, state.host_hist)
        lo_ids, hi_ids, k = _paired_ids(
            ~alloc & in_d, torch.zeros_like(score), alloc & in_u, score, budget)
        state = swap_flow(cfg, state, lo_ids, hi_ids, torch.minimum(k, n_demote),
                          (u_lo, u_hi), d_bounds)
        if t == 0:
            engaged0 = engaged
    pressure = torch.where(engaged0, pressure + 1, 0).to(torch.int32)
    return state, engaged0, pressure


# --------------------------------------------------------------------------
# compressed-tier policy (arXiv 2404.13886)
# --------------------------------------------------------------------------
def compressed_tick(
    cfg: GpacConfig,
    state: TieredState,
    budget: int = 64,
    tiers: TierVector | None = None,
    free_frac: float = 0.1,
) -> TieredState:
    """Demote-into-compressed placement over an N-tier vector. Per adjacent
    pair, top-down: demote the coldest allocated upper blocks until
    ``free_frac`` of the upper tier is free, then promote identified-hot
    lower blocks over strictly colder upper victims. Every mask and score
    comes from the pre-tick snapshot; the swaps re-check the current slot
    ranges, so a block that already moved drops out of a later pair."""
    tv = as_vector(cfg, tiers)
    score0 = block_score_arrays(state.host_counts, state.host_hist)
    alloc0 = allocated_hp_mask(cfg, state)
    bt0 = state.block_table.clone()  # the swaps below write the live table
    vict0 = torch.where(alloc0, score0, NEG + 1)
    zero = torch.zeros_like(score0)
    for t in range(tv.n_tiers - 1):
        u_bounds, d_bounds = tv.bounds(t), tv.bounds(t + 1)
        in_u0 = _in_range(cfg, bt0, u_bounds)
        in_d0 = _in_range(cfg, bt0, d_bounds)
        free_u0 = (in_u0 & ~alloc0).sum()
        want = int(free_frac * (u_bounds[1] - u_bounds[0]))
        n_demote = (want - free_u0).clamp(0, budget)
        lo_ids, hi_ids, k = _paired_ids(
            in_d0 & ~alloc0, zero, in_u0 & alloc0, score0, budget)
        state = swap_flow(cfg, state, lo_ids, hi_ids, torch.minimum(k, n_demote),
                          u_bounds, d_bounds)
        lo_ids, hi_ids, k = _paired_ids(
            alloc0 & in_d0 & (score0 > 0), score0, in_u0, vict0, budget)
        k = _gain_k(k, lo_ids, hi_ids, score0, vict0)
        state = swap_flow(cfg, state, lo_ids, hi_ids, k, u_bounds, d_bounds)
    return state


# --------------------------------------------------------------------------
# HybridTier-style adaptive policy (arXiv 2312.04789)
# --------------------------------------------------------------------------
def hybridtier_tick(
    cfg: GpacConfig,
    state: TieredState,
    budget: int = 16,
    tiers: TierVector | None = None,
) -> TieredState:
    """Adaptive hot-threshold placement: per pair, the promotion bar is the
    mean score of the upper tier's resident blocks (an int32 sum, wrapping
    as the reference's does, floor-divided by their count); lower blocks
    strictly above it are promoted over upper victims at or below it."""
    tv = as_vector(cfg, tiers)
    for t in range(tv.n_tiers - 1):
        u_bounds, d_bounds = tv.bounds(t), tv.bounds(t + 1)
        score = block_score_arrays(state.host_counts, state.host_hist)
        alloc = allocated_hp_mask(cfg, state)
        in_u = _in_range(cfg, state.block_table, u_bounds)
        in_d = _in_range(cfg, state.block_table, d_bounds)
        resident = alloc & in_u
        n_res = resident.sum().to(torch.int32)
        total = prng.wrap_i32(torch.where(resident, score, 0).sum())
        thr = torch.div(total, n_res.clamp(min=1), rounding_mode="floor").to(torch.int32)
        vict = torch.where(alloc, score, NEG + 1)
        lo_ids, hi_ids, k = _paired_ids(
            alloc & in_d & (score > thr), score, in_u & (~alloc | (score <= thr)),
            vict, budget)
        k = _gain_k(k, lo_ids, hi_ids, score, vict)
        state = swap_flow(cfg, state, lo_ids, hi_ids, k, u_bounds, d_bounds)
    return state


# --------------------------------------------------------------------------
# TCO metric (priced placement + per-tier AMAT)
# --------------------------------------------------------------------------
def tier_hit_counts(tv: TierVector, slot: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-tier access counts of one window's translated slots
    (int32[n_tiers]); invalid accesses count nowhere."""
    return torch.stack([
        (valid & (slot >= lo) & (slot < hi)).sum().to(torch.int32)
        for lo, hi in (tv.bounds(t) for t in range(tv.n_tiers))])


def tier_block_counts(tv: TierVector, bt: torch.Tensor, alloc: torch.Tensor) -> torch.Tensor:
    """Allocated blocks per tier from block_table rows (int32[n_tiers])."""
    return torch.stack([
        (alloc & (bt >= lo) & (bt < hi)).sum().to(torch.int32)
        for lo, hi in (tv.bounds(t) for t in range(tv.n_tiers))])


def tier_alloc_counts(cfg: GpacConfig, state: TieredState, tv: TierVector) -> torch.Tensor:
    return tier_block_counts(tv, state.block_table, allocated_hp_mask(cfg, state))


def tier_count_delta(tv: TierVector, swaps) -> torch.Tensor:
    """Per-tier allocated-block delta implied by arbitrated swap rounds
    ``(lo, hi, ok)`` (``lo`` and ``hi`` dicts with ``slot`` and ``alloc``
    rows): the host-partitioned path prices the post-tick placement from
    pre-tick counts plus the committed swaps."""
    d = torch.zeros((tv.n_tiers,), dtype=torch.int32)
    for lo, hi, ok in swaps:
        d = d.to(ok.device)
        for side, other in ((lo, hi), (hi, lo)):
            w = (ok & (side["alloc"] > 0)).to(torch.int32)
            d.index_add_(0, tier_of_slot(tv, side["slot"]).long(), -w)
            d.index_add_(0, tier_of_slot(tv, other["slot"]).long(), w)
    return d


def amat_per_hit_ns(cfg: GpacConfig, s: TierSpec) -> float:
    """Per-hit AMAT cost of one tier: latency plus the base-page transfer
    time at the tier's bandwidth, quantized to sixteenth-ns (so that
    ``hits * cost`` and the fixed-order sums are exact in float32 while
    ``hits * 16 * cost < 2**24``)."""
    return round(16.0 * (s.latency_ns + cfg.base_bytes / s.bandwidth_gbps)) / 16.0


def _priced_sum(counts: torch.Tensor, costs: list[float], jit_rounding: bool) -> torch.Tensor:
    """float32 ``sum_t counts[t] * costs[t]`` in the fixed tier order.
    Eager JAX rounds every product and sum; inside the engine's jitted
    window XLA's CPU code (jax 0.9.0) fuses them as ``fma(x0, c0, x1 *
    c1)``, then ``fma(x_t, c_t, acc)`` for each later tier."""
    x = counts.to(torch.float64)  # exact: counts below 2**24
    if jit_rounding:
        acc = prng._fma32(x[0], costs[0], prng._f32(x[1] * costs[1]))
        for t in range(2, len(costs)):
            acc = prng._fma32(x[t], costs[t], acc)
        return acc
    acc = torch.zeros((), dtype=torch.float64, device=counts.device)
    for t, c in enumerate(costs):
        acc = prng._f32(acc + prng._f32(x[t] * c))
    return acc


def tco_metrics(
    cfg: GpacConfig, tv: TierVector, tier_blocks: torch.Tensor,
    tier_hits: torch.Tensor, jit_rounding: bool = False,
) -> dict:
    """The TCO objective: ``tco = sum_t blocks_t * GB/block * cost_t /
    compression_t`` (float32) and the per-tier AMAT ``amat_ns`` of this
    window's hits, with the raw vectors. ``jit_rounding`` rounds the sums
    as the reference's collector does inside ``jax.jit``
    (:func:`_priced_sum`); without it, as eager JAX does."""
    gb_per_block = cfg.hp_bytes / float(1 << 30)
    f32 = prng._k
    tco = _priced_sum(tier_blocks, [f32(gb_per_block * s.cost_per_gb / s.compression)
                                    for s in tv.tiers], jit_rounding)
    amat = _priced_sum(tier_hits, [f32(amat_per_hit_ns(cfg, s)) for s in tv.tiers],
                       jit_rounding)
    total = tier_hits.sum().to(torch.float32).to(torch.float64).clamp(min=1.0)
    return dict(
        tco=tco.to(torch.float32),
        amat_ns=prng._f32(amat / total).to(torch.float32),
        tier_blocks=tier_blocks,
        tier_hits=tier_hits,
    )


def _sharded_not_ported(*args, **kwargs):
    raise NotImplementedError(
        "the host-sharded 'compressed' tick (_compressed_prepare, flow_outcome, "
        "_compressed_apply) is not ported to PyTorch yet (ROADMAP queue 1, item 13)")


_compressed_prepare = flow_outcome = _compressed_apply = _sharded_not_ported

register_policy("compressed", compressed_tick)
register_policy("hybridtier", hybridtier_tick)
