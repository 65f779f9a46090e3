"""Host-side memory tiering: block-granular policies (port of the two-tier
part of ``repro.core.tiering``).

The host sees only huge-page telemetry and moves whole blocks between the
near and far pools. ``memtierd``, ``autonuma`` and ``tpp`` are ported, with
the two-tier near-memory pressure controller (:func:`pressure_tick`); the
n-tier flows (``core/tiers.py``) are not yet.

In place: :func:`swap_blocks` writes ``block_table``, ``slot_owner`` and
both pools of the state handed in (see ``core.types``). It gathers the
moving blocks of both pools before it writes either, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.telemetry import _popcount_u8
from repro_torch.core.types import GpacConfig, TieredState, allocated_hp_mask

NEG = -(2**31) + 1

_POLICIES: dict[str, Callable] = {}


def register_policy(name: str, fn: Callable | None = None):
    """Register a host tiering policy ``fn(cfg, state, **kw) ->
    TieredState``; usable as ``@register_policy("name")``."""
    if fn is None:
        return lambda f: register_policy(name, f)
    if name in _POLICIES:
        raise ValueError(f"tiering policy {name!r} already registered")
    _POLICIES[name] = fn
    return fn


def policies() -> tuple[str, ...]:
    return tuple(_POLICIES)


def swap_blocks(
    cfg: GpacConfig,
    state: TieredState,
    far_hps: torch.Tensor,
    near_hps: torch.Tensor,
    k,
) -> TieredState:
    """Promote ``far_hps[i]`` and demote ``near_hps[i]`` for i < k; pairs
    with a -1 id, i >= k or mismatched tiers are dropped."""
    i = torch.arange(far_hps.shape[0], device=far_hps.device)
    fa = far_hps.clamp(min=0)
    ne = near_hps.clamp(min=0)
    s_far = state.block_table[fa]
    s_near = state.block_table[ne]
    ok = ((i < k) & (far_hps >= 0) & (near_hps >= 0)
          & (s_far >= cfg.n_near) & (s_near < cfg.n_near))

    sel = ok.nonzero(as_tuple=True)  # one device sync for the masks
    s_far_ok, s_near_ok = s_far[sel], s_near[sel]
    # gather both sides before writing either
    data_far = state.far_pool[s_far_ok - cfg.n_near]
    data_near = state.near_pool[s_near_ok]
    state.near_pool[s_near_ok] = data_far
    state.far_pool[s_far_ok - cfg.n_near] = data_near

    state.block_table[far_hps[sel]] = s_near_ok
    state.block_table[near_hps[sel]] = s_far_ok
    state.slot_owner[s_near_ok] = fa[sel]
    state.slot_owner[s_far_ok] = ne[sel]

    alloc = allocated_hp_mask(cfg, state)
    promoted = (ok & alloc[fa]).sum().to(torch.int32)
    demoted = (ok & alloc[ne]).sum().to(torch.int32)
    stats = dict(state.stats)
    stats["promoted_blocks"] = stats["promoted_blocks"] + promoted
    stats["demoted_blocks"] = stats["demoted_blocks"] + demoted
    stats["tlb_shootdowns"] = stats["tlb_shootdowns"] + ok.any().to(torch.int32)
    return dataclasses.replace(state, stats=stats)


def block_score_arrays(host_counts: torch.Tensor, host_hist: torch.Tensor) -> torch.Tensor:
    """The host block score: count * 256 + history popcount (int32)."""
    return host_counts * 256 + _popcount_u8(host_hist)


def _block_score(cfg: GpacConfig, state: TieredState) -> torch.Tensor:
    return block_score_arrays(state.host_counts, state.host_hist)


def _top_desc(x: torch.Tensor, k: int):
    """``lax.top_k`` on a vector: a stable descending sort, so that ties go
    to the lowest index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _paired_ids(mask_a, score_a, mask_b, score_b, budget):
    """Top-``budget`` ids of a (desc score) paired with top ids of b (asc
    score); -1 padded. Returns (ids_a, ids_b, k)."""
    budget = min(budget, mask_a.shape[0])
    sa = torch.where(mask_a, score_a, NEG)
    sb = torch.where(mask_b, -score_b, NEG)
    va, ia = _top_desc(sa, budget)
    vb, ib = _top_desc(sb, budget)
    ids_a = torch.where(va > NEG, ia.to(torch.int32), -1)
    ids_b = torch.where(vb > NEG, ib.to(torch.int32), -1)
    k = torch.minimum((ids_a >= 0).sum(), (ids_b >= 0).sum())
    return ids_a, ids_b, k


def memtierd_tick(cfg: GpacConfig, state: TieredState, budget: int = 64) -> TieredState:
    """Proactive ranking: promote the hottest far blocks over colder near
    ones (strictly improving pairs), then demote cold near blocks into free
    far blocks."""
    score = _block_score(cfg, state)
    alloc = allocated_hp_mask(cfg, state)
    in_near = state.block_table < cfg.n_near
    victim_score = torch.where(alloc, score, NEG + 1)
    far_ids, near_ids, k = _paired_ids(
        alloc & ~in_near & (score > 0), score, in_near, victim_score, budget)
    gain = ((far_ids >= 0) & (near_ids >= 0)
            & (score[far_ids.clamp(min=0)] > victim_score[near_ids.clamp(min=0)]))
    # pairs are sorted best-first, so the improving prefix is contiguous
    k = torch.minimum(k, gain.to(torch.int32).cumprod(dim=0).sum())
    state = swap_blocks(cfg, state, far_ids, near_ids, k)

    alloc = allocated_hp_mask(cfg, state)
    in_near = state.block_table < cfg.n_near
    score = _block_score(cfg, state)
    cold_near = alloc & in_near & (score == 0)
    free_far = ~alloc & ~in_near
    far_ids, near_ids, k = _paired_ids(
        free_far, torch.zeros_like(score), cold_near, score, budget)
    return swap_blocks(cfg, state, far_ids, near_ids, k)


def autonuma_tick(
    cfg: GpacConfig, state: TieredState, budget: int = 16, pressure: float = 0.95,
) -> TieredState:
    """Hint-fault promotion; demote only under pressure (LRU victims)."""
    alloc = allocated_hp_mask(cfg, state)
    in_near = state.block_table < cfg.n_near
    faulting = alloc & ~in_near & (state.host_counts >= 2)
    near_used = (alloc & in_near).sum()
    pressured = near_used >= int(pressure * cfg.n_near)
    lru = state.last_touch_epoch
    victim_ok = in_near & (~alloc | pressured)
    victim_score = torch.where(alloc, lru, NEG + 1)
    far_ids, near_ids, k = _paired_ids(
        faulting, state.host_counts, victim_ok, victim_score, budget)
    return swap_blocks(cfg, state, far_ids, near_ids, k)


def tpp_tick(
    cfg: GpacConfig, state: TieredState, budget: int = 16, watermark: float = 0.1,
) -> TieredState:
    """Fault promotion + watermark demotion under allocation pressure."""
    alloc = allocated_hp_mask(cfg, state)
    in_near = state.block_table < cfg.n_near
    free_near = (in_near & ~alloc).sum()
    want_free = int(watermark * cfg.n_near)
    demand = (alloc & ~in_near & (state.host_counts >= 2)).sum()
    need = torch.maximum(demand.clamp(max=want_free), demand.clamp(max=budget))
    n_demote = (need - free_near).clamp(0, budget)
    lru = state.last_touch_epoch
    far_free_ids, near_cold_ids, k_d = _paired_ids(
        ~in_near & ~alloc, torch.zeros_like(lru), in_near & alloc, lru, budget)
    state = swap_blocks(cfg, state, far_free_ids, near_cold_ids,
                        torch.minimum(k_d, n_demote))
    alloc = allocated_hp_mask(cfg, state)
    in_near = state.block_table < cfg.n_near
    faulting = alloc & ~in_near & (state.host_counts >= 2)
    far_ids, near_ids, k_p = _paired_ids(
        faulting, state.host_counts, in_near & ~alloc, torch.zeros_like(lru),
        budget)
    return swap_blocks(cfg, state, far_ids, near_ids, k_p)


register_policy("memtierd", memtierd_tick)
register_policy("autonuma", autonuma_tick)
register_policy("tpp", tpp_tick)


def tick(cfg: GpacConfig, state: TieredState, policy: str, tiers=None, **kw) -> TieredState:
    """Dispatch to a registered host tiering policy by name."""
    if tiers is not None:
        raise NotImplementedError(
            "n-tier hierarchies (core/tiers.py) are not ported yet "
            "(ROADMAP queue 1, item 12)")
    try:
        fn = _POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown tiering policy {policy!r} (have {policies()})") from None
    return fn(cfg, state, **kw)


def strided_tick(
    cfg: GpacConfig, state: TieredState, policy: str, *, stride: int,
    budget: int, epoch: int, tiers=None,
) -> TieredState:
    """:func:`tick` on windows whose post-window epoch is a multiple of
    ``stride``: ``(epoch + 1) % stride == 0``, where ``epoch`` is the
    caller's host-side copy of ``state.epoch`` (no device read per window)."""
    if (epoch + 1) % stride:
        return state
    return tick(cfg, state, policy, budget=budget, tiers=tiers)


def pressure_tick(
    cfg: GpacConfig,
    state: TieredState,
    near_cap,  # int, or int32[] tensor: effective near capacity (<= n_near)
    engaged: torch.Tensor,  # bool[] hysteresis latch carried between windows
    pressure: torch.Tensor,  # int32[] consecutive engaged windows
    budget: int = 64,
    slack: int = 1,
    tiers=None,
) -> tuple[TieredState, torch.Tensor, torch.Tensor]:
    """Enforce an effective near capacity with two watermarks (the
    reference's controller): when allocated near usage breaches ``near_cap``
    it demotes the coldest allocated near blocks into unallocated far blocks
    down to ``near_cap - slack``, at most ``budget`` per window. Returns
    ``(state, engaged', pressure')``; ``pressure`` counts consecutive
    engaged windows.

    Usage never exceeds the physical ``n_near``, so with a host-side
    ``near_cap >= n_near`` the controller cannot engage and the reference's
    call is a value-exact no-op (a swap of k = 0 pairs); the port then
    returns at once, with no device sync (a tensor ``near_cap`` always
    takes the full path)."""
    del engaged  # previous-window breach: carried for observers, not logic
    if tiers is not None:
        raise NotImplementedError(
            "the n-tier pressure cascade (core/tiers.py) is not ported yet "
            "(ROADMAP queue 1, item 12)")
    dev = state.device
    if not isinstance(near_cap, torch.Tensor) and near_cap >= cfg.n_near:
        return (state, torch.zeros((), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    alloc = allocated_hp_mask(cfg, state)
    in_near = state.block_table < cfg.n_near
    usage = (alloc & in_near).sum().to(torch.int32)
    if isinstance(near_cap, torch.Tensor):
        low = (near_cap - slack).clamp(min=0)
    else:
        low = max(int(near_cap) - slack, 0)
    engaged = usage > near_cap
    n_demote = torch.where(engaged, (usage - low).clamp(0, budget), 0)
    score = _block_score(cfg, state)
    far_ids, near_ids, k = _paired_ids(
        ~alloc & ~in_near, torch.zeros_like(score), alloc & in_near, score,
        budget)
    state = swap_blocks(cfg, state, far_ids, near_ids, torch.minimum(k, n_demote))
    pressure = torch.where(engaged, pressure + 1, 0).to(torch.int32)
    return state, engaged, pressure
