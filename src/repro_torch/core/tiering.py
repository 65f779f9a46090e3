"""Host-side memory tiering: block-granular policies (port of
``repro.core.tiering``'s replicated part).

The host sees only huge-page telemetry and moves whole blocks between
tiers: ``memtierd``, ``autonuma`` and ``tpp``, with the near-memory
pressure controller (:func:`pressure_tick`). Each runs as flows between
adjacent tiers of a ``core.tiers.TierVector`` -- the near/far split is its
2-tier case -- and the controller as a per-tier cascade (``core.tiers``,
which also registers ``compressed`` and ``hybridtier``).

In place: :func:`swap_flow` (and :func:`swap_blocks`, its near/far form)
writes ``block_table``, ``slot_owner`` and both pools of the state handed
in (see ``core.types``). It gathers the moving blocks of both sides before
it writes either, as the reference does.
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


# --------------------------------------------------------------------------
# the migration primitive
# --------------------------------------------------------------------------
def _read_slots(cfg: GpacConfig, state: TieredState, slots: torch.Tensor,
                bounds: tuple[int, int]) -> torch.Tensor:
    """The payload rows of ``slots`` (all inside ``bounds``), whichever pool
    holds them; a tier that straddles the near/far split picks per row."""
    if bounds[1] <= cfg.n_near:
        return state.near_pool[slots]
    if bounds[0] >= cfg.n_near:
        return state.far_pool[slots - cfg.n_near]
    near = (slots < cfg.n_near)[:, None, None]
    return torch.where(near, state.near_pool[slots.clamp(max=cfg.n_near - 1)],
                       state.far_pool[(slots - cfg.n_near).clamp(min=0)])


def _write_slots(cfg: GpacConfig, state: TieredState, slots: torch.Tensor,
                 data: torch.Tensor, bounds: tuple[int, int]) -> None:
    if bounds[1] <= cfg.n_near:
        state.near_pool[slots] = data
    elif bounds[0] >= cfg.n_near:
        state.far_pool[slots - cfg.n_near] = data
    else:
        near = slots < cfg.n_near
        state.near_pool[slots[near]] = data[near]
        state.far_pool[slots[~near] - cfg.n_near] = data[~near]


def _in_range(cfg: GpacConfig, slots: torch.Tensor, bounds: tuple[int, int]) -> torch.Tensor:
    """Whether each slot lies in the tier range ``[lo, hi)``. Slots lie in
    ``[0, n_slots)``, so a bound at either end of that space is not tested:
    on the near/far split each side is one comparison."""
    lo, hi = bounds
    if lo == 0:
        return slots < hi
    if hi == cfg.n_slots:
        return slots >= lo
    return (slots >= lo) & (slots < hi)


def swap_flow(
    cfg: GpacConfig,
    state: TieredState,
    lo_hps: torch.Tensor,
    hi_hps: torch.Tensor,
    k,
    hi_bounds: tuple[int, int],
    lo_bounds: tuple[int, int],
) -> TieredState:
    """Promote ``lo_hps[i]`` (lower tier) and demote ``hi_hps[i]`` (upper
    tier) for i < k; pairs with a -1 id, i >= k, or a slot outside its
    claimed tier range are dropped (the reference gathers rows for them and
    scatters those to the drop sentinel: the same values)."""
    i = torch.arange(lo_hps.shape[0], device=lo_hps.device)
    lo_c = lo_hps.clamp(min=0)
    hi_c = hi_hps.clamp(min=0)
    s_lo = state.block_table[lo_c]
    s_hi = state.block_table[hi_c]
    ok = ((i < k) & (lo_hps >= 0) & (hi_hps >= 0) & _in_range(cfg, s_lo, lo_bounds)
          & _in_range(cfg, s_hi, hi_bounds))

    sel = ok.nonzero(as_tuple=True)  # one device sync for the masks
    s_lo_ok, s_hi_ok = s_lo[sel], s_hi[sel]
    # gather both sides before writing either
    data_lo = _read_slots(cfg, state, s_lo_ok, lo_bounds)
    data_hi = _read_slots(cfg, state, s_hi_ok, hi_bounds)
    _write_slots(cfg, state, s_hi_ok, data_lo, hi_bounds)
    _write_slots(cfg, state, s_lo_ok, data_hi, lo_bounds)

    state.block_table[lo_hps[sel]] = s_hi_ok
    state.block_table[hi_hps[sel]] = s_lo_ok
    state.slot_owner[s_hi_ok] = lo_c[sel]
    state.slot_owner[s_lo_ok] = hi_c[sel]

    alloc = allocated_hp_mask(cfg, state)
    stats = dict(state.stats)
    stats["promoted_blocks"] = stats["promoted_blocks"] + (ok & alloc[lo_c]).sum().to(torch.int32)
    stats["demoted_blocks"] = stats["demoted_blocks"] + (ok & alloc[hi_c]).sum().to(torch.int32)
    stats["tlb_shootdowns"] = stats["tlb_shootdowns"] + ok.any().to(torch.int32)
    return dataclasses.replace(state, stats=stats)


def swap_blocks(
    cfg: GpacConfig,
    state: TieredState,
    far_hps: torch.Tensor,
    near_hps: torch.Tensor,
    k,
) -> TieredState:
    """Promote ``far_hps[i]`` and demote ``near_hps[i]`` for i < k; pairs
    with a -1 id, i >= k or mismatched tiers are dropped (:func:`swap_flow`
    between the near and the far pool)."""
    return swap_flow(cfg, state, far_hps, near_hps, k, (0, cfg.n_near),
                     (cfg.n_near, cfg.n_slots))


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


def _flow(cfg, state, tiers, pair_name, **kw):
    """A builtin policy as adjacent-pair flows (``core.tiers.flow_tick``)
    over ``tiers``, or the near/far split when it is None."""
    from repro_torch.core import tiers as tiers_mod

    return tiers_mod.flow_tick(cfg, state, tiers_mod.as_vector(cfg, tiers),
                               tiers_mod._PAIR_FNS[pair_name], **kw)


def memtierd_tick(cfg: GpacConfig, state: TieredState, budget: int = 64,
                  tiers=None) -> TieredState:
    """Proactive ranking: promote the hottest far blocks over colder near
    ones (strictly improving pairs), then demote cold near blocks into free
    far blocks; per adjacent tier pair given an N-tier ``tiers`` vector."""
    return _flow(cfg, state, tiers, "memtierd", budget=budget)


def autonuma_tick(
    cfg: GpacConfig, state: TieredState, budget: int = 16, pressure: float = 0.95,
    tiers=None,
) -> TieredState:
    """Hint-fault promotion; demote only under pressure (LRU victims)."""
    return _flow(cfg, state, tiers, "autonuma", budget=budget, pressure=pressure)


def tpp_tick(
    cfg: GpacConfig, state: TieredState, budget: int = 16, watermark: float = 0.1,
    tiers=None,
) -> TieredState:
    """Fault promotion + watermark demotion under allocation pressure."""
    return _flow(cfg, state, tiers, "tpp", budget=budget, watermark=watermark)


register_policy("memtierd", memtierd_tick)
register_policy("autonuma", autonuma_tick)
register_policy("tpp", tpp_tick)


def tick(cfg: GpacConfig, state: TieredState, policy: str, tiers=None, **kw) -> TieredState:
    """Dispatch to a registered host tiering policy by name; ``tiers`` (a
    ``core.tiers.TierVector``) is forwarded only when set."""
    try:
        fn = _POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown tiering policy {policy!r} (have {policies()})") from None
    if tiers is not None:
        kw["tiers"] = tiers
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
    skips it, with no device sync (a tensor ``near_cap`` always takes the
    full path). It is the per-tier cascade
    (``core.tiers.pressure_cascade``) over ``tiers``, or over the near/far
    split when it is None, keyed on tier 0."""
    del engaged  # previous-window breach: carried for observers, not logic
    from repro_torch.core import tiers as tiers_mod

    return tiers_mod.pressure_cascade(
        cfg, state, tiers_mod.as_vector(cfg, tiers), near_cap, pressure,
        budget=budget, slack=slack)
