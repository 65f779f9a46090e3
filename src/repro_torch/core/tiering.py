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

# the builtin near/far policies, the ones the invariant contracts range
# over (the live set is policies())
POLICIES = ("memtierd", "autonuma", "tpp")
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


# ==========================================================================
# host-partitioned ticks (the reference's DESIGN.md §11)
#
# Each rank holds one contiguous block range of the host state and scores
# promotion and demotion over it only; one exchange per arbitration group
# (``core.sharding``) merges the per-range candidate sets, and the
# arbitration below reproduces the replicated tick's choices bit for bit. A
# sharded tick is a (prepare, apply) pair:
#
#   prepare(cfg, L, budget) -> {"cands": {name: candidate dict}, "sums": {..}}
#       before the exchange: per-side top-``budget`` nominations over the
#       local range, and a few int32 scalar sums.
#   apply(cfg, L, merged, budget) -> (block_table', stats_delta, swaps)
#       after it: arbitrate the merged sets in (score desc, block id asc)
#       order -- ``lax.top_k``'s order on the full array -- and write the
#       winning swaps into this rank's own block-table rows. ``stats_delta``
#       is replicated (the driver adds it on rank 0 only); ``swaps`` is the
#       per-round ((far, near, ok), ...) tuple the collectors read.
#
# ``L`` is the local-range context: ``hp_ids`` int32[H] global block ids
# (-1 padded), ``hp_lo`` / ``hp_hi`` this rank's range (ints), ``bt`` the
# local block_table rows, ``hc`` / ``hh`` / ``lt`` the local host
# telemetry and ``alloc`` bool[H].
# ==========================================================================
_FILL = dict(val=NEG, id=-1, slot=0, alloc=0, cnt=0)


def _b(cfg: GpacConfig, budget: int) -> int:
    """Effective per-side budget (``_paired_ids``' shape clamp)."""
    return min(budget, cfg.n_gpa_hp)


def _check_two_tier(cfg: GpacConfig, tiers) -> None:
    """The builtin sharded ticks arbitrate one near/far pair: a tier vector
    is accepted only when it is the 2-tier split (``compressed`` in
    ``core.tiers`` handles N > 2 on this path)."""
    if tiers is None or tiers.boundaries == (0, cfg.n_near, cfg.n_slots):
        return
    raise ValueError(
        f"builtin sharded ticks support only the 2-tier split "
        f"(0, {cfg.n_near}, {cfg.n_slots}); got boundaries "
        f"{tiers.boundaries} -- use policy='compressed' or "
        f"host_sharded=False")


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _cand_kw(L: dict) -> dict:
    return dict(hp_ids=L["hp_ids"], slot=L["bt"], alloc=_i32(L["alloc"]),
                cnt=_i32(L["hc"]))


def nominate(
    mask: torch.Tensor, val: torch.Tensor, b: int, *, hp_ids: torch.Tensor,
    slot: torch.Tensor, alloc: torch.Tensor, cnt: torch.Tensor,
) -> dict:
    """Local top-``b`` nomination over this rank's block range: int32[b]
    fields ``val`` (NEG past the valid tail), ``id`` (global block id, -1
    padded), and the arbitration's metadata ``slot``, ``alloc`` and ``cnt``.
    Ties go to the lowest local row, which is the lowest block id (the
    stable descending sort, as ``lax.top_k``)."""
    k = min(b, mask.shape[0])
    v, i = _top_desc(torch.where(mask & (hp_ids >= 0), val, NEG), k)
    ok = v > NEG
    out = dict(
        val=_i32(v),
        id=torch.where(ok, hp_ids[i], -1),
        slot=torch.where(ok, slot[i], 0),
        alloc=torch.where(ok, alloc[i], 0),
        cnt=torch.where(ok, cnt[i], 0),
    )
    if k < b:
        out = {f: torch.cat([x, torch.full((b - k,), _FILL[f], dtype=torch.int32,
                                           device=x.device)])
               for f, x in out.items()}
    return out


def _flat_cands(c: dict) -> dict:
    """Merged candidate blocks ``[n_shards, b]`` -> one flat candidate set."""
    return {f: x.reshape(-1) for f, x in c.items()}


def _concat_cands(a: dict, b: dict) -> dict:
    return {f: torch.cat([a[f], b[f]]) for f in a}


def rank_select(c: dict, b: int) -> dict:
    """The top-``b`` of a merged candidate set by (val desc, id asc): output
    row ``j`` holds the rank-``j`` candidate, the invalid tail is
    ``(NEG, -1, 0, 0, 0)``. Equals ``lax.top_k`` over the full per-block
    array when the ids are unique and the set covers its top ``b``, which
    per-range top-``b`` nominations guarantee."""
    val, cid = c["val"], c["id"]
    valid = (val > NEG) & (cid >= 0)
    beats = valid[None, :] & ((val[None, :] > val[:, None])
                              | ((val[None, :] == val[:, None]) & (cid[None, :] < cid[:, None])))
    rank = beats.sum(dim=1)
    pos = torch.where(valid & (rank < b), rank, b)
    out = {}
    for f, x in c.items():
        o = torch.full((b + 1,), _FILL[f], dtype=torch.int32, device=x.device)
        o[pos] = x  # valid ranks are unique; the rest land on row b
        out[f] = o[:b]
    return out


def _pair_k(far: dict, near: dict) -> torch.Tensor:
    return torch.minimum((far["id"] >= 0).sum(), (near["id"] >= 0).sum())


def swap_outcome(cfg: GpacConfig, far: dict, near: dict, k):
    """Replicated outcome of one arbitrated swap round: which pairs commit
    (:func:`swap_blocks`' predicate) and the stats deltas."""
    i = torch.arange(far["id"].shape[0], device=far["id"].device)
    ok = ((i < k) & (far["id"] >= 0) & (near["id"] >= 0)
          & (far["slot"] >= cfg.n_near) & (near["slot"] < cfg.n_near))
    return ok, _swap_stats(ok, far, near)


def _swap_stats(ok: torch.Tensor, lo: dict, hi: dict) -> dict:
    return dict(
        promoted_blocks=_i32((ok & (lo["alloc"] > 0)).sum()),
        demoted_blocks=_i32((ok & (hi["alloc"] > 0)).sum()),
        tlb_shootdowns=_i32(ok.sum() > 0),
    )


def slots_after_swaps(ids: torch.Tensor, slots: torch.Tensor, far: dict, near: dict,
                      ok: torch.Tensor) -> torch.Tensor:
    """Each candidate's slot after a committed swap round (the replicated
    slot ledger two-round policies consult for round 2)."""
    fa = torch.where(ok, far["id"], -2)
    ne = torch.where(ok, near["id"], -2)
    mf = ids[:, None] == fa[None, :]
    mn = ids[:, None] == ne[None, :]
    out = torch.where(mf.any(dim=1), _i32((mf * near["slot"][None, :]).sum(dim=1)), slots)
    return torch.where(mn.any(dim=1), _i32((mn * far["slot"][None, :]).sum(dim=1)), out)


def apply_swaps_local(bt: torch.Tensor, hp_lo: int, hp_hi: int, far: dict, near: dict,
                      ok: torch.Tensor) -> torch.Tensor:
    """Write an arbitrated swap round into this rank's block-table rows.
    Only slot labels move: in the host-partitioned layout the payload lives
    with its huge page, so a cross-range migration copies nothing."""
    drop = bt.shape[0]
    out = torch.cat([bt, bt.new_zeros(1)])
    for ids, new_slot in ((far["id"], near["slot"]), (near["id"], far["slot"])):
        row = torch.where(ok & (ids >= hp_lo) & (ids < hp_hi), ids - hp_lo, drop)
        out[row.long()] = new_slot
    return out[:drop]


# --------------------------------------------------------------------------
# per-policy (prepare, apply) pairs
# --------------------------------------------------------------------------
def _memtierd_prepare(cfg: GpacConfig, L: dict, budget: int, tiers=None) -> dict:
    _check_two_tier(cfg, tiers)
    b = _b(cfg, budget)
    kw = _cand_kw(L)
    valid = L["hp_ids"] >= 0
    score = block_score_arrays(L["hc"], L["hh"])
    alloc, in_near = L["alloc"], L["bt"] < cfg.n_near
    victim = torch.where(alloc, score, NEG + 1)
    zero = torch.zeros_like(score)
    return dict(cands=dict(
        hot_far=nominate(valid & alloc & ~in_near & (score > 0), score, b, **kw),
        victim=nominate(valid & in_near, -victim, b, **kw),
        free_far=nominate(valid & ~alloc & ~in_near, zero, b, **kw),
        # round 1 can demote up to b cold near blocks, so 2b keep covering
        # the post-swap global top b
        cold_near=nominate(valid & alloc & in_near & (score == 0), zero, 2 * b, **kw),
    ), sums=dict())


def _memtierd_apply(cfg: GpacConfig, L: dict, merged: dict, budget: int, tiers=None):
    _check_two_tier(cfg, tiers)
    b = _b(cfg, budget)
    C = {k: _flat_cands(v) for k, v in merged["cands"].items()}
    # round 1: hottest far vs coldest near, strictly improving pairs only
    far = rank_select(C["hot_far"], b)
    near = rank_select(C["victim"], b)
    gain = torch.where((far["id"] >= 0) & (near["id"] >= 0), far["val"] > -near["val"], False)
    k = torch.minimum(_pair_k(far, near), _i32(gain).cumprod(0).sum())
    ok1, d1 = swap_outcome(cfg, far, near, k)
    bt = apply_swaps_local(L["bt"], L["hp_lo"], L["hp_hi"], far, near, ok1)

    # round 2: cold near blocks into free far ones, masks on the
    # post-round-1 placement through the slot ledger
    def after(c):
        return {**c, "slot": slots_after_swaps(c["id"], c["slot"], far, near, ok1)}

    A2 = _concat_cands(after(C["free_far"]), after(near))
    A2["val"] = torch.where((A2["id"] >= 0) & (A2["alloc"] == 0) & (A2["slot"] >= cfg.n_near),
                            0, NEG).to(torch.int32)
    B2 = after(C["cold_near"])
    B2["val"] = torch.where((B2["id"] >= 0) & (B2["alloc"] > 0) & (B2["slot"] < cfg.n_near),
                            0, NEG).to(torch.int32)
    far2 = rank_select(A2, b)
    near2 = rank_select(B2, b)
    ok2, d2 = swap_outcome(cfg, far2, near2, _pair_k(far2, near2))
    bt = apply_swaps_local(bt, L["hp_lo"], L["hp_hi"], far2, near2, ok2)
    return bt, {s: d1[s] + d2[s] for s in d1}, ((far, near, ok1), (far2, near2, ok2))


def _autonuma_prepare(cfg: GpacConfig, L: dict, budget: int, tiers=None) -> dict:
    _check_two_tier(cfg, tiers)
    b = _b(cfg, budget)
    kw = _cand_kw(L)
    valid = L["hp_ids"] >= 0
    alloc, in_near = L["alloc"], L["bt"] < cfg.n_near
    cnt = _i32(L["hc"])
    victim = torch.where(alloc, _i32(L["lt"]), NEG + 1)
    return dict(cands=dict(
        fault=nominate(valid & alloc & ~in_near & (cnt >= 2), cnt, b, **kw),
        # nominated under the pressured superset mask; ``apply`` filters
        # once ``pressured`` is known
        victim=nominate(valid & in_near, -victim, b, **kw),
    ), sums=dict(near_used=_i32((valid & alloc & in_near).sum())))


def _autonuma_apply(cfg: GpacConfig, L: dict, merged: dict, budget: int,
                    pressure: float = 0.95, tiers=None):
    _check_two_tier(cfg, tiers)
    b = _b(cfg, budget)
    C = {k: _flat_cands(v) for k, v in merged["cands"].items()}
    pressured = merged["sums"]["near_used"] >= int(pressure * cfg.n_near)
    far = rank_select(C["fault"], b)
    vic = C["victim"]
    vv = torch.where((vic["id"] >= 0) & ((vic["alloc"] == 0) | pressured), vic["val"], NEG)
    near = rank_select({**vic, "val": _i32(vv)}, b)
    ok, d = swap_outcome(cfg, far, near, _pair_k(far, near))
    bt = apply_swaps_local(L["bt"], L["hp_lo"], L["hp_hi"], far, near, ok)
    return bt, d, ((far, near, ok),)


def _tpp_prepare(cfg: GpacConfig, L: dict, budget: int, tiers=None) -> dict:
    _check_two_tier(cfg, tiers)
    b = _b(cfg, budget)
    kw = _cand_kw(L)
    valid = L["hp_ids"] >= 0
    alloc, in_near = L["alloc"], L["bt"] < cfg.n_near
    cnt = _i32(L["hc"])
    lru = _i32(L["lt"])
    zero = torch.zeros_like(cnt)
    return dict(cands=dict(
        free_far=nominate(valid & ~in_near & ~alloc, zero, b, **kw),
        near_lru=nominate(valid & in_near & alloc, -lru, b, **kw),
        fault=nominate(valid & alloc & ~in_near & (cnt >= 2), cnt, b, **kw),
        free_near=nominate(valid & in_near & ~alloc, zero, b, **kw),
    ), sums=dict(
        free_near=_i32((valid & in_near & ~alloc).sum()),
        demand=_i32((valid & alloc & ~in_near & (cnt >= 2)).sum()),
    ))


def _tpp_apply(cfg: GpacConfig, L: dict, merged: dict, budget: int,
               watermark: float = 0.1, tiers=None):
    _check_two_tier(cfg, tiers)
    b = _b(cfg, budget)
    C = {k: _flat_cands(v) for k, v in merged["cands"].items()}
    want_free = int(watermark * cfg.n_near)
    demand = merged["sums"]["demand"]
    need = torch.maximum(demand.clamp(max=want_free), demand.clamp(max=budget))
    n_demote = (need - merged["sums"]["free_near"]).clamp(0, budget)
    # round 1: watermark demotion (coldest allocated near <-> free far)
    farD = rank_select(C["free_far"], b)
    nearD = rank_select(C["near_lru"], b)
    ok1, d1 = swap_outcome(cfg, farD, nearD, torch.minimum(_pair_k(farD, nearD), n_demote))
    bt = apply_swaps_local(L["bt"], L["hp_lo"], L["hp_hi"], farD, nearD, ok1)

    # round 2: fault promotion into the freed space (post-swap masks)
    def after(c):
        return {**c, "slot": slots_after_swaps(c["id"], c["slot"], farD, nearD, ok1)}

    A2 = _concat_cands(after(C["fault"]), after(nearD))
    A2["val"] = _i32(torch.where(
        (A2["id"] >= 0) & (A2["alloc"] > 0) & (A2["slot"] >= cfg.n_near) & (A2["cnt"] >= 2),
        A2["cnt"], NEG))
    B2 = _concat_cands(after(C["free_near"]), after(farD))
    B2["val"] = _i32(torch.where(
        (B2["id"] >= 0) & (B2["alloc"] == 0) & (B2["slot"] < cfg.n_near), 0, NEG))
    far2 = rank_select(A2, b)
    near2 = rank_select(B2, b)
    ok2, d2 = swap_outcome(cfg, far2, near2, _pair_k(far2, near2))
    bt = apply_swaps_local(bt, L["hp_lo"], L["hp_hi"], far2, near2, ok2)
    return bt, {s: d1[s] + d2[s] for s in d1}, ((farD, nearD, ok1), (far2, near2, ok2))


_SHARDED_TICKS: dict[str, tuple[Callable, Callable]] = {}


def register_sharded_tick(name: str, prepare: Callable, apply: Callable):
    """Register a host-partitioned (prepare, apply) tick for policy ``name``.
    Policies without one run everywhere except
    ``engine.run_sharded(host_sharded=True)``."""
    if name in _SHARDED_TICKS:
        raise ValueError(f"sharded tick for policy {name!r} already registered")
    _SHARDED_TICKS[name] = (prepare, apply)


def sharded_ticks() -> tuple[str, ...]:
    """Names of policies with a host-partitioned tick."""
    return tuple(_SHARDED_TICKS)


def sharded_tick_fns(name: str) -> tuple[Callable, Callable]:
    try:
        return _SHARDED_TICKS[name]
    except KeyError:
        raise ValueError(
            f"tiering policy {name!r} has no host-partitioned tick (have "
            f"{sharded_ticks()}); register one with tiering."
            f"register_sharded_tick or run with host_sharded=False") from None


register_sharded_tick("memtierd", _memtierd_prepare, _memtierd_apply)
register_sharded_tick("autonuma", _autonuma_prepare, _autonuma_apply)
register_sharded_tick("tpp", _tpp_prepare, _tpp_apply)
