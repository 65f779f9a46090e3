"""Page Consolidator, paper §4.3.2 Algorithm 1 (port of
``repro.core.consolidator``).

``consolidate_pages`` moves up to ``hp_ratio`` base pages into one fully
free huge-page region and rewrites the logical->gpa mapping; the ragged
forms run one Algorithm-1 invocation per guest at once, round by round, over
the engine's segment tables. The payload copy gathers straight out of
whichever pool holds each source page (the gather_rows kernel) -- never out
of a concatenation of the pools.

The ``_local`` forms run the same rounds on a host-partitioned rank, whose
payload is stored per huge page (``core.sharding``).

In place: the mapping tables, ``region_epoch`` and both pools are written in
the state handed in (see ``core.types``). The payload is gathered before
either pool is written, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import address_space as asp
from repro_torch.core.types import FREE, GpacConfig, TieredState
from repro_torch.kernels import registry as kernels


def _mapping_and_stats(
    cfg: GpacConfig,
    gpt: torch.Tensor,
    rmap: torch.Tensor,
    stats: dict,
    pages: torch.Tensor,
    safe_pages: torch.Tensor,
    old_gpa: torch.Tensor,
    new_gpa: torch.Tensor,
    do_move: torch.Tensor,
    ok: torch.Tensor,
    n_sel: torch.Tensor,
):
    """Algorithm-1 steps 3/5 (in place on ``gpt``/``rmap``) and the stats."""
    moving = do_move.nonzero(as_tuple=True)  # one device sync for the masks
    gpt[pages[moving]] = new_gpa[moving]
    rmap[old_gpa[moving]] = FREE
    rmap[new_gpa[moving]] = safe_pages[moving]
    moved_per_row = do_move.sum(dim=1)
    moved = moved_per_row.sum().to(torch.int32)
    calls = n_sel > 0

    def count(mask):
        return mask.sum().to(torch.int32)

    stats = dict(stats)
    stats["consolidated_pages"] = stats["consolidated_pages"] + moved
    stats["consolidation_calls"] = stats["consolidation_calls"] + count(calls)
    stats["consolidation_enomem"] = stats["consolidation_enomem"] + count(calls & ~ok)
    stats["copied_bytes"] = stats["copied_bytes"] + moved * cfg.base_bytes
    stats["tlb_shootdowns"] = stats["tlb_shootdowns"] + count(moved_per_row > 0)
    return gpt, rmap, stats


def _apply_consolidation(
    cfg: GpacConfig,
    state: TieredState,
    pages: torch.Tensor,  # int32[n, hp_ratio] logical ids, -1 padded
    region: torch.Tensor,  # int32[n] fresh region per row, -1 = -ENOMEM
    kernel_backend: str = "auto",
) -> TieredState:
    """``n`` independent Algorithm-1 invocations at once (rows touch
    disjoint pages and regions): copy each page's payload into its region
    slot, remap it, free the old gpa page."""
    valid = (pages >= 0) & (pages < cfg.n_logical)
    ok = region >= 0
    n_sel = valid.sum(dim=1)

    safe_pages = torch.where(valid, pages, 0)
    old_gpa = state.gpt[safe_pages]  # [n, hp_ratio]
    off = torch.arange(cfg.hp_ratio, dtype=torch.int32, device=pages.device)
    new_gpa = region[:, None] * cfg.hp_ratio + off
    do_move = valid & ok[:, None]

    # ---- 2. data copy: gather from each pool, then scatter -------------
    near_rows_n = cfg.n_near * cfg.hp_ratio
    src_slot = state.block_table[old_gpa // cfg.hp_ratio]
    src_flat = torch.where(do_move, src_slot * cfg.hp_ratio + old_gpa % cfg.hp_ratio, 0)
    src_is_near = src_flat < near_rows_n
    near_rows = state.near_pool.view(-1, cfg.base_elems)
    far_rows = state.far_pool.view(-1, cfg.base_elems)
    payload = torch.where(
        src_is_near[..., None],
        kernels.dispatch("gather_rows", kernel_backend, near_rows,
                         torch.where(src_is_near, src_flat, 0)),
        kernels.dispatch("gather_rows", kernel_backend, far_rows,
                         torch.where(src_is_near, 0, src_flat - near_rows_n)),
    )  # [n, hp_ratio, base_elems]

    dst_slot = state.block_table[region.clamp(min=0)][:, None].expand_as(pages)
    dst_off = off.expand_as(pages)
    to_near = (do_move & (dst_slot < cfg.n_near)).nonzero(as_tuple=True)
    to_far = (do_move & (dst_slot >= cfg.n_near)).nonzero(as_tuple=True)
    state.near_pool[dst_slot[to_near], dst_off[to_near]] = payload[to_near]
    state.far_pool[dst_slot[to_far] - cfg.n_near, dst_off[to_far]] = payload[to_far]

    # ---- 3/5. mapping updates (row-disjoint scatters) ------------------
    state.region_epoch[region[ok]] = state.epoch
    gpt, rmap, stats = _mapping_and_stats(
        cfg, state.gpt, state.rmap, state.stats, pages, safe_pages, old_gpa,
        new_gpa, do_move, ok, n_sel,
    )
    return dataclasses.replace(state, gpt=gpt, rmap=rmap, stats=stats)


def consolidate_pages(
    cfg: GpacConfig, state: TieredState, pages: torch.Tensor,
    hp_range: tuple | None = None, kernel_backend: str = "auto",
) -> TieredState:
    """One Algorithm-1 invocation: ``pages`` int32[hp_ratio], -1 padded,
    packed in order into the first free region (within ``hp_range``)."""
    pages = pages.to(torch.int32)
    if pages.shape != (cfg.hp_ratio,):
        raise ValueError(f"pages must be int32[{cfg.hp_ratio}]")
    region = asp.alloc_free_huge_region(cfg, state, hp_range)
    return _apply_consolidation(cfg, state, pages[None, :], region[None],
                                kernel_backend)


def consolidate_batches(
    cfg: GpacConfig, state: TieredState, batches: torch.Tensor,
    hp_range: tuple | None = None, kernel_backend: str = "auto",
) -> TieredState:
    """Algorithm 1 once per batch row, in row order (the paper's "multiple
    invocations are required" loop)."""
    for row in batches:
        state = consolidate_pages(cfg, state, row, hp_range, kernel_backend)
    return state


def _alloc_regions_ragged(
    cfg: GpacConfig, rmap: torch.Tensor, hp_pad_idx: torch.Tensor,
) -> torch.Tensor:
    """int32[n_rows]: each row's first fully free huge page from its padded
    GPA segment row, -1 = -ENOMEM."""
    free = (rmap.view(cfg.n_gpa_hp, cfg.hp_ratio) == FREE).all(dim=1)
    fp = (hp_pad_idx >= 0) & free[hp_pad_idx.clamp(min=0)]
    # argmax of uint8 returns the first maximum, i.e. the first free page
    first = torch.argmax(fp.to(torch.uint8), dim=1)
    region = torch.gather(hp_pad_idx, 1, first[:, None])[:, 0]
    return torch.where(fp.any(dim=1), region, -1)


def consolidate_pages_ragged(spec, state: TieredState, pages: torch.Tensor) -> TieredState:
    """One round: every guest's Algorithm-1 invocation at once
    (``pages`` int32[n_guests, hp_ratio])."""
    cfg = spec.cfg
    pages = pages.to(torch.int32)
    if pages.shape != (spec.n_guests, cfg.hp_ratio):
        raise ValueError(
            f"pages must be int32[{spec.n_guests}, {cfg.hp_ratio}], got "
            f"{tuple(pages.shape)}")
    region = _alloc_regions_ragged(
        cfg, state.rmap, spec.tables(state.device).hp_pad)
    return _apply_consolidation(cfg, state, pages, region, spec.kernel_backend)


def consolidate_rounds(
    cfg: GpacConfig,
    state: TieredState,
    batches: torch.Tensor,  # int32[n_rows, max_batches, hp_ratio]
    hp_pad_idx: torch.Tensor,  # int32[n_rows, max_hp] GPA segment rows
    kernel_backend: str = "auto",
) -> TieredState:
    """Round-major consolidation: round b allocates each row's region from
    its own segment and runs every row's b-th invocation at once."""
    for b in range(batches.shape[1]):
        region = _alloc_regions_ragged(cfg, state.rmap, hp_pad_idx)
        state = _apply_consolidation(
            cfg, state, batches[:, b].to(torch.int32), region, kernel_backend)
    return state


def consolidate_batches_ragged(spec, state: TieredState, batches: torch.Tensor) -> TieredState:
    """Every guest's batches (int32[n_guests, max_batches, hp_ratio]),
    round-major."""
    return consolidate_rounds(
        spec.cfg, state, batches, spec.tables(state.device).hp_pad,
        spec.kernel_backend)


def _uniform_hp_pad(cfg: GpacConfig, n_guests: int, hp_per_guest: int,
                    device) -> torch.Tensor:
    """Segment table for N equal GPA segments (the old ``*_multi`` contract:
    only the GPA space must tile; the logical space is unconstrained)."""
    if n_guests * hp_per_guest != cfg.n_gpa_hp:
        raise ValueError("guest GPA segments must tile the GPA space")
    return torch.arange(cfg.n_gpa_hp, dtype=torch.int32, device=device).view(
        n_guests, hp_per_guest)


def consolidate_pages_multi(
    cfg: GpacConfig, state: TieredState, pages: torch.Tensor, hp_per_guest: int,
) -> TieredState:
    """Deprecated symmetric wrapper: one round over N equal GPA segments
    (``pages`` int32[n_guests, hp_ratio])."""
    hp_pad = _uniform_hp_pad(cfg, pages.shape[0], hp_per_guest, state.device)
    region = _alloc_regions_ragged(cfg, state.rmap, hp_pad)
    return _apply_consolidation(cfg, state, pages.to(torch.int32), region)


def consolidate_batches_multi(
    cfg: GpacConfig, state: TieredState, batches: torch.Tensor, hp_per_guest: int,
) -> TieredState:
    """Deprecated symmetric wrapper: rounds over N equal GPA segments
    (``batches`` int32[n_guests, max_batches, hp_ratio])."""
    hp_pad = _uniform_hp_pad(cfg, batches.shape[0], hp_per_guest, state.device)
    return consolidate_rounds(cfg, state, batches, hp_pad)


# --------------------------------------------------------------------------
# host-partitioned rounds (payload owned by its huge page, no slot pools)
# --------------------------------------------------------------------------
def _apply_consolidation_local(
    cfg: GpacConfig,
    gpt: torch.Tensor,
    rmap: torch.Tensor,
    data: torch.Tensor,  # dtype[h_loc, hp_ratio, base_elems] hp-owned payload
    re_loc: torch.Tensor,  # int32[h_loc] local region_epoch rows
    epoch: torch.Tensor,
    stats: dict,
    pages: torch.Tensor,  # int32[n, hp_ratio] logical ids, -1 padded
    region: torch.Tensor,  # int32[n] fresh region per row, -1 = -ENOMEM
    hp_lo: int,  # first huge page of this rank's block range
    kernel_backend: str = "auto",
):
    """:func:`_apply_consolidation` on the host-partitioned layout, in place
    on ``gpt``, ``rmap``, ``data`` and ``re_loc``. Huge page ``h`` lives at
    ``data[h - hp_lo]``, the replicated state's ``pools[block_table[h]]``,
    so gathering the source pages by huge page and writing the region's row
    is the replicated copy bit for bit. Sources and regions lie in the
    calling guest's own GPA segment, inside this rank's range."""
    valid = (pages >= 0) & (pages < cfg.n_logical)
    ok = region >= 0
    n_sel = valid.sum(dim=1)

    safe_pages = torch.where(valid, pages, 0)
    old_gpa = gpt[safe_pages]  # [n, hp_ratio]
    off = torch.arange(cfg.hp_ratio, dtype=torch.int32, device=pages.device)
    new_gpa = region[:, None] * cfg.hp_ratio + off
    do_move = valid & ok[:, None]

    # the copy: a flat row gather (the gather_rows kernel), then the
    # region's rows; gathered before anything is written
    h_loc = data.shape[0]
    src_row = torch.where(do_move, old_gpa // cfg.hp_ratio - hp_lo, 0).clamp(0, h_loc - 1)
    flat_rows = data.view(h_loc * cfg.hp_ratio, cfg.base_elems)
    payload = kernels.dispatch("gather_rows", kernel_backend, flat_rows,
                               src_row * cfg.hp_ratio + old_gpa % cfg.hp_ratio)
    moving = do_move.nonzero(as_tuple=True)
    dst_row = (region[:, None] - hp_lo).expand_as(pages)
    data[dst_row[moving], off.expand_as(pages)[moving]] = payload[moving]
    re_loc[region[ok] - hp_lo] = epoch
    gpt, rmap, stats = _mapping_and_stats(
        cfg, gpt, rmap, stats, pages, safe_pages, old_gpa, new_gpa, do_move, ok, n_sel)
    return gpt, rmap, data, re_loc, stats


def consolidate_rounds_local(
    cfg: GpacConfig,
    gpt: torch.Tensor,
    rmap: torch.Tensor,
    data: torch.Tensor,
    re_loc: torch.Tensor,
    epoch: torch.Tensor,
    stats: dict,
    batches: torch.Tensor,  # int32[n_rows, max_batches, hp_ratio]
    hp_pad_idx: torch.Tensor,  # int32[n_rows, max_hp] this rank's GPA rows
    hp_lo: int,
    kernel_backend: str = "auto",
):
    """:func:`consolidate_rounds` for the host-partitioned engine: round-major
    Algorithm-1 invocations over this rank's own guest rows, the copy on the
    hp-owned payload ``data`` instead of the slot pools."""
    for b in range(batches.shape[1]):
        region = _alloc_regions_ragged(cfg, rmap, hp_pad_idx)
        gpt, rmap, data, re_loc, stats = _apply_consolidation_local(
            cfg, gpt, rmap, data, re_loc, epoch, stats, batches[:, b].to(torch.int32),
            region, hp_lo, kernel_backend)
    return gpt, rmap, data, re_loc, stats
