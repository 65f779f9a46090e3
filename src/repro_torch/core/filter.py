"""Scattered Page Filter, paper §4.3.1 (port of ``repro.core.filter``).

A hot base page is a consolidation candidate iff the huge page it occupies
holds fewer than CL hot subpages and is not a region consolidated within the
cooldown. :func:`select_batches` serves one daemon (the serving engine runs
one per sequence); the batched multi-tenant form ranks every guest's
candidates with one row-wise top-k over the padded
``[n_guests, max_logical]`` score matrix built from the segment tables. Both
rank through the topk_rows kernel, whose ties go to the lowest index as
``lax.top_k``'s do.
"""
from __future__ import annotations

import torch

from repro_torch.core import telemetry
from repro_torch.core.types import GpacConfig, TieredState
from repro_torch.kernels import registry as kernels


def candidate_mask(
    cfg: GpacConfig,
    state: TieredState,
    hot: torch.Tensor,
    cl: int | torch.Tensor | None = None,
    allow: torch.Tensor | None = None,
    kernel_backend: str = "auto",
) -> torch.Tensor:
    """bool[n_logical]: hot pages in skewed (< CL hot subpages) huge pages
    that are not inside a cooling region (optionally only where ``allow``)."""
    cl = cfg.cl if cl is None else cl
    per_hp = telemetry.hot_subpages_per_hp(cfg, state, hot, kernel_backend)
    hp_of = state.gpt // cfg.hp_ratio
    hot_in_hp = per_hp[hp_of]
    skewed = (hot_in_hp > 0) & (hot_in_hp < cl)
    region_epoch = state.region_epoch[hp_of]
    cooling = (region_epoch >= 0) & (
        state.epoch - region_epoch < cfg.reconsolidate_cooldown)
    out = hot & skewed & ~cooling
    if allow is not None:
        out = out & allow
    return out


def select_batches(
    cfg: GpacConfig,
    state: TieredState,
    hot: torch.Tensor,
    max_batches: int,
    cl: int | None = None,
    allow: torch.Tensor | None = None,
    kernel_backend: str = "auto",
):
    """Up to ``max_batches * hp_ratio`` candidates, hottest first, as
    ``(int32[max_batches, hp_ratio] ids padded with -1, int32[max_batches]
    counts)``. The ranking is one row of the topk_rows kernel: most scores
    tie at -1, and ``torch.topk`` would not break those ties by index."""
    cand = candidate_mask(cfg, state, hot, cl, allow, kernel_backend)
    score = torch.where(cand, _hotness_score(state), -1)
    k = min(max_batches * cfg.hp_ratio, cfg.n_logical)
    vals, top_ids = kernels.dispatch("topk_rows", kernel_backend, score[None], k)
    ids = torch.where(vals[0] >= 0, top_ids[0], -1)
    pad = max_batches * cfg.hp_ratio - k
    if pad:
        ids = torch.cat([ids, torch.full((pad,), -1, dtype=torch.int32, device=ids.device)])
    batches = ids.view(max_batches, cfg.hp_ratio)
    return batches, (batches >= 0).sum(dim=1, dtype=torch.int32)


def _hotness_score(state: TieredState) -> torch.Tensor:
    """int32 ranking: current-window count first, history popcount next."""
    return state.guest_counts * 256 + telemetry._popcount_u8(state.ipt_hist)


def candidate_score(
    cfg: GpacConfig,
    state: TieredState,
    hot: torch.Tensor,
    cl_per_logical: torch.Tensor,
    kernel_backend: str = "auto",
) -> torch.Tensor:
    """int32[n_logical]: the hotness score where :func:`candidate_mask`
    holds (per-guest CLs), -1 elsewhere."""
    cand = candidate_mask(cfg, state, hot, cl_per_logical,
                          kernel_backend=kernel_backend)
    return torch.where(cand, _hotness_score(state), -1)


def select_batches_from_rows(
    cfg: GpacConfig,
    score: torch.Tensor,  # int32[n_logical], -1 = not a candidate
    pad_idx: torch.Tensor,  # int32[n_rows, max_logical] segment rows, -1 padded
    max_batches: int,
    kernel_backend: str = "auto",
) -> torch.Tensor:
    """int32[n_rows, max_batches, hp_ratio] logical-id batches, -1 padded:
    each row's top ``max_batches * hp_ratio`` candidates, ties to the lowest
    column."""
    mat = torch.where(pad_idx >= 0, score[pad_idx.clamp(min=0)], -1)
    n_rows = mat.shape[0]
    k = min(max_batches * cfg.hp_ratio, mat.shape[1])
    vals, col = kernels.dispatch("topk_rows", kernel_backend, mat, k)
    ids = torch.where(vals >= 0, torch.gather(pad_idx, 1, col.long()), -1)
    pad = max_batches * cfg.hp_ratio - k
    if pad:
        ids = torch.cat(
            [ids, torch.full((n_rows, pad), -1, dtype=torch.int32,
                             device=ids.device)], dim=1)
    return ids.view(n_rows, max_batches, cfg.hp_ratio)


def select_batches_ragged(
    spec,  # repro_torch.core.engine.EngineSpec
    state: TieredState,
    hot: torch.Tensor,
    max_batches: int,
) -> torch.Tensor:
    """Every guest's batches at once, from the spec's segment tables:
    int32[n_guests, max_batches, hp_ratio]."""
    tables = spec.tables(state.device)
    score = candidate_score(spec.cfg, state, hot, tables.cl_per_logical,
                            spec.kernel_backend)
    return select_batches_from_rows(
        spec.cfg, score, tables.logical_pad, max_batches, spec.kernel_backend)


def select_batches_per_guest(
    cfg: GpacConfig,
    state: TieredState,
    hot: torch.Tensor,
    max_batches: int,
    cl: int | None,
    n_guests: int,
    logical_per_guest: int,
) -> torch.Tensor:
    """Deprecated symmetric wrapper over :func:`select_batches_ragged` (kept
    for the old ``MultiGuest`` entry points)."""
    from repro_torch.core.engine import symmetric_spec

    if n_guests * logical_per_guest != cfg.n_logical:
        raise ValueError("guest logical segments must tile the logical space")
    return select_batches_ragged(
        symmetric_spec(cfg, n_guests, cl=cl), state, hot, max_batches)
