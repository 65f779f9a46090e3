"""GPAC orchestration, paper Fig. 5: telemetry -> filter -> consolidate
(port of ``repro.core.gpac``: one daemon's pass and the batched passes)."""
from __future__ import annotations

import torch

from repro_torch.core import consolidator, filter as pfilter, telemetry
from repro_torch.core.types import GpacConfig, TieredState


def gpac_maintenance(
    cfg: GpacConfig,
    state: TieredState,
    backend: str = "ipt",
    max_batches: int = 8,
    cl: int | None = None,
    allow: torch.Tensor | None = None,
    hp_range: tuple | None = None,
    kernel_backend: str = "auto",
) -> TieredState:
    """One guest daemon's pass: classify hotness, filter scattered hot pages,
    consolidate them batch by batch. ``allow`` / ``hp_range`` confine it to
    one guest's logical pages and GPA segment."""
    hot = telemetry.hot_mask(cfg, state, backend)
    batches, _ = pfilter.select_batches(
        cfg, state, hot, max_batches, cl, allow, kernel_backend)
    return consolidator.consolidate_batches(cfg, state, batches, hp_range, kernel_backend)


def gpac_maintenance_ragged(
    spec,  # repro_torch.core.engine.EngineSpec
    state: TieredState,
    backend: str = "ipt",
    max_batches: int = 8,
) -> TieredState:
    """All N guest daemons' GPAC passes in one batched invocation over the
    spec's segment tables (ragged guests, per-guest CLs)."""
    tables = spec.tables(state.device)
    return gpac_maintenance_rows(
        spec.cfg, state, backend, max_batches, tables.cl_per_logical,
        tables.logical_pad, tables.hp_pad, spec.kernel_backend)


def gpac_maintenance_rows(
    cfg: GpacConfig,
    state: TieredState,
    backend: str,
    max_batches: int,
    cl_per_logical: torch.Tensor,  # int32[n_logical]
    pad_idx: torch.Tensor,  # int32[n_rows, max_logical] logical segment rows
    hp_pad_idx: torch.Tensor,  # int32[n_rows, max_hp] GPA segment rows
    kernel_backend: str = "auto",
) -> TieredState:
    """GPAC passes for a slice of guest segment rows: classify, score, rank
    each row (top-k), then ``max_batches`` consolidation rounds."""
    hot = telemetry.hot_mask(cfg, state, backend)
    score = pfilter.candidate_score(cfg, state, hot, cl_per_logical, kernel_backend)
    batches = pfilter.select_batches_from_rows(
        cfg, score, pad_idx, max_batches, kernel_backend)
    return consolidator.consolidate_rounds(
        cfg, state, batches, hp_pad_idx, kernel_backend)
