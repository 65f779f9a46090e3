"""GPAC orchestration, paper Fig. 5: telemetry -> filter -> consolidate
(port of ``repro.core.gpac``: one daemon's pass, the batched passes and the
single-guest window drivers).

``run_windows`` is the deprecated shim over ``engine.run`` with the
``snapshot`` collector, so its ``near_capacity_used`` rounds as the
reference's jitted collector does; ``run_windows_reference`` keeps the seed
per-window loop over ``metrics.snapshot``, which divides exactly as eager
JAX does. The two can differ by one ulp where ``n_near`` is not a power of
two, as they do in the reference.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core import address_space as asp
from repro_torch.core import consolidator, filter as pfilter, metrics, telemetry, tiering
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


def gpac_maintenance_batched(
    cfg: GpacConfig,
    state: TieredState,
    backend: str,
    max_batches: int,
    cl: int | None,
    n_guests: int,
    logical_per_guest: int,
    hp_per_guest: int,
) -> TieredState:
    """Deprecated symmetric wrapper over :func:`gpac_maintenance_ragged`."""
    from repro_torch.core.engine import symmetric_spec

    if n_guests * logical_per_guest != cfg.n_logical:
        raise ValueError("guest logical segments must tile the logical space")
    if n_guests * hp_per_guest != cfg.n_gpa_hp:
        raise ValueError("guest GPA segments must tile the GPA space")
    spec = symmetric_spec(cfg, n_guests, cl=cl)
    return gpac_maintenance_ragged(spec, state, backend, max_batches)


def window_step(
    cfg: GpacConfig,
    state: TieredState,
    accesses: torch.Tensor,
    policy: str = "memtierd",
    backend: str = "ipt",
    use_gpac: bool = True,
    max_batches: int = 8,
    budget: int = 64,
) -> TieredState:
    """One single-guest telemetry window: record accesses, run GPAC, run the
    host tier tick, roll the window (``accesses`` on the state's device)."""
    state = asp.record_accesses(cfg, state, accesses)
    if use_gpac:
        state = gpac_maintenance(cfg, state, backend, max_batches)
    state = tiering.tick(cfg, state, policy, budget=budget)
    return telemetry.end_window(cfg, state)


def run_windows(
    cfg: GpacConfig,
    state: TieredState,
    trace,
    policy: str = "memtierd",
    backend: str = "ipt",
    use_gpac: bool = True,
    max_batches: int = 8,
    budget: int = 64,
    windows_per_step: int = 0,
    device=None,
) -> tuple[TieredState, list[dict]]:
    """Drive an ``(n_windows, accesses_per_window)`` single-guest trace
    through ``engine.run``, one ``metrics.snapshot``-keyed dict per window.

    Deprecation shim: call ``engine.run`` with
    ``engine.spec_from_config(cfg)`` and the ``snapshot`` collector."""
    from repro_torch.core import engine

    warnings.warn(
        "gpac.run_windows is deprecated; use repro_torch.core.engine.run with"
        " engine.spec_from_config(cfg) and the 'snapshot' collector",
        DeprecationWarning,
        stacklevel=2,
    )
    trace = np.asarray(trace)
    n_w = trace.shape[0]
    if n_w == 0:
        return state, []
    state, host = engine.run(
        engine.spec_from_config(cfg), state, trace[None],
        policy=policy, backend=backend, use_gpac=use_gpac,
        max_batches=max_batches, budget=budget,
        windows_per_step=windows_per_step, collect=("snapshot",), device=device,
    )
    series = [
        {k: (float(v[w]) if k in metrics.FLOAT_METRICS else int(v[w]))
         for k, v in host.items()}
        for w in range(n_w)
    ]
    return state, series


def run_windows_reference(
    cfg: GpacConfig,
    state: TieredState,
    trace,
    device=None,
    **kw,
) -> tuple[TieredState, list[dict]]:
    """The seed per-window loop (one host sync per window): the equivalence
    oracle for :func:`run_windows`. The state must live on ``device`` (CUDA
    unless named)."""
    from repro_torch.core import engine

    dev = engine._check_device(state, device)
    trace = torch.as_tensor(np.asarray(trace), dtype=torch.int32).to(dev)
    series = []
    for w in range(trace.shape[0]):
        state = window_step(cfg, state, trace[w], **kw)
        series.append(metrics.snapshot(cfg, state))
    return state, series
