"""Deprecated multi-tenant simulation surface, symmetric guests only (port of
``repro.core.simulate``).

:mod:`repro_torch.core.engine` is the simulation API. What stays here is

* the deprecation shims (:class:`MultiGuest`, :func:`make_multi_guest`,
  :func:`multi_guest_window`, :func:`run_multi_guest`), which map the old
  symmetric-tiling API onto an :class:`~repro_torch.core.engine.EngineSpec`;
* the seed-equivalent reference path (:func:`multi_guest_window_reference`,
  :func:`run_multi_guest_reference`): the per-guest, per-window formulation
  that the engine is held to bit for bit and that the engine benchmark
  times the engine's speedup against. It runs through the kernels on CUDA,
  as the engine does.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core import engine, metrics
from repro_torch.core.types import GpacConfig, TieredState


@dataclasses.dataclass(frozen=True)
class MultiGuest:
    """Geometry of N symmetric guests packed into one host block space.

    Deprecated: use :class:`repro_torch.core.engine.GuestSpec` /
    :func:`repro_torch.core.engine.build`, which also cover ragged guests.
    """

    cfg: GpacConfig  # combined space
    n_guests: int
    logical_per_guest: int
    hp_per_guest: int

    def logical_range(self, g: int) -> tuple[int, int]:
        return g * self.logical_per_guest, (g + 1) * self.logical_per_guest

    def hp_range(self, g: int) -> tuple[int, int]:
        return g * self.hp_per_guest, (g + 1) * self.hp_per_guest

    def localize(self, g: int, local_ids: torch.Tensor) -> torch.Tensor:
        """Guest-local logical page ids -> combined-space ids (-1 passes)."""
        lo, _ = self.logical_range(g)
        return torch.where(local_ids >= 0, local_ids + lo, -1)

    def localize_all(self, local_ids: torch.Tensor) -> torch.Tensor:
        """Batched :meth:`localize`: ``int32[n_guests, k]`` at once."""
        return self.spec().localize(local_ids)

    def spec(self, cl: int | None = None) -> engine.EngineSpec:
        """The equivalent :class:`~repro_torch.core.engine.EngineSpec`."""
        return engine.symmetric_spec(self.cfg, self.n_guests, cl=cl)


def make_multi_guest(
    n_guests: int,
    logical_per_guest: int,
    hp_ratio: int,
    near_fraction: float,
    gpa_slack: float = 0.25,
    device=None,
    **cfg_kw,
) -> tuple[MultiGuest, TieredState]:
    """Build N symmetric guests over one host space on ``device`` (CUDA
    unless named); deprecated shim over :func:`engine.build`."""
    warnings.warn(
        "simulate.make_multi_guest is deprecated; use repro_torch.core.engine."
        "build (GuestSpec/HostSpec geometry, also covers ragged guests)",
        DeprecationWarning,
        stacklevel=2,
    )
    host = engine.HostSpec(
        hp_ratio=hp_ratio,
        near_fraction=near_fraction,
        **{k: cfg_kw.pop(k) for k in tuple(cfg_kw) if k in (
            "base_elems", "cl", "hot_threshold", "ipt_windows", "ipt_min_hits",
            "reconsolidate_cooldown", "dtype",
        )},
    )
    if cfg_kw:
        raise TypeError(f"unknown config keywords {sorted(cfg_kw)}")
    guests = tuple(
        engine.GuestSpec(n_logical=logical_per_guest, gpa_slack=gpa_slack, seed=g)
        for g in range(n_guests))
    spec, state = engine.build(guests, host, device=device)
    mg = MultiGuest(spec.cfg, n_guests, logical_per_guest, spec.cfg.n_gpa_hp // n_guests)
    return mg, state


# --------------------------------------------------------------------------
# deprecated engine entry points (shims over repro_torch.core.engine)
# --------------------------------------------------------------------------
def multi_guest_window(
    mg: MultiGuest,
    state: TieredState,
    accesses: torch.Tensor,  # int32[n_guests, k] guest-LOCAL page ids, -1 padded
    policy: str = "memtierd",
    backend: str = "ipt",
    use_gpac: bool = True,
    max_batches: int = 4,
    budget: int = 64,
    cl: int | None = None,
) -> tuple[TieredState, dict]:
    """One window for all guests and one host tier tick (deprecated shim
    over :func:`engine.step`)."""
    warnings.warn(
        "simulate.multi_guest_window is deprecated; use repro_torch.core.engine.step",
        DeprecationWarning,
        stacklevel=2,
    )
    return engine.step(
        mg.spec(cl), state, accesses, policy=policy, backend=backend,
        use_gpac=use_gpac, max_batches=max_batches, budget=budget,
        collect=("hits", "near_blocks"))


def run_multi_guest(
    mg: MultiGuest,
    state: TieredState,
    traces: np.ndarray,  # int32[n_guests, n_windows, k] guest-local ids
    tier_pair: str = "dram_nvmm",
    policy: str = "memtierd",
    backend: str = "ipt",
    use_gpac: bool = True,
    max_batches: int = 4,
    budget: int = 64,
    cl: int | None = None,
    windows_per_step: int = 0,
    device=None,
) -> tuple[TieredState, dict]:
    """Drive all windows through :func:`engine.run_series` (deprecated
    shim); returns the per-guest series the at-scale figures plot."""
    warnings.warn(
        "simulate.run_multi_guest is deprecated; use repro_torch.core.engine.run_series",
        DeprecationWarning,
        stacklevel=2,
    )
    return engine.run_series(
        mg.spec(cl), state, traces, tier_pair=tier_pair, policy=policy,
        backend=backend, use_gpac=use_gpac, max_batches=max_batches,
        budget=budget, windows_per_step=windows_per_step, device=device)


# --------------------------------------------------------------------------
# seed-equivalent reference path (per-guest / per-window formulation)
# --------------------------------------------------------------------------
def multi_guest_window_reference(
    mg: MultiGuest,
    state: TieredState,
    accesses: torch.Tensor,  # int32[n_guests, k] guest-LOCAL page ids, -1 padded
    policy: str = "memtierd",
    backend: str = "ipt",
    use_gpac: bool = True,
    max_batches: int = 4,
    budget: int = 64,
    cl: int | None = None,
) -> tuple[TieredState, dict]:
    """The seed's per-guest-loop window (every guest translates, records and
    runs its GPAC pass in turn, ``cl`` for every guest, then one host tick):
    :func:`engine.step_reference` over the equivalent spec. The equivalence
    oracle for :func:`multi_guest_window`."""
    return engine.step_reference(mg.spec(cl), state, accesses, policy, backend,
                                 use_gpac, max_batches, budget)


def run_multi_guest_reference(
    mg: MultiGuest,
    state: TieredState,
    traces: np.ndarray,  # int32[n_guests, n_windows, k] guest-local ids
    tier_pair: str = "dram_nvmm",
    device=None,
    **kw,
) -> tuple[TieredState, dict]:
    """The seed's per-window driver (one host sync per window): the
    equivalence oracle for :func:`run_multi_guest`. The state must live on
    ``device`` (CUDA unless named)."""
    dev = engine._check_device(state, device)
    traces = np.asarray(traces)
    n_g, n_w, _ = traces.shape
    series = dict(
        near_blocks=np.zeros((n_w, n_g), np.int64),
        hit_rate=np.zeros((n_w, n_g)),
        throughput=np.zeros((n_w, n_g)),
    )
    acc = torch.from_numpy(np.ascontiguousarray(
        np.transpose(traces, (1, 0, 2)), dtype=np.int32)).to(dev)
    for w in range(n_w):
        state, out = multi_guest_window_reference(mg, state, acc[w], **kw)
        nh = out["near_hits"].cpu().numpy().astype(np.float64)
        fh = out["far_hits"].cpu().numpy().astype(np.float64)
        hit, tput = metrics.throughput_from_hits(nh, fh, tier_pair)
        series["near_blocks"][w] = out["near_blocks"].cpu().numpy()
        series["hit_rate"][w] = hit
        series["throughput"][w] = tput
    return state, series
