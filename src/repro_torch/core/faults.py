"""Deterministic fault injection for the steady-state churn engine (port of
``repro.core.faults``).

A :class:`FaultSchedule` is an injectable, replayable list of events:

  * ``crash(w, g)``    -- guest ``g`` dies at window ``w``: its lane goes
    inactive and every block it holds is reclaimed (rmap freed, telemetry
    cleared, payload wiped) inside that same window;
  * ``restart(w, g)``  -- an inactive lane comes (back) up at window ``w``
    with a fresh identity mapping (``engine.init_engine_state``'s layout);
  * ``shrink(w, cap)`` -- the effective near-tier capacity becomes ``cap``
    blocks from window ``w`` on (``tiering.pressure_tick`` demotes down to
    it);
  * ``dropout(w)``     -- the telemetry of window ``w`` is lost.

Schedules compile (:meth:`FaultSchedule.tables`) into dense per-window
numpy :class:`FaultTables`; ``near_cap`` is an absolute step function, so
any chunking of the tables gives the same per-window values. The host side
is numpy, as in the reference, so a seeded :func:`poisson_churn` draws the
same schedule in both packages.

The device side is :func:`apply_guest_faults`: value-exact identity when
both rows are all-False. It writes the pools in place (see ``core.types``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.types import FREE, TieredState


# --------------------------------------------------------------------------
# host-side schedule
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultTables:
    """Dense per-window fault rows for ``n_windows`` absolute windows
    starting at ``start``."""

    start: int
    crash: np.ndarray  # bool[n_windows, n_guests]
    restart: np.ndarray  # bool[n_windows, n_guests]
    near_cap: np.ndarray  # int32[n_windows] absolute effective capacity
    drop: np.ndarray  # bool[n_windows] telemetry dropout

    @property
    def n_windows(self) -> int:
        return self.crash.shape[0]

    @property
    def n_guests(self) -> int:
        return self.crash.shape[1]


@dataclasses.dataclass
class FaultSchedule:
    """An ordered, replayable set of fault events over absolute windows.

    Builder methods chain: ``FaultSchedule(4).crash(2, 1).restart(5, 1)``.
    ``shrink`` events before the compiled range still apply (the capacity
    step function is cumulative)."""

    n_guests: int
    crashes: list = dataclasses.field(default_factory=list)  # (window, guest)
    restarts: list = dataclasses.field(default_factory=list)  # (window, guest)
    shrinks: list = dataclasses.field(default_factory=list)  # (window, cap)
    dropouts: list = dataclasses.field(default_factory=list)  # window

    def _check(self, window: int, guest: int | None = None):
        if window < 0:
            raise ValueError(f"fault window must be >= 0, got {window}")
        if guest is not None and not 0 <= guest < self.n_guests:
            raise ValueError(
                f"guest {guest} out of range [0, {self.n_guests})")

    def crash(self, window: int, guest: int) -> "FaultSchedule":
        self._check(window, guest)
        self.crashes.append((window, guest))
        return self

    def restart(self, window: int, guest: int) -> "FaultSchedule":
        self._check(window, guest)
        self.restarts.append((window, guest))
        return self

    def shrink(self, window: int, near_cap: int) -> "FaultSchedule":
        """Effective near capacity becomes ``near_cap`` blocks from
        ``window`` on (clamped to ``[0, cfg.n_near]`` at compile time; a
        later shrink event overrides -- growing back is allowed)."""
        self._check(window)
        if near_cap < 0:
            raise ValueError(f"near_cap must be >= 0, got {near_cap}")
        self.shrinks.append((window, near_cap))
        return self

    def dropout(self, window: int, n_windows: int = 1) -> "FaultSchedule":
        self._check(window)
        self.dropouts.extend(range(window, window + n_windows))
        return self

    @property
    def n_events(self) -> int:
        return (len(self.crashes) + len(self.restarts)
                + len(self.shrinks) + len(self.dropouts))

    def tables(self, n_windows: int, n_near: int, start: int = 0) -> FaultTables:
        """Compile to dense rows for absolute windows
        ``[start, start + n_windows)``. Guest events outside the range are
        dropped; ``shrink`` events at or before a window apply to it."""
        crash = np.zeros((n_windows, self.n_guests), bool)
        restart = np.zeros((n_windows, self.n_guests), bool)
        drop = np.zeros((n_windows,), bool)
        for w, g in self.crashes:
            if start <= w < start + n_windows:
                crash[w - start, g] = True
        for w, g in self.restarts:
            if start <= w < start + n_windows:
                restart[w - start, g] = True
        for w in self.dropouts:
            if start <= w < start + n_windows:
                drop[w - start] = True
        near_cap = np.full((n_windows,), n_near, np.int32)
        for w, cap in sorted(self.shrinks):  # later events override earlier
            lo = max(w - start, 0)
            if lo < n_windows:
                near_cap[lo:] = min(cap, n_near)
        return FaultTables(
            start=start, crash=crash, restart=restart,
            near_cap=near_cap, drop=drop,
        )


def no_faults(n_guests: int) -> FaultSchedule:
    """An empty schedule (compiles to all-no-op tables)."""
    return FaultSchedule(n_guests)


def poisson_churn(
    n_guests: int,
    n_windows: int,
    arrival_rate: float = 0.2,
    departure_rate: float = 0.02,
    seed: int = 0,
    initially_active: np.ndarray | None = None,
    start: int = 0,
) -> FaultSchedule:
    """A deterministic Poisson arrival/departure mix: per window, each
    active guest departs (crashes) with probability ``departure_rate`` and
    ``Poisson(arrival_rate)`` waiting lanes boot (restart), capped by the
    free lanes. Seeded numpy, the reference's draws in the same order."""
    rng = np.random.default_rng(seed)
    active = (np.ones(n_guests, bool) if initially_active is None
              else np.asarray(initially_active, bool).copy())
    sched = FaultSchedule(n_guests)
    for w in range(start, start + n_windows):
        leaving = np.nonzero(active & (rng.random(n_guests) < departure_rate))[0]
        for g in leaving:
            sched.crash(w, int(g))
            active[g] = False
        idle = np.nonzero(~active)[0]
        n_arrive = min(int(rng.poisson(arrival_rate)), idle.size)
        for g in rng.choice(idle, size=n_arrive, replace=False):
            sched.restart(w, int(g))
            active[g] = True
    return sched


# --------------------------------------------------------------------------
# device side
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def segment_tables(spec, device: torch.device) -> tuple:
    """Per-spec tables for vectorized fault application, as tensors on
    ``device``, built once per spec and device (like the engine's segment
    tables): ``logical_owner`` int32[n_logical] / ``hp_owner``
    int32[n_gpa_hp] -- the owning guest of each logical page / GPA huge page
    (-1 unowned); ``ident_gpt`` int32[n_logical] / ``ident_rmap``
    int32[n_gpa] -- the fresh identity mapping a restart rewrites a guest's
    segment to."""
    cfg = spec.cfg
    logical_owner = np.full((cfg.n_logical,), -1, np.int32)
    hp_owner = np.full((cfg.n_gpa_hp,), -1, np.int32)
    ident_gpt = np.full((cfg.n_logical,), -1, np.int32)
    ident_rmap = np.full((cfg.n_gpa,), -1, np.int32)
    for g, guest in enumerate(spec.guests):
        lo, hi = spec.logical_range(g)
        hp_lo, hp_hi = spec.hp_range(g)
        logical_owner[lo:hi] = g
        hp_owner[hp_lo:hp_hi] = g
        gpa = hp_lo * cfg.hp_ratio + np.arange(guest.n_logical)
        ident_gpt[lo:hi] = gpa
        ident_rmap[gpa] = np.arange(lo, hi)
    dev = torch.device(device)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (logical_owner, hp_owner, ident_gpt, ident_rmap))


def _guest_mask(owner: torch.Tensor, per_guest: torch.Tensor) -> torch.Tensor:
    """Lift a per-guest bool vector onto a segment-owner table (unowned rows
    -> False)."""
    return (owner >= 0) & per_guest[owner.clamp(min=0)]


def apply_guest_faults(
    spec,  # repro_torch.core.engine.EngineSpec
    state: TieredState,
    active: torch.Tensor,  # bool[n_guests]
    crash: torch.Tensor,  # bool[n_guests] this window's crash row
    restart: torch.Tensor,  # bool[n_guests] this window's restart row
) -> tuple[TieredState, torch.Tensor]:
    """Apply one window's guest crash/restart row; value-exact identity when
    both rows are all-False.

    Crash (active lanes only): the guest's whole GPA segment is freed
    (``rmap = FREE``, so the ``near_blocks`` collector reports 0 this same
    window), its telemetry is cleared and its payload wiped. ``gpt`` keeps
    its stale entries: an inactive lane is never translated (the stepper
    masks its accesses to -1) and a restart rewrites them. Restart (inactive
    lanes only): the fresh identity mapping. A crash and a restart of one
    guest in one window is a reboot (the crash applies first).

    The payload wipe is done in place: the pool rows of the slots holding a
    reset guest's huge pages (``slot_owner`` reaches the blocks wherever
    they live now) are zeroed, and nothing else of the pools is written --
    the reference's ``where`` over both whole pools, without their copy.
    """
    cfg = spec.cfg
    logical_owner, hp_owner, ident_gpt, ident_rmap = segment_tables(spec, state.device)

    crash_eff = crash & active
    active = active & ~crash_eff
    restart_eff = restart & ~active
    active = active | restart_eff
    reset = crash_eff | restart_eff

    reset_l = _guest_mask(logical_owner, reset)
    reset_hp = _guest_mask(hp_owner, reset)
    crash_hp = _guest_mask(hp_owner, crash_eff)[:, None]
    restart_l = _guest_mask(logical_owner, restart_eff)
    restart_hp = _guest_mask(hp_owner, restart_eff)[:, None]

    # mappings: crash frees the segment, restart rewrites it to identity
    # (ident_rmap is already FREE in the slack, so restart fully defines it)
    rows = (cfg.n_gpa_hp, cfg.hp_ratio)
    rmap = torch.where(crash_hp, FREE, state.rmap.view(rows))
    rmap = torch.where(restart_hp, ident_rmap.view(rows), rmap).view(-1)
    gpt = torch.where(restart_l, ident_gpt, state.gpt)

    # telemetry: both transitions clear the guest's counters/histories
    guest_counts = torch.where(reset_l, 0, state.guest_counts)
    ipt_hist = torch.where(reset_l, 0, state.ipt_hist)
    host_counts = torch.where(reset_hp, 0, state.host_counts)
    host_hist = torch.where(reset_hp, 0, state.host_hist)
    last_touch = torch.where(reset_hp, 0, state.last_touch_epoch)
    region_epoch = torch.where(reset_hp, -1, state.region_epoch)

    reset_slot = reset_hp[state.slot_owner]
    state.near_pool[reset_slot[: cfg.n_near]] = 0
    state.far_pool[reset_slot[cfg.n_near:]] = 0

    state = dataclasses.replace(
        state,
        gpt=gpt,
        rmap=rmap,
        guest_counts=guest_counts,
        ipt_hist=ipt_hist,
        host_counts=host_counts,
        host_hist=host_hist,
        last_touch_epoch=last_touch,
        region_epoch=region_epoch,
    )
    return state, active
