"""Concrete parameter draws for the contracts' ``check_fn``s (port of
``repro.contracts.draws``, DESIGN.md §15).

A :class:`ContractDraw` is a plain bundle of the knobs the engine contracts
range over: ragged guest geometry, host shape, policy, gpac on/off, trace
source kind, chunking, host path, and the pressure controller's knobs. The
CPU harness turns each of the reference harness's hypothesis draws into one
of these field by field; ``chip_smoke.py`` samples them from a seeded
generator over the same ranges.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GuestDraw:
    """One guest's drawn geometry and identity (mirrors engine.GuestSpec)."""

    n_logical: int
    cl: int | None
    gpa_slack: float
    workload: str
    seed: int


@dataclasses.dataclass(frozen=True)
class ContractDraw:
    """One concrete point in the contract parameter space.

    Contracts read only the fields they range over; every contract sees the
    same geometry distribution (ragged guests, non-dividing chunk sizes,
    tie-heavy telemetry seeds).
    """

    guests: tuple[GuestDraw, ...]
    hp_ratio: int
    near_fraction: float
    host_cl: int
    policy: str
    use_gpac: bool
    synth: bool              # SynthTrace vs ArrayTrace source
    n_windows: int
    accesses_per_window: int
    windows_per_step: int    # alternative chunking to pin against wps=0
    host_sharded: bool       # which run_sharded host path to exercise
    cap: int                 # pressure-controller near_cap draw
    budget: int              # pressure-controller / tick budget draw
    slack: int               # pressure-controller low-watermark slack
    seed: int                # telemetry/state randomization seed

    @property
    def n_guests(self) -> int:
        return len(self.guests)


def fallback_draws() -> tuple[ContractDraw, ...]:
    """Two fixed draws, run where hypothesis is absent and first in the
    card's phase. They straddle the big booleans: synth/array source, gpac
    on/off, both run_sharded host paths, and a non-dividing chunk size."""
    return (
        ContractDraw(
            guests=(
                GuestDraw(n_logical=10, cl=None, gpa_slack=0.25,
                          workload="redis", seed=0),
                GuestDraw(n_logical=7, cl=2, gpa_slack=0.5,
                          workload="masim", seed=1),
            ),
            hp_ratio=4, near_fraction=0.5, host_cl=2, policy="memtierd",
            use_gpac=True, synth=True, n_windows=4, accesses_per_window=16,
            windows_per_step=3, host_sharded=True, cap=2, budget=4, slack=1,
            seed=5,
        ),
        ContractDraw(
            guests=(
                GuestDraw(n_logical=12, cl=4, gpa_slack=0.25,
                          workload="hash", seed=2),
            ),
            hp_ratio=8, near_fraction=0.25, host_cl=8, policy="tpp",
            use_gpac=False, synth=False, n_windows=5, accesses_per_window=24,
            windows_per_step=2, host_sharded=False, cap=0, budget=2, slack=0,
            seed=11,
        ),
    )


def build_engine(draw: ContractDraw, device=None):
    """``engine.build`` for a draw: ``(spec, state)`` with base_elems=2, the
    state on ``device`` (CUDA unless named)."""
    from repro_torch.core import engine

    guests = tuple(
        engine.GuestSpec(
            n_logical=g.n_logical, cl=g.cl, gpa_slack=g.gpa_slack,
            workload=g.workload, seed=g.seed,
        )
        for g in draw.guests
    )
    host = engine.HostSpec(
        hp_ratio=draw.hp_ratio, near_fraction=draw.near_fraction,
        base_elems=2, cl=draw.host_cl,
    )
    return engine.build(guests, host, device=device)


def trace_source(draw: ContractDraw, spec):
    """The draw's trace source: on-device synthesis or a packed replay. A
    source holds no device: the driver synthesizes or uploads each window
    on the device of the state it runs."""
    from repro_torch.core import engine

    if draw.synth:
        return engine.SynthTrace(
            n_windows=draw.n_windows,
            accesses_per_window=draw.accesses_per_window,
        )
    return engine.ArrayTrace(
        engine.guest_traces(
            spec, n_windows=draw.n_windows,
            accesses_per_window=draw.accesses_per_window,
        )
    )
