"""The simulation engine: ragged multi-tenant guests in one shared window loop
(port of ``repro.core.engine``'s main path).

* :class:`GuestSpec` -- one guest's shape and trace identity.
* :class:`HostSpec` -- the shared host geometry and policy knobs.
* :class:`EngineSpec` -- the combined config plus the segment-offset tables
  mapping each guest to its logical and GPA huge-page ranges. The padded
  tables are built once per spec and device and kept as device tensors.

:func:`run` drives a trace source window by window: a Python loop over
windows (PyTorch runs eagerly, so there is no scan to fuse), with the
collector series stacked on the device and copied to the host once per
``windows_per_step`` chunk. The source is an :class:`ArrayTrace` (a host
array, uploaded once per chunk) or a :class:`SynthTrace` (each window's
accesses made on the device from the guests' workload identities,
``data.traces``' window functions). Entry points (:func:`build`,
:func:`init_engine_state`, :func:`run`, :func:`run_series`) run on CUDA
unless the caller passes ``device="cpu"``; without a CUDA device they raise.

The state is updated in place window by window (see ``core.types``): the
state handed to :func:`run` is consumed.

The steady-state churn engine (:class:`ChurnState`, :func:`init_churn`,
:func:`run_churn`, :func:`step_churn`) drives the same window with a fault
schedule (``core.faults``) and the pressure controller
(``tiering.pressure_tick``); with no fault it is bit-identical to
:func:`run`. :func:`run_reference` keeps the sequential per-guest window as
the equivalence oracle.

A :class:`HostSpec` with ``tiers`` (``core.tiers.TierSpec``s) builds an
N-tier host: the policies run as flows between adjacent tiers, the churn
engine's pressure controller as a per-tier cascade, and the ``tco``
collector prices each window's placement.

Not ported yet, and raising ``NotImplementedError`` naming their ROADMAP
item: the sharded runs (:func:`run_sharded`, and ``mesh=`` for the churn
engine).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import address_space as asp
from repro_torch.core import faults as faults_mod
from repro_torch.core import gpac, metrics, telemetry, tiering
from repro_torch.core import tiers as tiers_mod
from repro_torch.core.types import GpacConfig, TieredState, allocated_hp_mask, init_state
from repro_torch.data import traces as tr
from repro_torch.kernels import registry as kernels_registry
from repro_torch.kernels import runtime


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP queue 1, item {item})")


# --------------------------------------------------------------------------
# geometry specs
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GuestSpec:
    """One guest's geometry and trace identity (``cl=None`` inherits the
    host's Consolidation Limit)."""

    n_logical: int
    cl: int | None = None
    gpa_slack: float = 0.25
    workload: str = "redis"
    seed: int = 0

    def hp_need(self, hp_ratio: int) -> int:
        return -(-self.n_logical // hp_ratio)

    def hp_size(self, hp_ratio: int) -> int:
        need = self.hp_need(hp_ratio)
        return need + max(2, int(need * self.gpa_slack))


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """Shared host geometry + default policy knobs for the combined config.
    ``near_fraction`` sizes the near tier as a fraction of the guests'
    needed huge pages, ``n_near`` overrides it; ``tiers`` (a tuple of
    ``core.tiers.TierSpec``, exclusive with ``n_near``) replaces both with
    an N-tier hierarchy whose tier 0 is the near pool."""

    hp_ratio: int = 512
    near_fraction: float = 0.5
    n_near: int = 0
    base_elems: int = 8
    cl: int = 64
    hot_threshold: int = 1
    ipt_windows: int = 8
    ipt_min_hits: int = 1
    reconsolidate_cooldown: int = 2
    dtype: Any = torch.float32
    tiers: tuple | None = None

    def __post_init__(self):
        if self.hp_ratio < 1:
            raise ValueError(
                f"HostSpec: hp_ratio must be >= 1, got {self.hp_ratio}")
        if not 0.0 < self.near_fraction <= 1.0:
            raise ValueError(
                f"HostSpec: near_fraction must be in (0, 1], got "
                f"{self.near_fraction}")
        if self.n_near < 0:
            raise ValueError(
                f"HostSpec: n_near must be >= 0 (0 means derive from "
                f"near_fraction), got {self.n_near}")
        if self.base_elems < 1:
            raise ValueError(
                f"HostSpec: base_elems must be >= 1, got {self.base_elems}")
        if not 1 <= self.cl <= self.hp_ratio:
            raise ValueError(
                f"HostSpec: Consolidation Limit must be in [1, hp_ratio="
                f"{self.hp_ratio}], got cl={self.cl}")
        if self.tiers is not None:
            if self.n_near:
                raise ValueError(
                    f"HostSpec: tiers and n_near are mutually exclusive "
                    f"(tier 0's capacity sizes the near pool), got n_near="
                    f"{self.n_near} with {len(self.tiers)} tiers")
            object.__setattr__(self, "tiers", tuple(self.tiers))
            if len(self.tiers) < 2:
                raise ValueError(
                    f"HostSpec: tiers needs >= 2 entries, got "
                    f"{len(self.tiers)}")
            for t in self.tiers:
                if not isinstance(t, tiers_mod.TierSpec):
                    raise ValueError(
                        f"HostSpec: tiers entries must be TierSpec, got "
                        f"{type(t).__name__}: {t!r}")


class SegmentTables(NamedTuple):
    """An :class:`EngineSpec`'s segment tables as tensors on one device."""

    logical_pad: torch.Tensor  # int32[n_guests, max_logical], -1 padded
    hp_pad: torch.Tensor  # int32[n_guests, max_hp], -1 padded
    cl_per_logical: torch.Tensor  # int32[n_logical]
    logical_lo: torch.Tensor  # int32[n_guests, 1] first logical id per guest


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Static engine geometry: combined config + per-guest segment offsets.

    Guest ``g`` owns logical pages ``[logical_offsets[g],
    logical_offsets[g+1])`` and GPA huge pages ``[hp_offsets[g],
    hp_offsets[g+1])``; segments are disjoint and tile their spaces.
    ``tiers`` is the resolved ``core.tiers.TierVector`` of an N-tier host
    (None: the near/far split); ``kernel_backend`` is the registry knob
    (``"auto"`` | ``"torch"``); ``arbitration_stride`` runs the host tick
    only every that many windows.
    """

    cfg: GpacConfig
    guests: tuple[GuestSpec, ...]
    logical_offsets: tuple[int, ...]  # len n_guests+1
    hp_offsets: tuple[int, ...]  # len n_guests+1
    tiers: Any = None
    kernel_backend: str = "auto"
    arbitration_stride: int = 1

    @property
    def n_guests(self) -> int:
        return len(self.guests)

    @property
    def tier_vector(self):
        """The resolved hierarchy, defaulting to the near/far split."""
        return tiers_mod.as_vector(self.cfg, self.tiers)

    def logical_range(self, g: int) -> tuple[int, int]:
        return self.logical_offsets[g], self.logical_offsets[g + 1]

    def hp_range(self, g: int) -> tuple[int, int]:
        return self.hp_offsets[g], self.hp_offsets[g + 1]

    def guest_cl(self, g: int) -> int:
        cl = self.guests[g].cl
        return self.cfg.cl if cl is None else cl

    @property
    def max_logical(self) -> int:
        return max(hi - lo for lo, hi in zip(self.logical_offsets, self.logical_offsets[1:]))

    @property
    def max_hp(self) -> int:
        return max(hi - lo for lo, hi in zip(self.hp_offsets, self.hp_offsets[1:]))

    def logical_pad_index(self) -> np.ndarray:
        """int32[n_guests, max_logical]: row g = guest g's global logical
        ids, -1 padded past its segment."""
        out = np.full((self.n_guests, self.max_logical), -1, np.int32)
        for g in range(self.n_guests):
            lo, hi = self.logical_range(g)
            out[g, : hi - lo] = np.arange(lo, hi, dtype=np.int32)
        return out

    def hp_pad_index(self) -> np.ndarray:
        """int32[n_guests, max_hp]: row g = guest g's global GPA huge-page
        ids, -1 padded."""
        out = np.full((self.n_guests, self.max_hp), -1, np.int32)
        for g in range(self.n_guests):
            lo, hi = self.hp_range(g)
            out[g, : hi - lo] = np.arange(lo, hi, dtype=np.int32)
        return out

    def cl_per_logical(self) -> np.ndarray:
        """int32[n_logical]: the CL of the guest owning each logical page."""
        out = np.empty((self.cfg.n_logical,), np.int32)
        for g in range(self.n_guests):
            lo, hi = self.logical_range(g)
            out[lo:hi] = self.guest_cl(g)
        return out

    def tables(self, device) -> SegmentTables:
        """The segment tables as tensors on ``device``, built once per spec
        and device (at full width ``logical_pad`` alone is 13 MB)."""
        return _segment_tables(self, torch.device(device))

    def localize(self, local_ids: torch.Tensor) -> torch.Tensor:
        """Guest-local ids ``int32[n_guests, k]`` -> combined-space ids (-1
        padding passes through)."""
        lo = self.tables(local_ids.device).logical_lo
        return torch.where(local_ids >= 0, local_ids + lo, -1)


@functools.lru_cache(maxsize=16)
def _segment_tables(spec: EngineSpec, device: torch.device) -> SegmentTables:
    def t(a):
        return torch.from_numpy(a).to(device)

    lo = np.asarray(spec.logical_offsets[:-1], np.int32)[:, None]
    return SegmentTables(
        logical_pad=t(spec.logical_pad_index()),
        hp_pad=t(spec.hp_pad_index()),
        cl_per_logical=t(spec.cl_per_logical()),
        logical_lo=t(np.ascontiguousarray(lo)),
    )


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------
def build(
    guests: tuple[GuestSpec, ...] | list,
    host: HostSpec = HostSpec(),
    device=None,
) -> tuple[EngineSpec, TieredState]:
    """Build N (possibly ragged) guests over one shared host space; guest g's
    pages are identity-placed at the start of its own GPA segment. The state
    lives on ``device`` (CUDA unless named)."""
    dev = runtime.resolve_device(device)
    guests = tuple(
        GuestSpec(n_logical=g) if isinstance(g, int) else g for g in guests)
    if not guests:
        raise ValueError("need at least one GuestSpec")
    hp_sizes = [g.hp_size(host.hp_ratio) for g in guests]
    logical_offsets = tuple(np.cumsum([0] + [g.n_logical for g in guests]).tolist())
    hp_offsets = tuple(np.cumsum([0] + hp_sizes).tolist())
    n_hp = hp_offsets[-1]
    total_need = sum(g.hp_need(host.hp_ratio) for g in guests)
    tv = None
    if host.tiers is not None:
        tv = tiers_mod.resolve(host.tiers, n_slots=n_hp, total_need=total_need)
        n_near = tv.boundaries[1]
    else:
        n_near = host.n_near or max(1, int(host.near_fraction * total_need))
    cfg = GpacConfig(
        n_logical=logical_offsets[-1],
        hp_ratio=host.hp_ratio,
        n_gpa_hp=n_hp,
        n_near=min(n_near, n_hp - 1),
        base_elems=host.base_elems,
        cl=host.cl,
        hot_threshold=host.hot_threshold,
        ipt_windows=host.ipt_windows,
        ipt_min_hits=host.ipt_min_hits,
        reconsolidate_cooldown=host.reconsolidate_cooldown,
        dtype=host.dtype,
    )
    spec = EngineSpec(cfg, guests, logical_offsets, hp_offsets, tiers=tv)
    return spec, init_engine_state(spec, device=dev)


def init_engine_state(spec: EngineSpec, device=None) -> TieredState:
    """Identity-map each guest's logical pages into its own GPA segment."""
    dev = runtime.resolve_device(device)
    cfg = spec.cfg
    gpt = np.full((cfg.n_logical,), -1, np.int32)
    rmap = np.full((cfg.n_gpa,), -1, np.int32)
    for g, guest in enumerate(spec.guests):
        lo, hi = spec.logical_range(g)
        hp_lo, _ = spec.hp_range(g)
        gpa = hp_lo * cfg.hp_ratio + np.arange(guest.n_logical)
        gpt[lo:hi] = gpa
        rmap[gpa] = np.arange(lo, hi)
    state = init_state(cfg, device=dev)
    return dataclasses.replace(
        state, gpt=torch.from_numpy(gpt).to(dev), rmap=torch.from_numpy(rmap).to(dev))


def spec_from_config(cfg: GpacConfig, workload: str = "redis", seed: int = 0) -> EngineSpec:
    """Single-guest spec spanning an existing config's whole space."""
    guest = GuestSpec(n_logical=cfg.n_logical, cl=cfg.cl, workload=workload, seed=seed)
    return EngineSpec(cfg, (guest,), (0, cfg.n_logical), (0, cfg.n_gpa_hp))


def symmetric_spec(cfg: GpacConfig, n_guests: int, cl: int | None = None) -> EngineSpec:
    """Spec for N equal guests tiling an existing combined config."""
    if cfg.n_logical % n_guests or cfg.n_gpa_hp % n_guests:
        raise ValueError(
            f"symmetric_spec: n_logical={cfg.n_logical} / n_gpa_hp="
            f"{cfg.n_gpa_hp} not divisible by n_guests={n_guests}")
    lpg = cfg.n_logical // n_guests
    hpg = cfg.n_gpa_hp // n_guests
    guests = tuple(GuestSpec(n_logical=lpg, cl=cl) for _ in range(n_guests))
    return EngineSpec(
        cfg, guests,
        tuple(range(0, cfg.n_logical + 1, lpg)),
        tuple(range(0, cfg.n_gpa_hp + 1, hpg)),
    )


# --------------------------------------------------------------------------
# trace sources
# --------------------------------------------------------------------------
class TraceSource:
    """What drives the engine's windows: an :class:`ArrayTrace` (a host
    array; raw arrays passed to the drivers are wrapped in one) or a
    :class:`SynthTrace` (accesses made on the device window by window, so
    no ``[n_guests, n_windows, k]`` array ever exists). Every source has
    ``n_windows``."""


@dataclasses.dataclass(frozen=True)
class ArrayTrace(TraceSource):
    """A packed per-guest trace (``pack_traces`` / ``guest_traces``
    output): ``int32[n_guests, n_windows, k]`` guest-local ids, -1 padded."""

    traces: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "traces", np.asarray(self.traces))

    @property
    def n_windows(self) -> int:
        return self.traces.shape[1]


@dataclasses.dataclass(frozen=True)
class SynthTrace(TraceSource):
    """On-device workload synthesis for ``n_windows`` windows of
    ``accesses_per_window`` accesses each.

    ``workloads`` / ``seeds`` default to the guests' own :class:`GuestSpec`
    identities at bind time; pass tuples (one entry per guest) to override
    them. ``partitionable`` is JAX's threefry bit layout the streams
    reproduce (``data.prng``)."""

    n_windows: int
    accesses_per_window: int
    workloads: tuple[str, ...] | None = None
    seeds: tuple[int, ...] | None = None
    partitionable: bool = True

    def __post_init__(self):
        if self.n_windows < 0:
            raise ValueError(f"n_windows must be >= 0, got {self.n_windows}")
        if self.accesses_per_window < 1:
            raise ValueError(
                f"accesses_per_window must be >= 1, got "
                f"{self.accesses_per_window}")
        if self.workloads is not None:
            object.__setattr__(self, "workloads", tuple(self.workloads))
        if self.seeds is not None:
            object.__setattr__(self, "seeds", tuple(self.seeds))


def as_trace_source(x) -> TraceSource:
    """Coerce a driver input to a :class:`TraceSource` (arrays and lists
    wrap as :class:`ArrayTrace`)."""
    if isinstance(x, TraceSource):
        return x
    if isinstance(x, (np.ndarray, list, tuple)) or hasattr(x, "__array__"):
        return ArrayTrace(np.asarray(x))
    raise TypeError(
        f"expected a TraceSource or a packed trace array, got {type(x).__name__}")


def _coerce_source(source) -> TraceSource:
    if source is None:
        raise TypeError("run() needs a trace source (ArrayTrace / SynthTrace)")
    return as_trace_source(source)


def _bind_synth(spec: EngineSpec, synth: SynthTrace):
    """Bind a :class:`SynthTrace` to a spec's guests: the static
    :class:`repro_torch.data.traces.SynthPlan` (distinct workload set and
    shapes) and the per-guest numpy tables (seed, global guest id, workload
    index, size)."""
    n_g = spec.n_guests
    workloads = synth.workloads or tuple(g.workload for g in spec.guests)
    seeds = synth.seeds if synth.seeds is not None else tuple(g.seed for g in spec.guests)
    if len(workloads) != n_g or len(seeds) != n_g:
        raise ValueError(
            f"SynthTrace workloads/seeds must have one entry per guest "
            f"(n_guests={n_g}), got {len(workloads)}/{len(seeds)}")
    for name in workloads:
        tr.get_workload(name)  # fail fast, listing the live set
    wset = tuple(sorted(set(workloads)))
    plan = tr.SynthPlan(
        workload_set=wset,
        accesses_per_window=synth.accesses_per_window,
        hp_ratio=spec.cfg.hp_ratio,
        max_logical=spec.max_logical,
        partitionable=synth.partitionable,
    )
    tables = dict(
        seeds=np.asarray(seeds, np.int32),
        gids=np.arange(n_g, dtype=np.int32),
        wid=np.asarray([wset.index(w) for w in workloads], np.int32),
        n_logical=np.asarray([g.n_logical for g in spec.guests], np.int32),
    )
    return plan, tables


def _window_feed(spec: EngineSpec, source: TraceSource, dev: torch.device,
                 first_window: int) -> Callable:
    """``feed(s, e)`` yields the accesses of this call's windows ``s`` to
    ``e - 1``, each ``int32[n_guests, k]`` on ``dev``. An ArrayTrace chunk
    goes to the device in one copy; a SynthTrace window is made on the
    device from its absolute index ``first_window + i``, so any chunking
    gives the same streams. The synthesis setup (keys, scatter tables) is
    deterministic, so it is built once per call, where the reference
    rebuilds it per chunk."""
    if isinstance(source, SynthTrace):
        plan, tables = _bind_synth(spec, source)
        setup = tr.synth_setup(plan, tables, dev)

        def feed(s, e):
            for i in range(s, e):
                yield tr.synth_accesses(plan, setup, first_window + i)
    else:
        by_window = np.ascontiguousarray(
            np.transpose(source.traces, (1, 0, 2)), dtype=np.int32)

        def feed(s, e):
            yield from torch.from_numpy(by_window[s:e]).to(dev)
    return feed


def pack_traces(per_guest: list[np.ndarray]) -> np.ndarray:
    """Stack ragged per-guest traces ``[n_windows, k_g]`` into one padded
    ``int32[n_guests, n_windows, k_max]`` array (-1 padding)."""
    n_w = {t.shape[0] for t in per_guest}
    if len(n_w) != 1:
        raise ValueError(f"guests disagree on n_windows: {sorted(n_w)}")
    k = max(t.shape[1] for t in per_guest)
    out = np.full((len(per_guest), n_w.pop(), k), -1, np.int32)
    for g, t in enumerate(per_guest):
        out[g, :, : t.shape[1]] = t
    return out


def guest_traces(spec: EngineSpec, n_windows: int, accesses_per_window: int) -> np.ndarray:
    """Each guest's trace from its GuestSpec workload/seed (numpy
    generators), packed; identical guests share one generation."""
    cache: dict = {}

    def one(g: GuestSpec) -> np.ndarray:
        ts = tr.TraceSpec(
            g.workload, n_logical=g.n_logical, hp_ratio=spec.cfg.hp_ratio,
            n_windows=n_windows, accesses_per_window=accesses_per_window,
            seed=g.seed)
        if ts not in cache:
            cache[ts] = tr.generate(ts)
        return cache[ts]

    return pack_traces([one(g) for g in spec.guests])


# --------------------------------------------------------------------------
# metric collectors (run on the device after every window)
# --------------------------------------------------------------------------
_COLLECTORS: dict[str, Callable] = {}


def register_collector(name: str, fn: Callable | None = None):
    """Register a collector ``fn(spec, state, window) -> dict[str,
    Tensor]``; ``window`` holds the access-time per-guest hit counts."""
    if fn is None:
        return lambda f: register_collector(name, f)
    if name in _COLLECTORS:
        raise ValueError(f"metric collector {name!r} already registered")
    _COLLECTORS[name] = fn
    return fn


def get_collector(name: str) -> Callable:
    try:
        return _COLLECTORS[name]
    except KeyError:
        raise ValueError(
            f"unknown metric collector {name!r} (have {collectors()})") from None


def collectors() -> tuple[str, ...]:
    return tuple(_COLLECTORS)


def run_collectors(spec: EngineSpec, state: TieredState, window: dict,
                   collect: tuple[str, ...]) -> dict:
    """Run the requested collectors, rejecting colliding output keys."""
    out = {}
    for name in collect:
        emitted = get_collector(name)(spec, state, window)
        clash = set(emitted) & set(out)
        if clash:
            raise ValueError(
                f"collector {name!r} emits keys {sorted(clash)} already "
                f"produced by an earlier collector in {collect}")
        out.update(emitted)
    return out


@register_collector("hits")
def _collect_hits(spec, state, window) -> dict:
    """Per-guest near/far hit counts for this window (access-time tiers)."""
    return dict(near_hits=window["near_hits"], far_hits=window["far_hits"])


@register_collector("near_blocks")
def _collect_near_blocks(spec, state, window) -> dict:
    """Per-guest allocated blocks currently in the near tier."""
    cfg = spec.cfg
    near = allocated_hp_mask(cfg, state) & (state.block_table < cfg.n_near)
    hp_pad = spec.tables(state.device).hp_pad
    seg = (hp_pad >= 0) & near[hp_pad.clamp(min=0)]
    return dict(near_blocks=seg.sum(dim=1).to(torch.int32))


@register_collector("snapshot")
def _collect_snapshot(spec, state, window) -> dict:
    """Host-space scalar metrics (``metrics.device_snapshot``); not
    composable with ``hits`` (both emit ``near_hits``/``far_hits``).
    ``near_capacity_used`` rounds as the reference's collector does inside
    ``jax.jit`` (a multiply by float32(1 / n_near))."""
    return metrics.device_snapshot(spec.cfg, state, jit_rounding=True)


@register_collector("tco")
def _collect_tco(spec, state, window) -> dict:
    """The TCO objective per window (``core.tiers.tco_metrics``, its float32
    sums rounded as the reference's jitted collector): $-weighted resident
    GB of the post-tick placement, the per-tier AMAT of this window's
    accesses and the per-tier block and hit vectors. Without
    ``HostSpec.tiers`` it prices the near/far split as DRAM/NVMM."""
    tv = spec.tier_vector
    blocks = tiers_mod.tier_alloc_counts(spec.cfg, state, tv)
    return tiers_mod.tco_metrics(spec.cfg, tv, blocks, window["tier_hits"],
                                 jit_rounding=True)


# --------------------------------------------------------------------------
# the window loop
# --------------------------------------------------------------------------
def _window(
    spec: EngineSpec,
    state: TieredState,
    accesses: torch.Tensor,  # int32[n_guests, k] guest-local ids, -1 padded
    epoch: int,  # host-side copy of state.epoch
    policy: str,
    backend: str,
    use_gpac: bool,
    max_batches: int,
    budget: int,
    collect: tuple[str, ...],
) -> tuple[TieredState, dict]:
    """One engine window: translate and record every guest's accesses, one
    batched GPAC pass, the host tier tick, the window roll, then the
    collectors."""
    cfg = spec.cfg
    ids = spec.localize(accesses)
    slot, _, valid = asp.translate(cfg, state, ids)
    window = dict(
        near_hits=(valid & (slot < cfg.n_near)).sum(dim=1).to(torch.int32),
        far_hits=(valid & (slot >= cfg.n_near)).sum(dim=1).to(torch.int32),
    )
    if "tco" in collect:
        window["tier_hits"] = tiers_mod.tier_hit_counts(spec.tier_vector, slot, valid)
    state = asp.record_accesses(
        cfg, state, ids.reshape(-1), kernel_backend=spec.kernel_backend)
    if use_gpac:
        state = gpac.gpac_maintenance_ragged(spec, state, backend, max_batches)
    state = tiering.strided_tick(
        cfg, state, policy, stride=spec.arbitration_stride, budget=budget,
        epoch=epoch, tiers=spec.tiers)
    state = telemetry.end_window(cfg, state)
    return state, run_collectors(spec, state, window, collect)


def _round_wps(n_windows: int, windows_per_step: int, strict: bool) -> int:
    """Chunk size: ``windows_per_step`` rounded down to a divisor of
    ``n_windows`` (0 or oversized = the whole run), unless that would more
    than double the number of chunks; ``strict`` keeps the requested size."""
    wps = n_windows if windows_per_step <= 0 else min(windows_per_step, n_windows)
    if strict:
        return wps
    div = wps
    while n_windows % div:
        div -= 1
    if n_windows // div > 2 * (-(-n_windows // wps)):
        return wps
    return div


def _with_overrides(spec: EngineSpec, kernel_backend: str | None,
                    arbitration_stride: int | None) -> EngineSpec:
    """Fold the run-level overrides into the spec and validate both."""
    if kernel_backend is not None:
        spec = dataclasses.replace(spec, kernel_backend=kernel_backend)
    if arbitration_stride is not None:
        spec = dataclasses.replace(spec, arbitration_stride=int(arbitration_stride))
    kernels_registry.resolve_backend(spec.kernel_backend)
    s = spec.arbitration_stride
    if not isinstance(s, int) or isinstance(s, bool) or s < 1:
        raise ValueError(f"arbitration_stride must be an int >= 1, got {s!r}")
    return spec


def _check_device(state: TieredState, device) -> torch.device:
    dev = runtime.resolve_device(device)
    have = state.device
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise ValueError(f"state lives on {have}, but the run asks for {dev}")
    return have


def _validate(spec: EngineSpec, source: TraceSource, collect) -> tuple[str, ...]:
    if isinstance(source, ArrayTrace):
        traces = source.traces
        if traces.ndim != 3 or traces.shape[0] != spec.n_guests:
            raise ValueError(
                f"traces must be [n_guests={spec.n_guests}, n_windows, k], got "
                f"{traces.shape}")
    collect = tuple(collect)
    for name in collect:
        get_collector(name)  # fail fast on unknown collectors
    return collect


def step(
    spec: EngineSpec,
    state,  # TieredState, or a ChurnState for the steady-state stepper
    accesses: torch.Tensor,
    policy: str = "memtierd",
    backend: str = "ipt",
    use_gpac: bool = True,
    max_batches: int = 4,
    budget: int = 64,
    collect: tuple[str, ...] = ("hits", "near_blocks"),
    *,
    faults_row: dict | None = None,
    mesh=None,
    slack: int = 1,
    arbitration_stride: int | None = None,
) -> tuple:
    """One engine window (``accesses`` int32[n_guests, k] on the state's
    device); reads ``state.epoch`` from the device once. Handed a
    :class:`ChurnState` it dispatches to :func:`step_churn`, where
    ``faults_row`` injects this window's faults."""
    if isinstance(state, ChurnState):
        return step_churn(
            spec, state, accesses, faults_row=faults_row, mesh=mesh,
            policy=policy, backend=backend, use_gpac=use_gpac,
            max_batches=max_batches, budget=budget, slack=slack,
            collect=tuple(collect), arbitration_stride=arbitration_stride)
    if faults_row is not None or mesh is not None:
        raise TypeError(
            "faults_row/mesh need the steady-state stepper: pass a "
            "ChurnState carry (engine.init_churn)")
    spec = _with_overrides(spec, None, arbitration_stride)
    collect = tuple(collect)
    for name in collect:
        get_collector(name)
    return _window(spec, state, accesses, int(state.epoch), policy, backend,
                   use_gpac, max_batches, budget, collect)


def run(
    spec: EngineSpec,
    state: TieredState,
    source: TraceSource | np.ndarray,
    *,
    policy: str = "memtierd",
    backend: str = "ipt",
    use_gpac: bool = True,
    max_batches: int = 4,
    budget: int = 64,
    windows_per_step: int = 0,
    strict_wps: bool = False,
    collect: tuple[str, ...] = ("hits", "near_blocks"),
    kernel_backend: str | None = None,
    arbitration_stride: int | None = None,
    device=None,
) -> tuple[TieredState, dict]:
    """Drive every window of ``source`` through the engine.

    ``source`` is an :class:`ArrayTrace` (raw packed arrays are wrapped) or
    a :class:`SynthTrace`, whose window ``w`` (counted from 0 in every call,
    as in the reference) is made on the device. ``windows_per_step`` sets
    how many windows share one host transfer: the accesses of an array
    chunk go to the device in one copy, and the collector series of a
    chunk, stacked on the device, come back in one copy per series (rounded
    as in the reference, see :func:`_round_wps`). The state must live on
    ``device`` (CUDA unless named).

    Returns ``(state, series)``: ``series[k]`` is a numpy array of shape
    ``[n_windows, ...]`` per collector output; ``{}`` when the source has no
    windows or ``collect`` is empty.
    """
    dev = _check_device(state, device)
    source = _coerce_source(source)
    spec = _with_overrides(spec, kernel_backend, arbitration_stride)
    collect = _validate(spec, source, collect)
    n_w = source.n_windows
    if n_w == 0:
        return state, {}
    feed = _window_feed(spec, source, dev, 0)
    wps = _round_wps(n_w, windows_per_step, strict_wps)
    epoch = int(state.epoch)  # the only device read of the run's control flow
    chunks = []
    for s in range(0, n_w, wps):
        outs = []
        for acc in feed(s, min(s + wps, n_w)):
            state, out = _window(spec, state, acc, epoch, policy, backend,
                                 use_gpac, max_batches, budget, collect)
            epoch += 1
            outs.append(out)
        if collect:
            chunks.append({
                k: torch.stack([o[k] for o in outs]).cpu().numpy()
                for k in outs[0]})
    if not collect:
        return state, {}
    series = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    return state, series


def run_series(
    spec: EngineSpec,
    state: TieredState,
    source: TraceSource | np.ndarray,
    tier_pair: str = "dram_nvmm",
    *,
    device=None,
    **kw,
) -> tuple[TieredState, dict]:
    """:func:`run` + the per-VM series the at-scale figures plot: near
    blocks, per-window hit rate and modeled throughput (any trace
    source)."""
    n_g = spec.n_guests
    source = _coerce_source(source)
    _validate(spec, source, ())
    if source.n_windows == 0:
        _check_device(state, device)
        return state, dict(
            near_blocks=np.zeros((0, n_g), np.int64),
            hit_rate=np.zeros((0, n_g)),
            throughput=np.zeros((0, n_g)),
        )
    state, out = run(spec, state, source, collect=("hits", "near_blocks"),
                     device=device, **kw)
    nh = out["near_hits"].astype(np.float64)
    fh = out["far_hits"].astype(np.float64)
    hit_rate, throughput = metrics.throughput_from_hits(nh, fh, tier_pair)
    return state, dict(
        near_blocks=out["near_blocks"].astype(np.int64),
        hit_rate=hit_rate,
        throughput=throughput,
    )


def run_sharded(*args, **kwargs):
    raise _not_ported("run_sharded (device-sharded runs, ArrayTrace or SynthTrace)", 13)


# --------------------------------------------------------------------------
# steady-state churn engine
# --------------------------------------------------------------------------
# per-window series every churn driver emits alongside the collectors
_CHURN_SERIES = ("active", "near_cap", "pressure")


@dataclasses.dataclass
class ChurnState:
    """The steady-state stepper's carry: the tiered state plus the churn
    bookkeeping that persists between driver calls.

    ``active`` is the guest-axis activity mask: an inactive lane contributes
    no accesses, holds no blocks and is excluded from arbitration.
    ``window`` is the absolute index of the next window (fault schedules
    are keyed on it). ``near_cap`` / ``pressure`` / ``engaged`` carry the
    pressure controller (``tiering.pressure_tick``) across windows. Every
    field is a tensor on the state's device, as in the reference."""

    state: TieredState
    active: torch.Tensor  # bool[n_guests] lane activity mask
    window: torch.Tensor  # int32[] absolute index of the next window
    near_cap: torch.Tensor  # int32[] effective near capacity in force
    pressure: torch.Tensor  # int32[] consecutive pressure-engaged windows
    engaged: torch.Tensor  # bool[] pressure-controller hysteresis latch


def _scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d tensor filled on ``device`` (a fill, not a host copy)."""
    return torch.full((), value, dtype=dtype, device=device)


def init_churn(
    spec: EngineSpec,
    state: TieredState | None = None,
    active: np.ndarray | None = None,
    window: int = 0,
    device=None,
) -> ChurnState:
    """Wrap an engine state (a fresh identity state on ``device``, CUDA
    unless named, when None) for the steady-state stepper. With all lanes
    active a no-fault churn run is bit-identical to :func:`run` from the
    same state. Lanes marked inactive in ``active`` are reclaimed at once
    (crash semantics) and hold no blocks until a restart boots them."""
    if state is None:
        dev = runtime.resolve_device(device)
        state = init_engine_state(spec, device=dev)
    else:
        dev = _check_device(state, device)
    n_g = spec.n_guests
    act = np.ones((n_g,), bool) if active is None else np.asarray(active, bool)
    if act.shape != (n_g,):
        raise ValueError(
            f"active mask must be bool[n_guests={n_g}], got shape {act.shape}")
    cs = ChurnState(
        state=state,
        active=torch.from_numpy(act.copy()).to(dev),
        window=_scalar(int(window), torch.int32, dev),
        near_cap=_scalar(spec.cfg.n_near, torch.int32, dev),
        pressure=_scalar(0, torch.int32, dev),
        engaged=_scalar(False, torch.bool, dev),
    )
    if not act.all():
        st, act2 = faults_mod.apply_guest_faults(
            spec, cs.state, torch.ones((n_g,), dtype=torch.bool, device=dev),
            torch.from_numpy(~act).to(dev),
            torch.zeros((n_g,), dtype=torch.bool, device=dev))
        cs = dataclasses.replace(cs, state=st, active=act2)
    return cs


def _churn_window(
    spec: EngineSpec,
    cs: ChurnState,
    accesses: torch.Tensor,  # int32[n_guests, k] guest-local ids, -1 padded
    frow: dict,  # this window's fault row, host values: crash, restart, near_cap, drop
    epoch: int,  # host-side copy of cs.state.epoch
    policy: str,
    backend: str,
    use_gpac: bool,
    max_batches: int,
    budget: int,
    slack: int,
    collect: tuple[str, ...],
) -> tuple[ChurnState, dict]:
    """One churn window: :func:`_window` with the fault row applied first,
    inactive lanes' accesses masked to -1, the telemetry written through
    the access histogram (zeroed in a dropout window) and the pressure
    controller run after the policy tick.

    The fault row lives on the host, so a window without a crash or restart
    skips the fault pass (it would be value-exact identity) and writes
    nothing to the pools, and a capacity at ``n_near`` costs the controller
    no device sync. With no fault every step is value-exact identity, so
    the run stays bit-identical to :func:`run` on either of its telemetry
    branches."""
    cfg = spec.cfg
    state, active = cs.state, cs.active
    dev = state.device
    if frow["crash"].any() or frow["restart"].any():
        state, active = faults_mod.apply_guest_faults(
            spec, state, active, torch.from_numpy(frow["crash"]).to(dev),
            torch.from_numpy(frow["restart"]).to(dev))
    near_cap = min(int(frow["near_cap"]), cfg.n_near)
    acc = torch.where(active[:, None], accesses, -1)
    ids = spec.localize(acc)
    slot, _, valid = asp.translate(cfg, state, ids)
    window = dict(
        near_hits=(valid & (slot < cfg.n_near)).sum(dim=1).to(torch.int32),
        far_hits=(valid & (slot >= cfg.n_near)).sum(dim=1).to(torch.int32),
    )
    if "tco" in collect:
        window["tier_hits"] = tiers_mod.tier_hit_counts(spec.tier_vector, slot, valid)
    kb = spec.kernel_backend
    h = asp.access_histogram(cfg, ids, valid, kb)
    if frow["drop"]:
        h = h * 0  # the reference's integer dropout gate
    state = asp.apply_access_histogram(cfg, state, h, kb)
    if use_gpac:
        state = gpac.gpac_maintenance_ragged(spec, state, backend, max_batches)
    state = tiering.strided_tick(
        cfg, state, policy, stride=spec.arbitration_stride, budget=budget,
        epoch=epoch, tiers=spec.tiers)
    state, engaged, press = tiering.pressure_tick(
        cfg, state, near_cap, cs.engaged, cs.pressure, budget=budget, slack=slack,
        tiers=spec.tiers)
    state = telemetry.end_window(cfg, state)
    out = run_collectors(spec, state, window, collect)
    clash = set(out) & set(_CHURN_SERIES)
    if clash:
        raise ValueError(
            f"collectors {collect} emit keys {sorted(clash)} reserved for "
            f"the churn series {_CHURN_SERIES}")
    cap = _scalar(near_cap, torch.int32, dev)
    out.update(active=active, near_cap=cap, pressure=press)
    return ChurnState(state=state, active=active, window=cs.window + 1,
                      near_cap=cap, pressure=press, engaged=engaged), out


def _resolve_fault_tables(
    spec: EngineSpec, carried_cap: int, faults, n_windows: int, start: int,
) -> faults_mod.FaultTables:
    """The dense fault rows of one driver call: a schedule compiles against
    the physical ``n_near``; ``faults=None`` keeps the carried capacity
    ``carried_cap`` (a shrink from an earlier call stays in force);
    precompiled tables must cover exactly this call's windows."""
    if faults is None:
        return faults_mod.no_faults(spec.n_guests).tables(
            n_windows, carried_cap, start=start)
    if isinstance(faults, faults_mod.FaultSchedule):
        if faults.n_guests != spec.n_guests:
            raise ValueError(
                f"fault schedule is for {faults.n_guests} guests, spec has "
                f"{spec.n_guests}")
        return faults.tables(n_windows, spec.cfg.n_near, start=start)
    if isinstance(faults, faults_mod.FaultTables):
        if (faults.n_windows != n_windows or faults.n_guests != spec.n_guests
                or faults.start != start):
            raise ValueError(
                f"fault tables cover windows [{faults.start}, "
                f"{faults.start + faults.n_windows}) x {faults.n_guests} "
                f"guests; this run is windows [{start}, {start + n_windows})"
                f" x {spec.n_guests}")
        return faults
    raise TypeError(
        f"faults must be a FaultSchedule, FaultTables or None, got "
        f"{type(faults).__name__}")


def run_churn(
    spec: EngineSpec,
    cs: ChurnState,
    source: TraceSource | np.ndarray,
    *,
    faults=None,  # FaultSchedule | FaultTables | None
    mesh=None,
    policy: str = "memtierd",
    backend: str = "ipt",
    use_gpac: bool = True,
    max_batches: int = 4,
    budget: int = 64,
    slack: int = 1,
    windows_per_step: int = 0,
    strict_wps: bool = False,
    collect: tuple[str, ...] = ("hits", "near_blocks"),
    kernel_backend: str | None = None,
    arbitration_stride: int | None = None,
    device=None,
) -> tuple[ChurnState, dict]:
    """Drive every window of ``source`` through the steady-state churn
    engine: :func:`run`'s window loop and chunking (``windows_per_step``),
    with a :class:`ChurnState` carry and a deterministic fault schedule
    (``core.faults``) applied window by window: guests crash and restart
    through the activity mask, the near tier shrinks through the pressure
    controller, and telemetry windows drop. Results do not depend on the
    chunking; with ``faults=None`` and all lanes active the run is
    bit-identical to :func:`run`. A :class:`SynthTrace` keys each window's
    accesses on the absolute window index carried in ``cs.window``, so
    repeated calls continue the streams of one long run.

    Reads the carry's epoch, window and capacity from the device once per
    call. Returns ``(cs, series)``; beyond the collectors the series always
    carries ``active`` (bool[n_windows, n_guests]), ``near_cap`` and
    ``pressure`` (int32[n_windows])."""
    if not isinstance(cs, ChurnState):
        raise TypeError(
            f"run_churn needs a ChurnState carry (init_churn), got "
            f"{type(cs).__name__}")
    if mesh is not None:
        raise _not_ported("run_churn over a device mesh (mesh=)", 13)
    dev = _check_device(cs.state, device)
    source = _coerce_source(source)
    spec = _with_overrides(spec, kernel_backend, arbitration_stride)
    collect = _validate(spec, source, collect)
    n_w = source.n_windows
    if n_w == 0:
        return cs, {}
    epoch, w0, carried_cap = torch.stack(
        [cs.state.epoch, cs.window, cs.near_cap]).tolist()
    ft = _resolve_fault_tables(spec, carried_cap, faults, n_w, w0)
    feed = _window_feed(spec, source, dev, w0)
    wps = _round_wps(n_w, windows_per_step, strict_wps)
    chunks = []
    for s in range(0, n_w, wps):
        outs = []
        for w, acc in enumerate(feed(s, min(s + wps, n_w)), start=s):
            frow = dict(crash=ft.crash[w], restart=ft.restart[w],
                        near_cap=ft.near_cap[w], drop=bool(ft.drop[w]))
            cs, out = _churn_window(spec, cs, acc, frow, epoch, policy,
                                    backend, use_gpac, max_batches, budget,
                                    slack, collect)
            epoch += 1
            outs.append(out)
        chunks.append({k: torch.stack([o[k] for o in outs]).cpu().numpy()
                       for k in outs[0]})
    series = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    return cs, series


def step_churn(
    spec: EngineSpec,
    cs: ChurnState,
    accesses,  # int32[n_guests, k] guest-local ids, -1 padded
    *,
    faults_row: dict | None = None,
    mesh=None,
    policy: str = "memtierd",
    backend: str = "ipt",
    use_gpac: bool = True,
    max_batches: int = 4,
    budget: int = 64,
    slack: int = 1,
    collect: tuple[str, ...] = ("hits", "near_blocks"),
    arbitration_stride: int | None = None,
) -> tuple[ChurnState, dict]:
    """One churn window (:func:`step` dispatches here when handed a
    :class:`ChurnState`). ``faults_row`` injects this window's faults:
    optional keys ``crash`` / ``restart`` (bool[n_guests]), ``near_cap``
    (int; defaults to the capacity in force) and ``drop`` (bool). A
    no-fault step loop is bit-identical to :func:`run` and to one
    :func:`run_churn` call."""
    acc = (accesses.cpu().numpy() if isinstance(accesses, torch.Tensor)
           else np.asarray(accesses))
    if acc.ndim != 2 or acc.shape[0] != spec.n_guests:
        raise ValueError(
            f"accesses must be [n_guests={spec.n_guests}, k], got {acc.shape}")
    row = dict(faults_row or {})
    unknown = set(row) - {"crash", "restart", "near_cap", "drop"}
    if unknown:
        raise ValueError(
            f"unknown faults_row keys {sorted(unknown)} (valid: crash, "
            f"restart, near_cap, drop)")
    n_g = spec.n_guests
    crash = np.zeros((1, n_g), bool)
    crash[0] = np.asarray(row.get("crash", False), bool)
    restart = np.zeros((1, n_g), bool)
    restart[0] = np.asarray(row.get("restart", False), bool)
    cap = int(row["near_cap"]) if "near_cap" in row else int(cs.near_cap)
    ft = faults_mod.FaultTables(
        start=int(cs.window), crash=crash, restart=restart,
        near_cap=np.asarray([cap], np.int32),
        drop=np.asarray([bool(row.get("drop", False))]),
    )
    cs, series = run_churn(
        spec, cs, ArrayTrace(acc[:, None, :]), faults=ft, mesh=mesh,
        policy=policy, backend=backend, use_gpac=use_gpac,
        max_batches=max_batches, budget=budget, slack=slack, collect=collect,
        arbitration_stride=arbitration_stride, device=cs.state.device)
    return cs, {k: v[0] for k, v in series.items()}


# --------------------------------------------------------------------------
# sequential per-guest reference (the ragged equivalence oracle)
# --------------------------------------------------------------------------
def step_reference(
    spec: EngineSpec,
    state: TieredState,
    accesses: torch.Tensor,  # int32[n_guests, k] guest-local ids, -1 padded
    policy: str = "memtierd",
    backend: str = "ipt",
    use_gpac: bool = True,
    max_batches: int = 4,
    budget: int = 64,
) -> tuple[TieredState, dict]:
    """One window in the sequential formulation: each guest translates,
    records and runs its own GPAC daemon (confined to its segment by
    ``allow``/``hp_range``, with its own CL) one after another, through the
    spec's ``kernel_backend``. Kept as the equivalence oracle for
    :func:`step` / :func:`run` (the host tick ignores the stride, as in the
    reference)."""
    cfg = spec.cfg
    kb = spec.kernel_backend
    dev = state.device
    near_hits, far_hits = [], []
    logical_idx = torch.arange(cfg.n_logical, dtype=torch.int32, device=dev)
    for g in range(spec.n_guests):
        lo, _ = spec.logical_range(g)
        ids = torch.where(accesses[g] >= 0, accesses[g] + lo, -1)
        slot, _, valid = asp.translate(cfg, state, ids)
        near_hits.append((valid & (slot < cfg.n_near)).sum())
        far_hits.append((valid & (slot >= cfg.n_near)).sum())
        state = asp.record_accesses(cfg, state, ids, kernel_backend=kb)
    if use_gpac:
        for g in range(spec.n_guests):
            lo, hi = spec.logical_range(g)
            allow = (logical_idx >= lo) & (logical_idx < hi)
            state = gpac.gpac_maintenance(
                cfg, state, backend, max_batches, spec.guest_cl(g),
                allow=allow, hp_range=spec.hp_range(g), kernel_backend=kb)
    state = tiering.tick(cfg, state, policy, budget=budget, tiers=spec.tiers)
    near = allocated_hp_mask(cfg, state) & (state.block_table < cfg.n_near)
    near_blocks = [near[slice(*spec.hp_range(g))].sum() for g in range(spec.n_guests)]
    out = {k: torch.stack(v).to(torch.int32) for k, v in (
        ("near_hits", near_hits), ("far_hits", far_hits), ("near_blocks", near_blocks))}
    state = telemetry.end_window(cfg, state)
    return state, out


def run_reference(
    spec: EngineSpec,
    state: TieredState,
    traces: np.ndarray,
    *,
    device=None,
    **kw,
) -> tuple[TieredState, dict]:
    """Per-window driver over :func:`step_reference` (one host sync per
    window): the equivalence oracle for :func:`run` with the default
    ``("hits", "near_blocks")`` collectors. The state must live on
    ``device`` (CUDA unless named)."""
    dev = _check_device(state, device)
    traces = np.asarray(traces)
    n_g, n_w, _ = traces.shape
    series = {k: np.zeros((n_w, n_g), np.int32)
              for k in ("near_hits", "far_hits", "near_blocks")}
    acc = torch.from_numpy(np.ascontiguousarray(
        np.transpose(traces, (1, 0, 2)), dtype=np.int32)).to(dev)
    for w in range(n_w):
        state, out = step_reference(spec, state, acc[w], **kw)
        for k in series:
            series[k][w] = out[k].cpu().numpy()
    return state, series