"""Access-trace generators reproducing the paper's workload access shapes
(port of the numpy half of ``repro.data.traces``).

Each generator emits ``int32[n_windows, accesses_per_window]`` logical page
ids (-1 padded) whose skew structure matches the paper's Fig. 2 / Fig. 16
characterization of that workload. The numpy generators, ``TraceSpec``, the
workload registry and ``generate`` are a verbatim copy of the reference, so
the same spec gives the same trace in both packages. The on-device window
functions behind ``SynthTrace`` need JAX's threefry generator in torch and
are not ported yet (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

WORKLOADS = ("masim", "redis", "memcached", "hash", "ocean_ncp", "liblinear")


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    workload: str
    n_logical: int
    hp_ratio: int = 512
    n_windows: int = 32
    accesses_per_window: int = 4096
    seed: int = 0


def _trim(ids: np.ndarray, lo: int, hi: int) -> np.ndarray:
    return np.clip(ids, lo, hi - 1).astype(np.int32)


def _perm(n: int, rng: np.random.Generator) -> np.ndarray:
    """Fixed scatter permutation: maps a compact hot set onto pages spread
    across the whole logical space (what malloc fragmentation does)."""
    return rng.permutation(n).astype(np.int32)


def masim(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    """One hot page per huge-page boundary, round-robin over them."""
    n_hp = max(1, spec.n_logical // spec.hp_ratio)
    hot = (np.arange(n_hp, dtype=np.int32) * spec.hp_ratio) % spec.n_logical
    k = spec.accesses_per_window
    out = np.empty((spec.n_windows, k), np.int32)
    for w in range(spec.n_windows):
        out[w] = hot[(np.arange(k) + w) % n_hp]
    return out


def _popularity_trace(
    spec: TraceSpec,
    rng: np.random.Generator,
    sampler,
    hot_fraction: float,
    drift: float = 0.0,
) -> np.ndarray:
    """Common shape for kv-store workloads: a popularity distribution over a
    compact key space, scattered over the logical space by a permutation.
    ``drift``: popularity center moves by this fraction of the hot range per
    window (key-popularity churn -- what drives the paper's Fig. 11
    promotion/demotion traffic)."""
    n_hot = max(1, int(spec.n_logical * hot_fraction))
    scatter = _perm(spec.n_logical, rng)[:n_hot]
    out = np.empty((spec.n_windows, spec.accesses_per_window), np.int32)
    for w in range(spec.n_windows):
        keys = sampler(rng, spec.accesses_per_window)
        if drift:
            keys = keys + int(w * drift * n_hot)
        out[w] = scatter[_trim(keys % n_hot, 0, n_hot)]
    return out


def redis(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    """Gaussian key popularity (the paper's Memtier config), ~8% of pages
    hot, with slow popularity drift (Fig. 6's moving hot region)."""
    def sampler(r, k):
        n_hot = max(1, int(spec.n_logical * 0.08))
        return np.abs(r.normal(0.0, n_hot / 3.0, size=k)).astype(np.int64)

    # drift ~3 pages/window: slow churn relative to the maintenance cadence
    # (the paper's daemons converge faster than key-popularity drift)
    return _popularity_trace(spec, rng, sampler, hot_fraction=0.08,
                             drift=0.005)


def memcached(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    """Wider Gaussian: ~15% of pages touched, <100/512 per huge page hot."""
    def sampler(r, k):
        n_hot = max(1, int(spec.n_logical * 0.15))
        return np.abs(r.normal(0.0, n_hot / 2.5, size=k)).astype(np.int64)

    return _popularity_trace(spec, rng, sampler, hot_fraction=0.15)


def hash_workload(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    """hash_bkt_rcu: uniform over ~30% of pages (bucket arrays + nodes),
    giving the Fig. 16b ~150-hot-subpages-per-huge-page mode."""
    def sampler(r, k):
        n_hot = max(1, int(spec.n_logical * 0.30))
        return r.integers(0, n_hot, size=k)

    return _popularity_trace(spec, rng, sampler, hot_fraction=0.30)


def _drift_trace(
    spec: TraceSpec,
    rng: np.random.Generator,
    sampler,
    hot_fraction: float,
    period: int,
    rotate: float,
) -> np.ndarray:
    """Phase-shifting variant of :func:`_popularity_trace`: every ``period``
    windows the hot set jumps by ``rotate * n_hot`` positions along the full
    scatter permutation, so the *set of hot pages itself* turns over (the
    churn benchmark's drifting tenants), not just the popularity center
    within a fixed hot set (the ``drift=`` knob above). Promotions made for
    one phase go cold wholesale at the next shift -- worst case for the
    pressure controller's coldest-first demotion."""
    n_hot = max(1, int(spec.n_logical * hot_fraction))
    scatter = _perm(spec.n_logical, rng)
    step = max(1, int(n_hot * rotate))
    out = np.empty((spec.n_windows, spec.accesses_per_window), np.int32)
    for w in range(spec.n_windows):
        keys = sampler(rng, spec.accesses_per_window)
        shift = ((w // period) * step) % spec.n_logical
        out[w] = scatter[(_trim(keys % n_hot, 0, n_hot) + shift) % spec.n_logical]
    return out


def redis_drift(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    """redis whose hot set rotates by half its width every 2 windows:
    Gaussian popularity over a compact window that slides along the scatter
    permutation (phase-change churn rather than slow center drift)."""
    def sampler(r, k):
        n_hot = max(1, int(spec.n_logical * 0.08))
        return np.abs(r.normal(0.0, n_hot / 3.0, size=k)).astype(np.int64)

    return _drift_trace(spec, rng, sampler, hot_fraction=0.08,
                        period=2, rotate=0.5)


def hash_drift(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    """hash_bkt_rcu under rehashing: the uniform ~30% hot set jumps by half
    its width every 4 windows (bucket array reallocated elsewhere)."""
    def sampler(r, k):
        n_hot = max(1, int(spec.n_logical * 0.30))
        return r.integers(0, n_hot, size=k)

    return _drift_trace(spec, rng, sampler, hot_fraction=0.30,
                        period=4, rotate=0.5)


def ocean_ncp(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    """Grid sweeps touching every other page of ~60%-of-space runs: the
    W-cycle multigrid stencil reads alternate rows at each level, so huge
    pages are ~50% internally hot -- dense-ish but still under ocean's high
    CL (290/512 in Table 3; Table 3 selects 950k of its pages)."""
    out = np.empty((spec.n_windows, spec.accesses_per_window), np.int32)
    span = max(1, int(spec.n_logical * 0.6))
    for w in range(spec.n_windows):
        start = rng.integers(0, max(1, spec.n_logical - span))
        idx = (np.arange(spec.accesses_per_window, dtype=np.int64)
               * (span // 2)) // spec.accesses_per_window * 2  # stride-2
        out[w] = _trim((start // 2) * 2 + idx, 0, spec.n_logical)
    return out


def liblinear(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    """Dense streaming over the full working set: every page hot (no skew)."""
    out = np.empty((spec.n_windows, spec.accesses_per_window), np.int32)
    for w in range(spec.n_windows):
        out[w] = _trim(
            (np.arange(spec.accesses_per_window, dtype=np.int64)
             * spec.n_logical) // spec.accesses_per_window,
            0, spec.n_logical)
    return out


def zipf(spec: TraceSpec, rng: np.random.Generator, a: float = 1.2) -> np.ndarray:
    def sampler(r, k):
        return r.zipf(a, size=k) - 1

    return _popularity_trace(spec, rng, sampler, hot_fraction=1.0)


def uniform(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    def sampler(r, k):
        return r.integers(0, spec.n_logical, size=k)

    return _popularity_trace(spec, rng, sampler, hot_fraction=1.0)


def gauss(spec: TraceSpec, rng: np.random.Generator, rel_sigma: float = 0.05):
    def sampler(r, k):
        return np.abs(r.normal(0, spec.n_logical * rel_sigma, size=k)).astype(np.int64)

    return _popularity_trace(spec, rng, sampler, hot_fraction=1.0)

# --------------------------------------------------------------------------
# workload registry
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Workload:
    """One registered workload: its host-side numpy generator."""

    name: str
    numpy_fn: Callable


_WORKLOADS: dict[str, Workload] = {}


def register_workload(name: str, numpy_fn: Callable) -> Workload:
    """Register a workload's numpy generator; duplicates raise, unknown
    names raise listing the live set."""
    if name in _WORKLOADS:
        raise ValueError(f"workload {name!r} already registered")
    wl = Workload(name, numpy_fn)
    _WORKLOADS[name] = wl
    return wl


def get_workload(name: str) -> Workload:
    try:
        return _WORKLOADS[name]
    except KeyError:
        raise ValueError(
            f"unknown workload {name!r} (have {workloads()})"
        ) from None


def workloads() -> tuple[str, ...]:
    return tuple(_WORKLOADS)


def generate(spec: TraceSpec, **kw) -> np.ndarray:
    """int32[n_windows, accesses_per_window] logical page ids (numpy
    reference path)."""
    return get_workload(spec.workload).numpy_fn(
        spec, np.random.default_rng(spec.seed), **kw
    )


register_workload("masim", masim)
register_workload("redis", redis)
register_workload("memcached", memcached)
register_workload("hash", hash_workload)
register_workload("ocean_ncp", ocean_ncp)
register_workload("liblinear", liblinear)
register_workload("redis_drift", redis_drift)
register_workload("hash_drift", hash_drift)
register_workload("zipf", zipf)
register_workload("uniform", uniform)
register_workload("gauss", gauss)


# Paper Table 2 guest RSS (GB) and Table 3 CL per workload -- used by the
# benchmarks to scale simulations proportionally.
PAPER_RSS_GB = dict(masim=9.8, redis=12.5, memcached=11.0, hash=8.8, ocean_ncp=5.5)
PAPER_CL = dict(masim=10, redis=50, memcached=100, hash=250, ocean_ncp=290)
PAPER_SELECTED_PAGES = dict(
    masim=4_142, redis=93_896, memcached=174_068, hash=307_484, ocean_ncp=950_758
)
