"""Access-trace generators reproducing the paper's workload access shapes
(port of ``repro.data.traces``).

Each generator emits ``int32[n_windows, accesses_per_window]`` logical page
ids (-1 padded) whose skew structure matches the paper's Fig. 2 / Fig. 16
characterization of that workload. Every workload exists in two forms, tied
together by :func:`register_workload`:

* a **numpy generator** ``fn(TraceSpec, rng) -> int32[n_windows, k]``, a
  verbatim copy of the reference's, so the same spec gives the same trace in
  both packages; and
* a **window function** ``fn(WindowCtx) -> int32[rows, k]`` that makes ONE
  window's accesses for a batch of guests on the device (``engine.
  SynthTrace``). It draws from JAX's threefry streams (``data.prng``) keyed
  on the absolute window index, so it returns the JAX package's window
  function's accesses bit for bit, on the CPU and on the card, whatever the
  chunking.

RNG-key discipline: a guest's base key is ``fold_in(PRNGKey(seed), gid)``
with the global guest id; stream 0 (folded again with the window index)
drives per-window sampling and stream 1 seeds the fixed scatter
permutation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.data import prng
from repro_torch.kernels import runtime

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
# workload registry (numpy generator + on-device window function)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Workload:
    """One registered workload: the host-side numpy generator and
    (optionally) its on-device window function. ``needs_scatter``: the
    window function reads ``WindowCtx.scatter``, so synthesis setup builds
    the scatter tables only when some bound workload asks for them."""

    name: str
    numpy_fn: Callable
    window_fn: Callable | None = None
    needs_scatter: bool = False


_WORKLOADS: dict[str, Workload] = {}


def register_workload(
    name: str,
    numpy_fn: Callable,
    window_fn: Callable | None = None,
    needs_scatter: bool = False,
) -> Workload:
    """Register a workload's numpy generator and (optionally) its window
    function; duplicates raise, unknown names raise listing the live set."""
    if name in _WORKLOADS:
        raise ValueError(f"workload {name!r} already registered")
    wl = Workload(name, numpy_fn, window_fn, needs_scatter)
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


# --------------------------------------------------------------------------
# on-device synthesis (window functions, engine.SynthTrace)
# --------------------------------------------------------------------------
# Key streams off a guest's base key: stream 0 is folded again with the
# absolute window index for per-window draws; stream 1 seeds the guest's
# fixed scatter permutation.
_WINDOW_STREAM = 0
_SCATTER_STREAM = 1


@dataclasses.dataclass
class WindowCtx:
    """Inputs of one window function, for a batch of ``rows`` guests.

    ``key`` (``int64[rows, 2]``) is already folded with the absolute window
    index ``w``; ``n_logical`` (``int64[rows]``) is each guest's size;
    ``scatter`` (``int64[rows, max_logical]``) holds each guest's fixed
    scatter table -- a uniform permutation of ``[0, n_logical)`` in its
    first ``n_logical`` entries, so a prefix ``scatter[:n_hot]`` is
    ``n_hot`` distinct pages spread over the whole logical space -- or is
    None when no bound workload needs it. Integer values follow int32
    arithmetic (they are carried in int64 and wrapped where int32 would)."""

    key: torch.Tensor
    w: int
    n_logical: torch.Tensor
    scatter: torch.Tensor | None
    k: int
    hp_ratio: int
    partitionable: bool = True


@dataclasses.dataclass(frozen=True)
class SynthPlan:
    """Static half of a bound on-device synthesis: the distinct workload set
    and the shapes. ``partitionable`` is JAX's threefry bit layout
    (``data.prng``) the streams reproduce."""

    workload_set: tuple[str, ...]
    accesses_per_window: int
    hp_ratio: int
    max_logical: int
    partitionable: bool = True

    def __post_init__(self):
        for name in self.workload_set:
            if get_workload(name).window_fn is None:
                raise ValueError(
                    f"workload {name!r} has no on-device window function; "
                    f"generate it host-side (engine.ArrayTrace) instead"
                )


def guest_base_key(seed: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """The per-guest base keys: global guest id folded into the seed key
    (``seed`` / ``gid`` int tensors on the device, one per guest)."""
    return prng.fold_in(prng.PRNGKey(seed, device=seed.device), gid.clamp(min=0))


def guest_scatter(key: torch.Tensor, n_logical: torch.Tensor, max_logical: int,
                  partitionable: bool = True) -> torch.Tensor:
    """``int64[rows, max_logical]``: per row a uniform permutation of ``[0,
    n_logical)`` in the first ``n_logical`` entries (permute the padded range
    and stably move the in-range values to the front)."""
    p = prng.permutation(key, max_logical, partitionable).to(torch.int64)
    order = torch.argsort((p >= n_logical[:, None]).to(torch.int8), dim=-1, stable=True)
    return torch.gather(p, -1, order)


def _f32_mul_trunc(x: torch.Tensor, c) -> torch.Tensor:
    """``(x.astype(float32) * c).astype(int32)``: the float32 product,
    exactly rounded (computed in float64, rounded once), then truncated."""
    return _f32_mul(x, c).to(torch.int64)


def _f32_mul(x: torch.Tensor, c) -> torch.Tensor:
    """``x.astype(float32) * c`` in float32, exactly rounded."""
    xf = x.to(torch.float32).to(torch.float64)
    return (xf * float(np.float32(c))).to(torch.float32)


def _n_hot(ctx: WindowCtx, hot_fraction: float) -> torch.Tensor:
    return _f32_mul_trunc(ctx.n_logical, hot_fraction).clamp(min=1)


def _gaussian_keys(ctx: WindowCtx, sigma: torch.Tensor) -> torch.Tensor:
    """``abs(normal * sigma).astype(int32)`` (``sigma`` float32 per row)."""
    z = prng.normal(ctx.key, (ctx.k,), ctx.partitionable).to(torch.float64)
    prod = (z * sigma.to(torch.float64)[:, None]).to(torch.float32)
    return prod.abs().to(torch.int64)


def _sigma(n: torch.Tensor, div: float) -> torch.Tensor:
    """``n.astype(float32) / div`` in float32, exactly rounded (the divisor a
    tensor: CUDA divides by a scalar as a multiply by its reciprocal)."""
    nf = n.to(torch.float32).to(torch.float64)
    return (nf / torch.full_like(nf, float(np.float32(div)))).to(torch.float32)


def _j_popularity(ctx: WindowCtx, sample, hot_fraction: float, drift: float = 0.0):
    """Port of the reference's window body: sample keys from the popularity
    distribution, optionally drift the center, scatter onto the guest's
    fixed hot-set permutation."""
    n_hot = _n_hot(ctx, hot_fraction)
    keys = sample(ctx, n_hot)
    if drift:
        wd = float(np.float32(np.float32(ctx.w) * np.float32(drift)))
        keys = keys + _f32_mul_trunc(n_hot, wd)[:, None]
    nh = n_hot[:, None]
    idx = torch.remainder(keys, nh).clamp(min=0).minimum(nh - 1)
    return torch.gather(ctx.scatter, 1, idx)


def masim_window(ctx: WindowCtx):
    n_hp = (ctx.n_logical // ctx.hp_ratio).clamp(min=1)[:, None]
    idx = (torch.arange(ctx.k, device=ctx.key.device) + ctx.w) % n_hp
    return (idx * ctx.hp_ratio) % ctx.n_logical.clamp(min=1)[:, None]


def redis_window(ctx: WindowCtx):
    def sample(c, n_hot):
        return _gaussian_keys(c, _sigma(n_hot, 3.0))

    return _j_popularity(ctx, sample, hot_fraction=0.08, drift=0.005)


def memcached_window(ctx: WindowCtx):
    def sample(c, n_hot):
        return _gaussian_keys(c, _sigma(n_hot, 2.5))

    return _j_popularity(ctx, sample, hot_fraction=0.15)


def hash_window(ctx: WindowCtx):
    def sample(c, n_hot):
        return prng.randint(c.key, (c.k,), 0, n_hot, c.partitionable).to(torch.int64)

    return _j_popularity(ctx, sample, hot_fraction=0.30)


def _j_drift(ctx: WindowCtx, sample, hot_fraction: float, period: int, rotate: float):
    """Port of the reference's phase-shifting window body: the shift depends
    only on the absolute window index."""
    n_hot = _n_hot(ctx, hot_fraction)
    keys = sample(ctx, n_hot)
    n = ctx.n_logical.clamp(min=1)
    step = _f32_mul_trunc(n_hot, rotate).clamp(min=1)
    shift = prng.wrap_i32((ctx.w // period) * step) % n
    nh = n_hot[:, None]
    idx = (torch.remainder(keys, nh).clamp(min=0).minimum(nh - 1) + shift[:, None]) % n[:, None]
    return torch.gather(ctx.scatter, 1, idx)


def redis_drift_window(ctx: WindowCtx):
    def sample(c, n_hot):
        return _gaussian_keys(c, _sigma(n_hot, 3.0))

    return _j_drift(ctx, sample, hot_fraction=0.08, period=2, rotate=0.5)


def hash_drift_window(ctx: WindowCtx):
    def sample(c, n_hot):
        return prng.randint(c.key, (c.k,), 0, n_hot, c.partitionable).to(torch.int64)

    return _j_drift(ctx, sample, hot_fraction=0.30, period=4, rotate=0.5)


def _stride_positions(k: int, n: torch.Tensor) -> torch.Tensor:
    """``int64[rows, k]``: the reference's ``i * (n // k) + (i * (n % k)) //
    k`` in int32 arithmetic, wraps included. It equals ``floor(i * n / k)``
    only while ``i * (n % k)`` fits in int32; for k above 46,340 the
    reference's product wraps negative and so does this one, on purpose:
    the port returns the reference's accesses, not the intended ones."""
    i = torch.arange(k, dtype=torch.int64, device=n.device)
    n = n[:, None]
    a = prng.wrap_i32(i * torch.div(n, k, rounding_mode="floor"))
    b = prng.wrap_i32(i * torch.remainder(n, k))
    return prng.wrap_i32(a + torch.div(b, k, rounding_mode="floor"))


def ocean_ncp_window(ctx: WindowCtx):
    span = _f32_mul_trunc(ctx.n_logical, 0.6).clamp(min=1)
    start = prng.randint(ctx.key, (), 0, (ctx.n_logical - span).clamp(min=1),
                         ctx.partitionable).to(torch.int64)
    idx = prng.wrap_i32(_stride_positions(ctx.k, torch.div(span, 2, rounding_mode="floor")) * 2)
    base = (torch.div(start, 2, rounding_mode="floor") * 2)[:, None]
    return prng.wrap_i32(base + idx).clamp(min=0).minimum(ctx.n_logical[:, None] - 1)


def liblinear_window(ctx: WindowCtx):
    idx = _stride_positions(ctx.k, ctx.n_logical)
    return idx.clamp(min=0).minimum(ctx.n_logical[:, None] - 1)


def zipf_window(ctx: WindowCtx, a: float = 1.2):
    def sample(c, n_hot):
        u = prng.uniform(c.key, (c.k,), 1e-7, 1.0, c.partitionable)
        # the reference's inverse-power transform, clipped in float before
        # the int cast; powf is the float32 pow its CPU backend computes
        x = prng.powf(u, -1.0 / (a - 1.0)).clamp(1.0, 2.0**30)
        return x.to(torch.int64) - 1

    return _j_popularity(ctx, sample, hot_fraction=1.0)


def uniform_window(ctx: WindowCtx):
    def sample(c, n_hot):
        return prng.randint(c.key, (c.k,), 0, c.n_logical.clamp(min=1),
                            c.partitionable).to(torch.int64)

    return _j_popularity(ctx, sample, hot_fraction=1.0)


def gauss_window(ctx: WindowCtx, rel_sigma: float = 0.05):
    def sample(c, n_hot):
        return _gaussian_keys(c, _f32_mul(c.n_logical, rel_sigma))

    return _j_popularity(ctx, sample, hot_fraction=1.0)


def synth_setup(plan: SynthPlan, tables: dict, device=None) -> dict:
    """Device-side setup of a bound synthesis: per-guest window-stream keys
    and (when some workload needs one) the fixed scatter permutations.
    ``tables`` holds the per-guest rows (``seeds``, ``gids``, ``wid``,
    ``n_logical``, numpy or tensors); every derived value depends only on
    (seed, global gid). Deterministic, so a driver may build it once per
    call. The rows of each workload are grouped here, on the host."""
    dev = runtime.resolve_device(device)
    t = {k: torch.as_tensor(np.asarray(v), dtype=torch.int64, device=dev)
         for k, v in tables.items()}
    base = guest_base_key(t["seeds"], t["gids"])
    win_base = prng.fold_in(base, _WINDOW_STREAM)
    scatter = None
    if any(get_workload(n).needs_scatter for n in plan.workload_set):
        sc_keys = prng.fold_in(base, _SCATTER_STREAM)
        scatter = guest_scatter(sc_keys, t["n_logical"], plan.max_logical,
                                plan.partitionable)
    wid, gids = np.asarray(tables["wid"]), np.asarray(tables["gids"])
    groups = [(j, torch.from_numpy(np.nonzero((wid == j) & (gids >= 0))[0]).to(dev))
              for j in range(len(plan.workload_set))]
    return dict(win_base=win_base, scatter=scatter, n_logical=t["n_logical"],
                groups=[(j, rows) for j, rows in groups if rows.numel()])


def synth_accesses(plan: SynthPlan, setup: dict, w: int) -> torch.Tensor:
    """int32[n_rows, k] guest-local accesses of window ``w``, made on the
    setup's device. Each workload runs on its own rows only (rows are
    independent, so this equals the reference's run-every-workload-and-
    select); rows with ``gid < 0`` emit all ``-1`` no-ops."""
    win_base = setup["win_base"]
    out = torch.full((win_base.shape[0], plan.accesses_per_window), -1,
                     dtype=torch.int32, device=win_base.device)
    for j, rows in setup["groups"]:
        sc = setup["scatter"]
        ctx = WindowCtx(
            key=prng.fold_in(win_base[rows], int(w)), w=int(w),
            n_logical=setup["n_logical"][rows],
            scatter=None if sc is None else sc[rows],
            k=plan.accesses_per_window, hp_ratio=plan.hp_ratio,
            partitionable=plan.partitionable,
        )
        out[rows] = get_workload(plan.workload_set[j]).window_fn(ctx).to(torch.int32)
    return out


def synth_generate(spec: TraceSpec, gid: int = 0, *, partitionable: bool = True,
                   device=None) -> np.ndarray:
    """Materialize the window functions' full trace ``int32[n_windows, k]``
    on the host (the engine never does; ``engine.SynthTrace`` makes each
    window on the device)."""
    plan = SynthPlan(
        workload_set=(spec.workload,),
        accesses_per_window=spec.accesses_per_window,
        hp_ratio=spec.hp_ratio,
        max_logical=spec.n_logical,
        partitionable=partitionable,
    )
    tables = dict(seeds=[spec.seed], gids=[gid], wid=[0], n_logical=[spec.n_logical])
    setup = synth_setup(plan, tables, device)
    rows = [synth_accesses(plan, setup, w)[0].cpu().numpy() for w in range(spec.n_windows)]
    return np.stack(rows) if rows else np.zeros((0, spec.accesses_per_window), np.int32)


register_workload("masim", masim, masim_window)
register_workload("redis", redis, redis_window, needs_scatter=True)
register_workload("memcached", memcached, memcached_window, needs_scatter=True)
register_workload("hash", hash_workload, hash_window, needs_scatter=True)
register_workload("ocean_ncp", ocean_ncp, ocean_ncp_window)
register_workload("liblinear", liblinear, liblinear_window)
register_workload("redis_drift", redis_drift, redis_drift_window, needs_scatter=True)
register_workload("hash_drift", hash_drift, hash_drift_window, needs_scatter=True)
register_workload("zipf", zipf, zipf_window, needs_scatter=True)
register_workload("uniform", uniform, uniform_window, needs_scatter=True)
register_workload("gauss", gauss, gauss_window, needs_scatter=True)


# Paper Table 2 guest RSS (GB) and Table 3 CL per workload -- used by the
# benchmarks to scale simulations proportionally.
PAPER_RSS_GB = dict(masim=9.8, redis=12.5, memcached=11.0, hash=8.8, ocean_ncp=5.5)
PAPER_CL = dict(masim=10, redis=50, memcached=100, hash=250, ocean_ncp=290)
PAPER_SELECTED_PAGES = dict(
    masim=4_142, redis=93_896, memcached=174_068, hash=307_484, ocean_ncp=950_758
)
