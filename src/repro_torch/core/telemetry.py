"""Guest-side telemetry: pluggable hotness classifiers (port of
``repro.core.telemetry``).

Every backend maps raw per-window access counts to a ``bool[n_logical]``
hot mask; the host only ever sees huge-page counts: ``ipt``, ``pebs``
(counts subsampled by ``jax.random.binomial``'s streams, ``data.prng``) and
``damon``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core.types import GpacConfig, TieredState
from repro_torch.data import prng
from repro_torch.kernels import registry as kernels

_BACKENDS: dict[str, Callable] = {}


def register_backend(name: str, fn: Callable | None = None):
    """Register a hotness classifier ``fn(cfg, state, **kw) ->
    bool[n_logical]``; usable as ``@register_backend("name")``."""
    if fn is None:
        return lambda f: register_backend(name, f)
    if name in _BACKENDS:
        raise ValueError(f"telemetry backend {name!r} already registered")
    _BACKENDS[name] = fn
    return fn


def backends() -> tuple[str, ...]:
    return tuple(_BACKENDS)


def end_window(cfg: GpacConfig, state: TieredState) -> TieredState:
    """Fold this window's counts into the bit histories (the uint8 shift
    drops the oldest bit) and clear them."""
    hist = (state.ipt_hist << 1) | (state.guest_counts > 0).to(torch.uint8)
    h_hist = (state.host_hist << 1) | (state.host_counts > 0).to(torch.uint8)
    return dataclasses.replace(
        state,
        ipt_hist=hist,
        host_hist=h_hist,
        guest_counts=torch.zeros_like(state.guest_counts),
        host_counts=torch.zeros_like(state.host_counts),
        epoch=state.epoch + 1,
    )


@functools.lru_cache(maxsize=None)
def _popcount_table(device: torch.device) -> torch.Tensor:
    """Set bits of every uint8 value: torch has no popcount op."""
    return torch.tensor([bin(v).count("1") for v in range(256)],
                        dtype=torch.int32, device=device)


def _popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """int32 set-bit count of each uint8 history word (a table lookup)."""
    return _popcount_table(x.device)[x.long()]


def hot_mask_ipt(cfg: GpacConfig, state: TieredState) -> torch.Tensor:
    """Hot iff accessed in >= ipt_min_hits of the last ipt_windows windows
    (including the in-flight window)."""
    mask = (1 << min(cfg.ipt_windows, 8)) - 1
    hits = _popcount_u8(state.ipt_hist & mask)
    hits = hits + (state.guest_counts > 0).to(torch.int32)
    return hits >= cfg.ipt_min_hits


def hot_mask_pebs(
    cfg: GpacConfig, state: TieredState, key: torch.Tensor | None = None,
    rate: float = 0.25,
) -> torch.Tensor:
    """Sampled-counter hotness: a binomial subsample of this window's counts
    at ``rate``, thresholded at ``max(1, int(hot_threshold * rate))``. The
    key defaults to ``fold_in(PRNGKey(0), epoch)``, so runs are
    reproducible; the draws take JAX's current default threefry layout
    (``jax_threefry_partitionable`` True)."""
    if key is None:
        key = prng.fold_in(prng.PRNGKey(0, device=state.device), state.epoch)
    sampled = prng.binomial(key, state.guest_counts.to(torch.float32), rate).to(torch.int32)
    return sampled >= max(1, int(cfg.hot_threshold * rate))


def hot_mask_damon(
    cfg: GpacConfig, state: TieredState, region_pages: int = 64,
) -> torch.Tensor:
    """Region-granular estimate: a region is hot if its mean count crosses
    the threshold; every page inherits its region's verdict."""
    n = state.guest_counts.shape[0]
    pad = (-n) % region_pages
    c = torch.nn.functional.pad(state.guest_counts, (0, pad)).view(-1, region_pages)
    sums = c.to(torch.float32).sum(dim=1)
    # divide by a tensor, not a Python scalar: a scalar divisor may become a
    # multiply by its reciprocal, which is not jnp.mean's rounding
    mean = sums / torch.full_like(sums, region_pages)
    region_hot = mean >= cfg.hot_threshold
    return region_hot.repeat_interleave(region_pages)[:n]


register_backend("ipt", hot_mask_ipt)
register_backend("pebs", hot_mask_pebs)
register_backend("damon", hot_mask_damon)


def hot_mask(cfg: GpacConfig, state: TieredState, backend: str = "ipt", **kw) -> torch.Tensor:
    """Dispatch to a registered hotness classifier by name."""
    try:
        fn = _BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown telemetry backend {backend!r} (have {backends()})"
        ) from None
    return fn(cfg, state, **kw)


def hot_subpages_per_hp(
    cfg: GpacConfig, state: TieredState, hot: torch.Tensor, kernel_backend: str = "auto",
) -> torch.Tensor:
    """int32[n_gpa_hp]: hot base pages inside each huge page, through rmap
    so that unallocated gpa pages never count (the hot_count kernel)."""
    hot_gpa = torch.where(state.rmap >= 0, hot[state.rmap.clamp(min=0)], False)
    return kernels.dispatch("hot_count", kernel_backend, hot_gpa, cfg.hp_ratio)


def accessed_subpages_per_hp(
    cfg: GpacConfig, state: TieredState, kernel_backend: str = "auto",
) -> torch.Tensor:
    """int32[n_gpa_hp]: accessed (count > 0) base pages per huge page."""
    acc = state.guest_counts > 0
    acc_gpa = torch.where(state.rmap >= 0, acc[state.rmap.clamp(min=0)], False)
    return kernels.dispatch("hot_count", kernel_backend, acc_gpa, cfg.hp_ratio)
