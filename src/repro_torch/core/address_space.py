"""Two-level address translation and the data read/write paths (port of
``repro.core.address_space``).

    logical page  --gpt-->  gpa page  --(block_table on gpa//hp_ratio)-->  slot

Slots ``< n_near`` resolve into ``near_pool``, the rest into ``far_pool``.

Index semantics differ between the libraries, and the port masks
explicitly: jnp gathers clamp and ``.at[]`` scatters with ``mode="drop"``
ignore out-of-range indices, while torch raises on them. Every gather here
indexes with ids made safe first, and every dropping scatter selects its
in-range entries (or adds zero at a safe index) before it writes.

:func:`write_logical` writes the pools in place (see ``core.types``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import FREE, GpacConfig, TieredState
from repro_torch.kernels import registry as kernels

INT32_MIN = -(2**31)


def translate(cfg: GpacConfig, state: TieredState, logical: torch.Tensor):
    """logical page ids -> (slot, offset-within-block, valid mask)."""
    valid = (logical >= 0) & (logical < cfg.n_logical)
    gpa = state.gpt[torch.where(valid, logical, 0)]
    hp, off = gpa // cfg.hp_ratio, gpa % cfg.hp_ratio
    return state.block_table[hp], off, valid


def fused_translation(cfg: GpacConfig, state: TieredState) -> torch.Tensor:
    """Pre-composed logical page -> flat row of the (virtual) [near; far] row
    space: ``slot * hp_ratio + off``."""
    gpa = state.gpt
    hp, off = gpa // cfg.hp_ratio, gpa % cfg.hp_ratio
    return state.block_table[hp] * cfg.hp_ratio + off


def read_logical(cfg: GpacConfig, state: TieredState, logical: torch.Tensor) -> torch.Tensor:
    """dtype[*logical.shape, base_elems] payloads through the full
    translation; invalid ids read zeros. Gathers from each pool by mask,
    never from a concatenation of the two."""
    slot, off, valid = translate(cfg, state, logical)
    flat = slot * cfg.hp_ratio + off
    is_near = slot < cfg.n_near
    near_rows = state.near_pool.view(-1, cfg.base_elems)
    far_rows = state.far_pool.view(-1, cfg.base_elems)
    near = near_rows[torch.where(valid & is_near, flat, 0)]
    far = far_rows[torch.where(valid & ~is_near, flat - cfg.n_near * cfg.hp_ratio, 0)]
    rows = torch.where(is_near[..., None], near, far)
    return torch.where(valid[..., None], rows, 0)


def write_logical(
    cfg: GpacConfig, state: TieredState, logical: torch.Tensor, values: torch.Tensor,
) -> TieredState:
    """Scatter payloads through translation, in place; invalid ids drop."""
    slot, off, valid = translate(cfg, state, logical)
    to_near = valid & (slot < cfg.n_near)
    to_far = valid & (slot >= cfg.n_near)
    values = values.to(cfg.dtype)
    state.near_pool[slot[to_near], off[to_near]] = values[to_near]
    state.far_pool[slot[to_far] - cfg.n_near, off[to_far]] = values[to_far]
    return state


def record_accesses(
    cfg: GpacConfig, state: TieredState, logical: torch.Tensor,
    counts: torch.Tensor | None = None, kernel_backend: str = "auto",
) -> TieredState:
    """Charge accesses to guest (base-page) and host (huge-page) telemetry.

    A large unweighted batch (``2 * size >= n_logical``, the engine's case)
    goes through one access histogram; a small or weighted batch takes the
    per-access scatter, where a dropped access adds zero at index 0.
    """
    logical = logical.reshape(-1)
    valid = (logical >= 0) & (logical < cfg.n_logical)
    if counts is None and logical.numel() * 2 >= cfg.n_logical:
        return apply_access_histogram(
            cfg, state,
            access_histogram(cfg, logical, valid, kernel_backend),
            kernel_backend,
        )
    if counts is None:
        counts = torch.ones_like(logical, dtype=torch.int32)
    counts = torch.where(valid, counts.reshape(-1).to(torch.int32), 0)
    l_idx = torch.where(valid, logical, 0).long()
    guest = state.guest_counts.index_add(0, l_idx, counts)

    gpa = state.gpt[l_idx]
    hp = torch.where(valid, gpa // cfg.hp_ratio, 0).long()
    host = state.host_counts.index_add(0, hp, counts)
    touch = state.last_touch_epoch.scatter_reduce(
        0, hp, torch.where(valid, state.epoch, INT32_MIN), reduce="amax")

    slot = state.block_table[hp]
    near_hits = torch.where(valid & (slot < cfg.n_near), counts, 0).sum()
    far_hits = torch.where(valid & (slot >= cfg.n_near), counts, 0).sum()
    stats = dict(state.stats)
    stats["near_hits"] = stats["near_hits"] + near_hits.to(torch.int32)
    stats["far_hits"] = stats["far_hits"] + far_hits.to(torch.int32)
    return dataclasses.replace(
        state, guest_counts=guest, host_counts=host, last_touch_epoch=touch,
        stats=stats)


def access_histogram(
    cfg: GpacConfig, logical: torch.Tensor, valid: torch.Tensor | None = None,
    kernel_backend: str = "auto",
) -> torch.Tensor:
    """int32[n_logical] per-page access counts of an unweighted id batch
    (invalid ids land in the extra last bin, which is cut off)."""
    if valid is None:
        valid = (logical >= 0) & (logical < cfg.n_logical)
    flat = torch.where(valid, logical, cfg.n_logical).reshape(-1).to(torch.int32)
    ones = torch.ones_like(flat)
    return kernels.dispatch(
        "bincount", kernel_backend, flat, ones, cfg.n_logical + 1
    )[: cfg.n_logical]


def host_histogram(
    cfg: GpacConfig, gpt: torch.Tensor, h: torch.Tensor, kernel_backend: str = "auto",
) -> torch.Tensor:
    """int32[n_gpa_hp]: the huge-page access counts that a per-logical-page
    histogram ``h`` induces under the mapping ``gpt``."""
    return kernels.dispatch(
        "bincount", kernel_backend, gpt // cfg.hp_ratio, h, cfg.n_gpa_hp)


def apply_access_histogram(
    cfg: GpacConfig, state: TieredState, h: torch.Tensor, kernel_backend: str = "auto",
) -> TieredState:
    """Charge a full per-logical-page access histogram ``h`` to guest and
    host telemetry (exact int32 sums: bit-identical to the per-access path)."""
    hp_of = state.gpt // cfg.hp_ratio
    host_inc = host_histogram(cfg, state.gpt, h, kernel_backend)
    touch = torch.where(
        host_inc > 0,
        torch.maximum(state.last_touch_epoch, state.epoch),
        state.last_touch_epoch,
    )
    slot_of = state.block_table[hp_of]
    near_hits = torch.where(slot_of < cfg.n_near, h, 0).sum()
    far_hits = torch.where(slot_of >= cfg.n_near, h, 0).sum()
    stats = dict(state.stats)
    stats["near_hits"] = stats["near_hits"] + near_hits.to(torch.int32)
    stats["far_hits"] = stats["far_hits"] + far_hits.to(torch.int32)
    return dataclasses.replace(
        state,
        guest_counts=state.guest_counts + h,
        host_counts=state.host_counts + host_inc,
        last_touch_epoch=touch,
        stats=stats,
    )


def alloc_free_huge_region(
    cfg: GpacConfig, state: TieredState, hp_range: tuple | None = None,
) -> torch.Tensor:
    """int32[]: the first fully free huge page (optionally within
    ``hp_range=(lo, hi)``), or -1."""
    free = (state.rmap.view(cfg.n_gpa_hp, cfg.hp_ratio) == FREE).all(dim=1)
    if hp_range is not None:
        lo, hi = hp_range
        hp = torch.arange(cfg.n_gpa_hp, dtype=torch.int32, device=free.device)
        free = free & (hp >= lo) & (hp < hi)
    # argmax of uint8 returns the first maximum (argmax of bool is not
    # defined on every device)
    idx = torch.argmax(free.to(torch.uint8)).to(torch.int32)
    return torch.where(free.any(), idx, -1).to(torch.int32)
