"""Static configuration and state of the GPAC tiered-memory core (port of
``repro.core.types``).

Terminology (logical page, gpa page, huge page, host slot) is the JAX
package's. The state is a dataclass of tensors with the reference's dtypes on
every leaf: int32 everywhere, uint8 bit histories, int32 0-d stats.

Unlike the functional reference, functions that take and return a
:class:`TieredState` may update the tensors of the state they are handed in
place -- always the two payload pools, which are 16.8 GB at the paper's
Redis size and cannot be cloned each window. Callers treat the state they
pass in as consumed and go on with the one returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import runtime

FREE = -1  # sentinel for unallocated rmap / owner entries

STAT_KEYS = (
    "consolidated_pages",
    "consolidation_calls",
    "consolidation_enomem",
    "copied_bytes",
    "promoted_blocks",
    "demoted_blocks",
    "near_hits",
    "far_hits",
    "tlb_shootdowns",
)


@dataclasses.dataclass(frozen=True)
class GpacConfig:
    """Static geometry + policy knobs of one guest's tiered address space
    (the reference's own copy, with ``dtype`` a torch dtype)."""

    n_logical: int
    hp_ratio: int = 512
    n_gpa_hp: int = 0
    n_near: int = 0
    base_elems: int = 8
    hot_threshold: int = 1
    cl: int = 64
    ipt_windows: int = 8
    ipt_min_hits: int = 1
    reconsolidate_cooldown: int = 2
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.n_logical < 1:
            raise ValueError(f"n_logical must be >= 1, got {self.n_logical}")
        if self.hp_ratio < 1:
            raise ValueError(f"hp_ratio must be >= 1, got {self.hp_ratio}")
        need = -(-self.n_logical // self.hp_ratio)  # ceil
        if self.n_gpa_hp == 0:
            object.__setattr__(self, "n_gpa_hp", need + max(2, need // 4))
        if self.n_near == 0:
            object.__setattr__(self, "n_near", max(1, self.n_gpa_hp // 2))
        if self.n_gpa_hp * self.hp_ratio < self.n_logical:
            raise ValueError(
                f"GPA space smaller than logical space: n_gpa_hp={self.n_gpa_hp}"
                f" x hp_ratio={self.hp_ratio} = {self.n_gpa_hp * self.hp_ratio}"
                f" gpa pages cannot cover n_logical={self.n_logical}"
            )
        if not (0 < self.n_near < self.n_gpa_hp):
            raise ValueError(
                f"need 0 < n_near < n_gpa_hp (a non-empty far tier), got "
                f"n_near={self.n_near}, n_gpa_hp={self.n_gpa_hp}"
            )
        if not (1 <= self.cl <= self.hp_ratio):
            raise ValueError(
                f"Consolidation Limit must be in [1, hp_ratio={self.hp_ratio}]"
                f", got cl={self.cl}"
            )

    @property
    def n_gpa(self) -> int:
        return self.n_gpa_hp * self.hp_ratio

    @property
    def n_far(self) -> int:
        return self.n_gpa_hp - self.n_near

    @property
    def n_slots(self) -> int:
        return self.n_gpa_hp

    @property
    def base_bytes(self) -> int:
        return self.base_elems * self.dtype.itemsize

    @property
    def hp_bytes(self) -> int:
        return self.base_bytes * self.hp_ratio


@dataclasses.dataclass
class TieredState:
    """One address space's two-level mapping, host placement, payload pools,
    telemetry and running stats (fields and invariants as in the reference)."""

    gpt: torch.Tensor  # int32[n_logical]  logical -> gpa page
    rmap: torch.Tensor  # int32[n_gpa]      gpa page -> logical | FREE
    block_table: torch.Tensor  # int32[n_gpa_hp]  huge page -> slot
    slot_owner: torch.Tensor  # int32[n_slots]   slot -> huge page
    near_pool: torch.Tensor  # dtype[n_near, hp_ratio, base_elems]
    far_pool: torch.Tensor  # dtype[n_far,  hp_ratio, base_elems]
    guest_counts: torch.Tensor  # int32[n_logical]
    ipt_hist: torch.Tensor  # uint8[n_logical]
    host_counts: torch.Tensor  # int32[n_gpa_hp]
    host_hist: torch.Tensor  # uint8[n_gpa_hp]
    last_touch_epoch: torch.Tensor  # int32[n_gpa_hp]
    region_epoch: torch.Tensor  # int32[n_gpa_hp] (-1 never consolidated)
    epoch: torch.Tensor  # int32[]
    stats: dict  # name -> int32[] running counters (STAT_KEYS)

    @property
    def device(self) -> torch.device:
        return self.gpt.device


def init_state(
    cfg: GpacConfig, fill: torch.Tensor | None = None, device=None,
) -> TieredState:
    """Fresh identity-mapped state on ``device`` (CUDA unless named):
    logical page ``l`` at gpa page ``l``, huge page ``h`` at slot ``h``.
    ``fill``: optional dtype[n_logical, base_elems] initial payload."""
    dev = runtime.resolve_device(device)

    def ar(n):
        return torch.arange(n, dtype=torch.int32, device=dev)

    def zeros(n, dtype=torch.int32):
        return torch.zeros(n, dtype=dtype, device=dev)

    rmap = torch.full((cfg.n_gpa,), FREE, dtype=torch.int32, device=dev)
    rmap[: cfg.n_logical] = ar(cfg.n_logical)
    state = TieredState(
        gpt=ar(cfg.n_logical),
        rmap=rmap,
        block_table=ar(cfg.n_gpa_hp),
        slot_owner=ar(cfg.n_slots),
        near_pool=torch.zeros((cfg.n_near, cfg.hp_ratio, cfg.base_elems),
                              dtype=cfg.dtype, device=dev),
        far_pool=torch.zeros((cfg.n_far, cfg.hp_ratio, cfg.base_elems),
                             dtype=cfg.dtype, device=dev),
        guest_counts=zeros(cfg.n_logical),
        ipt_hist=zeros(cfg.n_logical, torch.uint8),
        host_counts=zeros(cfg.n_gpa_hp),
        host_hist=zeros(cfg.n_gpa_hp, torch.uint8),
        last_touch_epoch=zeros(cfg.n_gpa_hp),
        region_epoch=torch.full((cfg.n_gpa_hp,), -1, dtype=torch.int32,
                                device=dev),
        epoch=zeros(()),
        stats={k: zeros(()) for k in STAT_KEYS},
    )
    if fill is not None:
        from repro_torch.core import address_space as asp

        state = asp.write_logical(cfg, state, ar(cfg.n_logical), fill.to(dev))
    return state


def start_all_far(cfg: GpacConfig, state: TieredState) -> TieredState:
    """Re-home every allocated huge page to the far tier by swapping it with
    an unallocated far huge page (data moves with the blocks)."""
    from repro_torch.core import tiering

    hp_alloc = allocated_hp_mask(cfg, state)
    in_near = state.block_table < cfg.n_near
    n = min(cfg.n_near, cfg.n_far)

    def first_n(mask):  # jnp.nonzero(mask, size=n, fill_value=-1)
        idx = torch.nonzero(mask).reshape(-1)[:n].to(torch.int32)
        out = torch.full((n,), -1, dtype=torch.int32, device=mask.device)
        out[: idx.numel()] = idx
        return out

    d_idx = first_n(hp_alloc & in_near)
    v_idx = first_n(~hp_alloc & ~in_near)
    k = torch.minimum((d_idx >= 0).sum(), (v_idx >= 0).sum())
    return tiering.swap_blocks(cfg, state, v_idx, d_idx, k)


def allocated_hp_mask(cfg: GpacConfig, state: TieredState) -> torch.Tensor:
    """bool[n_gpa_hp] -- huge page contains >=1 allocated base page."""
    return (state.rmap.view(cfg.n_gpa_hp, cfg.hp_ratio) != FREE).any(dim=1)
