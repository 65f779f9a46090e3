"""Tiered embedding store (port of ``repro.memory.embedding``): Zipfian
token frequency makes hot vocab rows *scattered* across the table -- the
paper's scattered hot base pages. GPAC consolidates hot row groups into
dense blocks, so the near-tier fraction of the table tracks the head of the
Zipf curve.

Lookups go through ``kernels.tiered_lookup`` with the precomposed
translation (the 'fused TLB'), recomputed only after a maintenance tick. The
store's core calls run the port's kernels on CUDA (K2-K4 in maintenance, K4
in every lookup) and their plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import GpacConfig, gpac, init_state, metrics, telemetry, tiering
from repro_torch.core import address_space as asp
from repro_torch.kernels import runtime
from repro_torch.kernels.tiered_lookup import tiered_lookup


def host_array(x) -> np.ndarray:
    """A numpy copy of ids handed as an array, a list or a tensor."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class EmbedSpec:
    arch: ArchConfig
    rows_per_page: int = 8  # vocab rows per base granule
    hp_ratio: int = 64  # granules per tier block (8*64=512 rows/block)
    near_fraction: float = 0.25
    cl: int = 16

    @property
    def n_logical(self) -> int:
        return -(-self.arch.vocab // self.rows_per_page)

    def gpac_config(self) -> GpacConfig:
        need = -(-self.n_logical // self.hp_ratio)
        n_hp = need + max(2, need // 4)
        return GpacConfig(
            n_logical=self.n_logical,
            hp_ratio=self.hp_ratio,
            n_gpa_hp=n_hp,
            n_near=min(max(1, int(self.near_fraction * n_hp)), n_hp - 1),
            base_elems=self.rows_per_page * self.arch.d_model,
            cl=self.cl,
            dtype=torch.float32,
        )


class TieredEmbeddingStore:
    def __init__(self, spec: EmbedSpec, table: torch.Tensor, device=None):
        """``table``: (vocab, d_model) weights to load into the paged pools
        on ``device`` (CUDA unless named)."""
        self.spec = spec
        self.cfg = spec.gpac_config()
        self.device = runtime.resolve_device(device)
        v, d = table.shape
        pad_rows = spec.n_logical * spec.rows_per_page - v
        t = torch.nn.functional.pad(table.to(self.device, torch.float32), (0, 0, 0, pad_rows))
        fill = t.reshape(spec.n_logical, spec.rows_per_page * d)
        self.state = init_state(self.cfg, fill=fill, device=self.device)
        self._fused = None  # cached (translation, row space), invalidated on ticks

    def _fused_rows(self):
        """Flat physical row space + per-granule fused translation. The pools
        change only in maintenance, which drops the cache."""
        if self._fused is None:
            rows = torch.cat([self.state.near_pool.view(-1, self.cfg.base_elems),
                              self.state.far_pool.view(-1, self.cfg.base_elems)])
            self._fused = asp.fused_translation(self.cfg, self.state), rows
        return self._fused

    def lookup(self, token_ids: torch.Tensor) -> torch.Tensor:
        """(…,) int32 token ids -> (…, d_model) rows via two-level gather."""
        s, d = self.spec, self.spec.arch.d_model
        token_ids = torch.as_tensor(token_ids).to(self.device, torch.int32)
        granule = token_ids // s.rows_per_page
        offset = token_ids % s.rows_per_page
        fused, rows = self._fused_rows()
        granule_rows = tiered_lookup(rows, fused, granule)  # (..., base_elems)
        granule_rows = granule_rows.reshape(*token_ids.shape, s.rows_per_page, d)
        idx = offset[..., None, None].long().expand(*token_ids.shape, 1, d)
        return torch.gather(granule_rows, -2, idx)[..., 0, :]

    def record_batch(self, token_ids):
        """Telemetry: charge one access per token occurrence to its granule."""
        granules, counts = np.unique(
            host_array(token_ids).reshape(-1) // self.spec.rows_per_page,
            return_counts=True,
        )
        self.state = asp.record_accesses(
            self.cfg, self.state,
            torch.as_tensor(granules.astype(np.int32), device=self.device),
            torch.as_tensor(np.minimum(counts, 2**20).astype(np.int32), device=self.device),
        )

    def maintenance(self, policy: str = "memtierd", use_gpac: bool = True):
        if use_gpac:
            self.state = gpac.gpac_maintenance(self.cfg, self.state, "ipt", 4)
        self.state = tiering.tick(self.cfg, self.state, policy, budget=64)
        self.state = telemetry.end_window(self.cfg, self.state)
        self._fused = None  # translation cache shootdown (paper's TLB flush)

    def near_usage(self) -> float:
        return float(metrics.near_usage(self.cfg, self.state))

    def hit_rate(self) -> float:
        return float(metrics.hit_rate(self.state))
