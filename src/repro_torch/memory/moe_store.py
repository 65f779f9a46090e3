"""Tiered MoE expert store (port of ``repro.memory.moe_store``).

Expert slabs are *dense by construction* (one expert = one contiguous weight
slab far larger than a tier block), so GPAC's intra-block consolidation is
inapplicable -- the paper's own observation about dense-hot pages. What
remains is the block-granular tier layer: routing frequency is Zipf-skewed,
so hot experts' slabs belong in the near tier and the cold tail in the far
one. Telemetry = router selections per expert; every block of an expert is
charged together, so placement decisions stay slab-coherent.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import GpacConfig, init_state, metrics, telemetry, tiering
from repro_torch.core import address_space as asp
from repro_torch.kernels import runtime
from repro_torch.memory.embedding import host_array


@dataclasses.dataclass(frozen=True)
class ExpertStoreSpec:
    arch: ArchConfig
    blocks_per_expert: int = 4  # tier granule: expert slab / 4
    near_fraction: float = 0.25  # near budget (fraction of experts resident)

    @property
    def n_experts(self) -> int:
        return self.arch.e_pad

    def gpac_config(self) -> GpacConfig:
        n_logical = self.n_experts * self.blocks_per_expert
        n_hp = n_logical + 2
        return GpacConfig(
            n_logical=n_logical,
            hp_ratio=1,  # block == base granule: no sub-block structure
            n_gpa_hp=n_hp,
            n_near=min(max(1, int(self.near_fraction * n_hp)), n_hp - 1),
            base_elems=8,  # placement bookkeeping only (slabs stay in params)
            cl=1,
            dtype=torch.float32,
        )


class TieredExpertStore:
    def __init__(self, spec: ExpertStoreSpec, device=None):
        self.spec = spec
        self.cfg = spec.gpac_config()
        self.device = runtime.resolve_device(device)
        self.state = init_state(self.cfg, device=self.device)

    def _expert_blocks(self, e: np.ndarray) -> np.ndarray:
        b = self.spec.blocks_per_expert
        return (e[:, None] * b + np.arange(b)[None]).reshape(-1)

    def record_routing(self, expert_ids):
        """Charge router selections: every block of a selected expert."""
        experts, counts = np.unique(host_array(expert_ids).reshape(-1), return_counts=True)
        blocks = self._expert_blocks(experts)
        counts = np.repeat(np.minimum(counts, 2**20), self.spec.blocks_per_expert)
        self.state = asp.record_accesses(
            self.cfg, self.state,
            torch.as_tensor(blocks.astype(np.int32), device=self.device),
            torch.as_tensor(counts.astype(np.int32), device=self.device))

    def maintenance(self, policy: str = "memtierd"):
        # no gpac_maintenance: consolidation is inapplicable to dense slabs
        # (every block of a hot expert is hot: never < CL=1)
        self.state = tiering.tick(self.cfg, self.state, policy, budget=64)
        self.state = telemetry.end_window(self.cfg, self.state)

    def near_experts(self) -> np.ndarray:
        """Experts fully resident in the near tier right now."""
        bt = self.state.block_table.cpu().numpy()
        gpt = self.state.gpt.cpu().numpy()
        b = self.spec.blocks_per_expert
        in_near = bt[gpt // self.cfg.hp_ratio] < self.cfg.n_near
        per_e = in_near[: self.spec.n_experts * b].reshape(-1, b)
        return np.nonzero(per_e.all(axis=1))[0]

    def hit_rate(self) -> float:
        return float(metrics.hit_rate(self.state))
