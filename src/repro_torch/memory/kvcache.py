"""Tiered, paged KV cache (port of ``repro.memory.kvcache``).

Mapping onto the GPAC core (one ``TieredState`` per model):

  * logical base page  = one **token group** (``group_tokens`` tokens) of one
    sequence slot; payload = that group's K+V across all layers/kv-heads,
    flattened to ``base_elems`` floats.
  * huge page          = ``hp_ratio`` groups = the tier-placement granule.
  * guest telemetry    = per-group attention mass (softmax weight sums) --
    heavy-tailed in long-context decode, i.e. *scattered hot base pages*.
  * GPAC               = consolidates hot token groups of any sequence into
    dense huge pages, so the near tier holds attention mass, not dead tokens.

K/V are read *through* the two-level translation (``read_groups``), so
consolidation and migration are invisible to the reader. The pools are
written in place (``core.types``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import GpacConfig, TieredState, gpac, init_state, metrics, telemetry, tiering
from repro_torch.core import address_space as asp
from repro_torch.kernels import runtime


@dataclasses.dataclass(frozen=True)
class KVSpec:
    """Geometry of the tiered KV store for one model + serving budget."""

    arch: ArchConfig
    max_seqs: int  # sequence slots
    max_seq_len: int  # tokens per slot
    group_tokens: int = 16  # base granule (tokens per group)
    hp_ratio: int = 8  # groups per tier block (8*16 = 128-token blocks)
    near_fraction: float = 0.5  # near budget as fraction of total blocks
    cl: int = 4  # consolidation limit (hot groups per block)
    gpa_slack: float = 0.5  # spare GPA blocks (fresh regions + demotion room)

    @property
    def groups_per_seq(self) -> int:
        return -(-self.max_seq_len // self.group_tokens)

    @property
    def n_logical(self) -> int:
        return self.max_seqs * self.groups_per_seq

    @property
    def elems_per_group(self) -> int:
        a = self.arch
        return 2 * a.n_attn_layers * a.n_kv_heads * self.group_tokens * a.hd

    def gpac_config(self) -> GpacConfig:
        need_hp = -(-self.n_logical // self.hp_ratio)
        n_hp = need_hp + max(2, int(need_hp * self.gpa_slack))
        return GpacConfig(
            n_logical=self.n_logical,
            hp_ratio=self.hp_ratio,
            n_gpa_hp=n_hp,
            n_near=min(max(1, int(self.near_fraction * n_hp)), n_hp - 1),
            base_elems=self.elems_per_group,
            cl=self.cl,
            dtype=torch.float32,
        )


class TieredKVCache:
    """Stateful wrapper: the control plane in Python, the data plane in the
    core's tensor functions on ``device`` (CUDA unless named)."""

    def __init__(self, spec: KVSpec, device=None):
        self.spec = spec
        self.cfg = spec.gpac_config()
        self.device = runtime.resolve_device(device)
        self.state: TieredState = init_state(self.cfg, device=self.device)
        self.seq_lens = np.zeros((spec.max_seqs,), np.int64)

    # ---- addressing ------------------------------------------------------
    def group_id(self, seq: int, group: int) -> int:
        return seq * self.spec.groups_per_seq + group

    def seq_groups(self, seq: int, n_tokens: int | None = None) -> np.ndarray:
        n = self.seq_lens[seq] if n_tokens is None else n_tokens
        n_groups = -(-int(n) // self.spec.group_tokens)
        base = seq * self.spec.groups_per_seq
        return base + np.arange(n_groups)

    # ---- data plane --------------------------------------------------------
    def _pack(self, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """k/v (n_groups, L_attn, KVH, group_tokens, hd) -> (n_groups, elems)."""
        n = k.shape[0]
        return torch.cat([k.reshape(n, -1), v.reshape(n, -1)], dim=1).to(torch.float32)

    def _unpack(self, rows: torch.Tensor):
        a, s = self.spec.arch, self.spec
        n = rows.shape[0]
        half = rows.shape[1] // 2
        shape = (n, a.n_attn_layers, a.n_kv_heads, s.group_tokens, a.hd)
        return rows[:, :half].reshape(shape), rows[:, half:].reshape(shape)

    def append_groups(self, seq: int, k: torch.Tensor, v: torch.Tensor):
        """Append whole groups for sequence ``seq`` (prefill path).
        k/v: (n_groups, L_attn, KVH, group_tokens, hd)."""
        n = k.shape[0]
        start_group = -(-int(self.seq_lens[seq]) // self.spec.group_tokens)
        ids = torch.arange(n, dtype=torch.int32, device=self.device) + self.group_id(
            seq, start_group)
        self.state = asp.write_logical(
            self.cfg, self.state, ids, self._pack(k.to(self.device), v.to(self.device)))
        self.seq_lens[seq] += n * self.spec.group_tokens

    def read_groups(self, ids):
        """Gather K/V groups through the full two-level translation."""
        ids = torch.as_tensor(ids).to(self.device, torch.int32)
        return self._unpack(asp.read_logical(self.cfg, self.state, ids))

    # ---- telemetry + maintenance (the GPAC loop) ---------------------------
    def record_attention_mass(self, ids: np.ndarray, mass: np.ndarray,
                              quantum: float = 0.01):
        """Charge attention mass as access counts (1 count per ``quantum``
        of softmax weight, so cold tail groups round to zero)."""
        ids, mass = np.asarray(ids), np.asarray(mass)
        counts = np.minimum((mass / quantum).astype(np.int64), 2**20)
        keep = counts > 0
        if not keep.any():
            return
        self.state = asp.record_accesses(
            self.cfg, self.state,
            torch.as_tensor(ids[keep].astype(np.int32), device=self.device),
            torch.as_tensor(counts[keep].astype(np.int32), device=self.device),
        )

    def maintenance(self, policy: str = "memtierd", use_gpac: bool = True,
                    max_batches: int = 4, budget: int = 64):
        """One window: GPAC consolidation (guest side) + tier tick (host side)
        + window roll. Call every N decode steps."""
        if use_gpac:
            self.state = gpac.gpac_maintenance(self.cfg, self.state, "ipt", max_batches)
        self.state = tiering.tick(self.cfg, self.state, policy, budget=budget)
        self.state = telemetry.end_window(self.cfg, self.state)

    # ---- metrics -----------------------------------------------------------
    def near_usage(self) -> float:
        return float(metrics.near_usage(self.cfg, self.state))

    def hit_rate(self) -> float:
        return float(metrics.hit_rate(self.state))

    def stats(self) -> dict:
        return metrics.snapshot(self.cfg, self.state)
