"""Fault tolerance and straggler mitigation (port of
``repro.train.fault``; numpy, the reference's policies line for line).

1. Checkpoint / restart: :class:`Supervisor` saves every ``save_every``
   steps through ``train/checkpoint.py`` and says where to resume.
2. Stragglers: per-host EWMAs of step time; a host past ``deadline_factor``
   x the median sheds half its micro-batches to the fastest hosts, and one
   that misses ``suspect_after`` deadlines in a row is a suspect.
3. Elastic resize: the largest (data, model) mesh the survivors can hold.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.dist import NO_DIST


@dataclasses.dataclass
class StragglerConfig:
    deadline_factor: float = 1.5  # x median EWMA step time
    ewma: float = 0.8
    suspect_after: int = 3  # consecutive deadline misses -> suspect


@dataclasses.dataclass
class HostHealth:
    n_hosts: int
    cfg: StragglerConfig
    ewma_ms: np.ndarray = None
    misses: np.ndarray = None

    def __post_init__(self):
        if self.ewma_ms is None:
            self.ewma_ms = np.zeros(self.n_hosts)
        if self.misses is None:
            self.misses = np.zeros(self.n_hosts, np.int64)


def observe_step(h: HostHealth, step_ms: np.ndarray) -> HostHealth:
    """Fold one step's per-host times into the EWMAs."""
    a = h.cfg.ewma
    init = h.ewma_ms == 0
    h.ewma_ms = np.where(init, step_ms, a * h.ewma_ms + (1 - a) * step_ms)
    deadline = h.cfg.deadline_factor * np.median(h.ewma_ms)
    missed = step_ms > deadline
    h.misses = np.where(missed, h.misses + 1, 0)
    return h


def straggler_plan(h: HostHealth, micro_per_host: int) -> dict:
    """{"shares": micro-batches per host (their sum kept), "suspects":
    hosts to exclude at the next elastic boundary}."""
    deadline = h.cfg.deadline_factor * np.median(h.ewma_ms)
    slow = h.ewma_ms > deadline
    shares = np.full(h.n_hosts, micro_per_host, np.int64)
    if slow.any() and not slow.all():
        freed = shares[slow].sum() // 2  # halve the slow hosts' load
        shares[slow] -= shares[slow] // 2
        fast_order = np.argsort(h.ewma_ms)
        fast = fast_order[~slow[fast_order]]
        for i in range(int(freed)):  # the freed micro-batches round-robin
            shares[fast[i % len(fast)]] += 1
    suspects = np.nonzero(h.misses >= h.cfg.suspect_after)[0]
    return {"shares": shares, "suspects": suspects}


def surviving_mesh_shape(n_hosts_alive: int, chips_per_host: int, model_parallel: int) -> tuple:
    """Largest (data, model) mesh on the survivors: model-parallel groups
    stay whole, so data shrinks to the largest multiple that fits."""
    chips = n_hosts_alive * chips_per_host
    data = chips // model_parallel
    if data == 0:
        raise RuntimeError(f"{chips} chips cannot host model_parallel={model_parallel}")
    return (data, model_parallel)


class Supervisor:
    """Periodic checkpoints and the step to resume from. Under a mesh only
    the coordinator writes, and every rank waits at a barrier until the
    checkpoint is on disk; every rank restores (each holds the whole
    state), so a checkpoint of N ranks resumes on M, or in one process, at
    its data step."""

    def __init__(self, ckpt_dir: str, save_every: int = 50, keep: int = 3):
        from repro_torch.train import checkpoint as ckpt

        self.ckpt = ckpt
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.keep = keep

    def resume_step(self) -> int:
        s = self.ckpt.latest_step(self.ckpt_dir)
        return 0 if s is None else s

    def maybe_save(self, step: int, tree, extra=None, background: bool = True,
                   dist=NO_DIST):
        """Save at every ``save_every``-th step (the host copy before this
        returns); returns the writing thread, or None. Under a mesh of
        several ranks (``dist``) the coordinator writes before the barrier
        that every rank then passes, so no thread outlives it."""
        if not (step % self.save_every == 0 and step > 0):
            return None
        ranks = 1 if dist.mesh is None else dist.mesh.size
        t = None
        if dist.is_coordinator:
            t = self.ckpt.save(self.ckpt_dir, step, tree, extra,
                               background=background and ranks == 1)
            self.ckpt.prune(self.ckpt_dir, self.keep)
        if ranks > 1:
            dist.barrier()
        return t
