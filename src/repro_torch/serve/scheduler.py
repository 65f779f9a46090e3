"""Request scheduler for the continuous-batching engine (port of
``repro.serve.scheduler``; plain Python).

Admission is page-budget-aware: a request is admitted only if its prompt plus
``reserve_tokens`` of generation headroom fit a sequence slot. GPAC/tier
maintenance runs on a fixed decode-step cadence (the paper's telemetry
window). The pressure-aware admission of the reference (``BackoffConfig``,
``TenantQoS``, ``AdmissionQueue``) serves only ``TieringService``, which
waits for on-device trace synthesis (ROADMAP queue 1, items 10 and 14).
"""
from __future__ import annotations

import dataclasses
from collections import deque


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list  # token ids
    max_new: int = 32
    out: list = dataclasses.field(default_factory=list)
    seq_slot: int = -1
    done: bool = False


@dataclasses.dataclass
class SchedulerConfig:
    max_seqs: int = 4
    reserve_tokens: int = 32
    maintenance_every: int = 8  # decode steps per GPAC/tier window
    tier_policy: str = "memtierd"
    use_gpac: bool = True


class Scheduler:
    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.waiting: deque = deque()
        self.running: dict = {}  # slot -> Request
        self.free_slots = list(range(cfg.max_seqs))
        self.steps_since_maintenance = 0

    def submit(self, req: Request):
        self.waiting.append(req)

    def admit(self, seq_capacity_tokens: int) -> list:
        """Admit waiting requests into free slots while they fit."""
        admitted = []
        while self.waiting and self.free_slots:
            req = self.waiting[0]
            need = len(req.prompt) + req.max_new + self.cfg.reserve_tokens
            if need > seq_capacity_tokens:
                raise ValueError(
                    f"request {req.rid} needs {need} tokens > slot capacity "
                    f"{seq_capacity_tokens}")
            self.waiting.popleft()
            req.seq_slot = self.free_slots.pop(0)
            self.running[req.seq_slot] = req
            admitted.append(req)
        return admitted

    def finish(self, req: Request):
        req.done = True
        self.running.pop(req.seq_slot, None)
        self.free_slots.append(req.seq_slot)
        req.seq_slot = -1

    def should_maintain(self) -> bool:
        self.steps_since_maintenance += 1
        if self.steps_since_maintenance >= self.cfg.maintenance_every:
            self.steps_since_maintenance = 0
            return True
        return False

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
