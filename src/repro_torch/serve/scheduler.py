"""Request scheduler for the continuous-batching engine (port of
``repro.serve.scheduler``; plain Python).

Admission is page-budget-aware: a request is admitted only if its prompt plus
``reserve_tokens`` of generation headroom fit a sequence slot. GPAC/tier
maintenance runs on a fixed decode-step cadence (the paper's telemetry
window). The pressure-aware admission (``BackoffConfig``, ``TenantQoS``,
``AdmissionQueue``) is the churn engine's serving front, behind
``serve.engine.TieringService``.
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


# --------------------------------------------------------------------------
# pressure-aware admission (the churn engine's serving front, DESIGN.md §13)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BackoffConfig:
    """Exponential-backoff knobs for admission under near-memory pressure:
    the n-th rejected attempt retries after ``min(base * 2**n, cap)``
    windows."""

    base: int = 1
    cap: int = 16

    def delay(self, attempts: int) -> int:
        return min(self.base * (2 ** min(attempts, 30)), self.cap)


@dataclasses.dataclass
class TenantQoS:
    """Per-tenant quality-of-service counters (the churn benchmark's
    per-tenant figure): admission latency in windows, blocks evicted from
    the near tier while resident, and the tenant's cumulative hit split.

    ``tier_floor`` is the deepest tier index this tenant's SLO tolerates
    (0 = near-tier only, ``n_tiers - 1`` = any placement is fine);
    ``floor_hits`` accumulates the accesses that landed at or above the
    floor, so ``floor_hit_rate`` is the fraction of traffic inside SLO.
    """

    tenant: int
    submitted_at: int = -1
    admitted_at: int = -1
    attempts: int = 0  # admissions denied under pressure so far
    retry_at: int = 0  # next window this tenant may be considered
    evictions: int = 0  # near blocks lost while resident
    near_hits: int = 0
    far_hits: int = 0
    tier_floor: int = 0  # deepest acceptable tier index (SLO)
    floor_hits: int = 0  # accesses that landed at or above the floor

    @property
    def admission_latency(self) -> int:
        """Windows from submit to admit (-1 while still waiting)."""
        if self.admitted_at < 0:
            return -1
        return self.admitted_at - self.submitted_at

    @property
    def hit_rate(self) -> float:
        total = self.near_hits + self.far_hits
        return self.near_hits / total if total else 0.0

    @property
    def floor_hit_rate(self) -> float:
        """Fraction of this tenant's accesses served inside its SLO floor."""
        total = self.near_hits + self.far_hits
        return self.floor_hits / total if total else 0.0


class AdmissionQueue:
    """FIFO admission that retries with exponential backoff under pressure
    instead of failing.

    Each window the service calls :meth:`admit` with the pressure
    controller's backoff signal (``ChurnState.pressure``) and the number of
    free guest lanes. Under pressure every *due* waiting tenant is pushed
    out by :class:`BackoffConfig`'s exponential schedule (its ``attempts``
    counter grows); with pressure clear, due tenants admit FIFO into the
    free lanes. Tenants backed off earlier stay waiting until their
    ``retry_at`` window even if pressure has cleared -- that is the backoff
    doing its job: post-shrink stampedes are spread out instead of
    re-spiking the near tier.
    """

    def __init__(self, backoff: BackoffConfig = BackoffConfig()):
        self.backoff = backoff
        self.waiting: deque = deque()  # tenant ids, FIFO
        self.qos: dict[int, TenantQoS] = {}

    def submit(self, tenant: int, now: int, tier_floor: int = 0) -> TenantQoS:
        if tenant in self.qos:
            raise ValueError(f"tenant {tenant} already submitted")
        if tier_floor < 0:
            raise ValueError(
                f"tenant {tenant}: tier_floor must be >= 0, got {tier_floor}")
        q = TenantQoS(tenant=tenant, submitted_at=now, retry_at=now,
                      tier_floor=tier_floor)
        self.qos[tenant] = q
        self.waiting.append(tenant)
        return q

    def admit(self, now: int, pressure: int, free_lanes: int) -> list[int]:
        """Tenants to admit this window (at most ``free_lanes``)."""
        admitted: list[int] = []
        still_waiting: deque = deque()
        for tenant in self.waiting:
            q = self.qos[tenant]
            due = now >= q.retry_at
            if due and pressure > 0:
                q.retry_at = now + self.backoff.delay(q.attempts)
                q.attempts += 1
                still_waiting.append(tenant)
            elif due and len(admitted) < free_lanes:
                q.admitted_at = now
                admitted.append(tenant)
            else:
                still_waiting.append(tenant)
        self.waiting = still_waiting
        return admitted

    @property
    def n_waiting(self) -> int:
        return len(self.waiting)
