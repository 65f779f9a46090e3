"""Continuous-batching serving engine over the GPAC-tiered paged KV cache
(port of ``repro.serve.engine``).

The paper's full loop against a real model:

  * the model decodes through its **block table** (the GVA->GPA analogue)
    and never sees where a page lies;
  * a placement manager (one ``TieredState`` whose logical pages are the
    model's KV page slots) plays guest daemon and host: per-page attention
    mass is the telemetry, GPAC consolidates hot pages into dense tier
    blocks within each sequence's pool segment, and a host policy places
    blocks near or far;
  * consolidation is applied physically to the model cache (pages copied,
    block table rewritten), so generation must not change.

The near/far split is bookkeeping (metrics). The attention-mass probe uses
the first attention layer's projections; a model without attention layers
(xLSTM) records no mass. Every family runs: M-RoPE models prefill with three
equal position streams, an encoder-decoder with zero stub frames.

:class:`TieringService` is the churn engine's serving front: tenants
admitted onto the guest lanes of an engine fleet through the pressure-aware
``AdmissionQueue``, their accesses made on the device window by window.

In place, where the reference rebuilds arrays: page moves, prefill's copy
into a slot and every decode step write the cache's tensors; the placement
state is consumed by the core functions, as everywhere in the port. As in
the reference, the host reads the placement (``gpt``) back at every page
sync, and the logits at every step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import GpacConfig, gpac, init_state, telemetry, tiering
from repro_torch.core import address_space as asp
from repro_torch.core import engine as ce
from repro_torch.core import metrics as core_metrics
from repro_torch.data import traces as tr
from repro_torch.kernels import registry as kernels_registry
from repro_torch.kernels import runtime
from repro_torch.models import layers as L
from repro_torch.models.registry import Model
from repro_torch.serve.scheduler import AdmissionQueue, Request, Scheduler, SchedulerConfig


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_seqs: int = 4
    max_seq_len: int = 256
    pages_per_block: int = 4  # tier-block granule (hp_ratio)
    near_fraction: float = 0.4
    gpa_slack: float = 0.5
    sched: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)


def _layer0(tree: dict) -> dict:
    """Group 0's slice of a stacked tree."""
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


class Engine:
    """``device``: CUDA unless named (the params must lie there);
    ``kernel_backend``: the kernel registry knob, ``"auto"`` (the kernels on
    the card) or ``"torch"`` (their plain versions), passed to every
    dispatch."""

    def __init__(self, model: Model, params: dict, ecfg: EngineConfig, device=None,
                 kernel_backend: str = "auto"):
        self.device = runtime.resolve_device(device)
        self.kernel_backend = kernels_registry.resolve_backend(kernel_backend)
        self.model = model
        self.params = params
        self.ecfg = ecfg
        self.sched = Scheduler(dataclasses.replace(ecfg.sched, max_seqs=ecfg.max_seqs))
        self.page = model.cfg.page_size
        # ---- placement manager: logical page-slot space over all seqs -----
        # The physical pool covers each sequence's whole GPA segment (logical
        # pages + slack blocks): consolidation allocates fresh regions there.
        B = ecfg.max_seqs
        pps = -(-ecfg.max_seq_len // self.page) + 8  # logical page slots/seq
        per_seq_hp = -(-pps // ecfg.pages_per_block)
        slack_hp = max(1, int(per_seq_hp * ecfg.gpa_slack))
        self.seq_hp = per_seq_hp + slack_hp  # gpa blocks per seq segment
        self.n_pool = pps
        self.n_phys = self.seq_hp * ecfg.pages_per_block  # pages per seq pool
        self.cache = model.init_cache(B, ecfg.max_seq_len, n_pool=self.n_phys,
                                      device=self.device)
        n_hp = B * self.seq_hp
        self.pcfg = GpacConfig(
            n_logical=B * pps,
            hp_ratio=ecfg.pages_per_block,
            n_gpa_hp=n_hp,
            n_near=min(max(1, int(ecfg.near_fraction * n_hp)), n_hp - 1),
            base_elems=2,  # placement bookkeeping only (KV lives in the cache)
            cl=max(2, ecfg.pages_per_block // 2 + 1),  # CL 1 never matches
            ipt_min_hits=1,
        )
        # identity layout per segment: logical slot (b, s) -> seq b's segment
        gpt = np.full((self.pcfg.n_logical,), -1, np.int64)
        rmap = np.full((self.pcfg.n_gpa,), -1, np.int64)
        for b in range(B):
            gpa = (b * self.seq_hp * self.pcfg.hp_ratio) + np.arange(pps)
            gpt[b * pps:(b + 1) * pps] = gpa
            rmap[gpa] = b * pps + np.arange(pps)
        st = init_state(self.pcfg, device=self.device)
        self.pstate = dataclasses.replace(st, gpt=self._t(gpt, torch.int32),
                                          rmap=self._t(rmap, torch.int32))
        self._sync_btab()
        self.decode_fn = lambda p, c, t: model.decode(p, c, t, self.kernel_backend)

    def _t(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=self.device, dtype=dtype)

    # ------------------------------------------------------------------
    # placement <-> model-cache coherence
    # ------------------------------------------------------------------
    def _model_btab_from_gpt(self) -> np.ndarray:
        """gpt (B*pps,) global gpa -> per-seq physical page index."""
        B, pps = self.ecfg.max_seqs, self.n_pool
        gpt = self.pstate.gpt.cpu().numpy().reshape(B, pps)
        seg = (np.arange(B) * self.seq_hp * self.pcfg.hp_ratio)[:, None]
        return (gpt - seg).astype(np.int32)

    def _sync_btab(self):
        self.cache["btab"] = self._t(self._model_btab_from_gpt(), torch.int32)

    def _apply_page_moves(self, old_btab: np.ndarray, new_btab: np.ndarray):
        """Copy moved pages in the model cache, in place (Algorithm 1's
        memcpy at page granularity, on the model's own tensors)."""
        moved = old_btab != new_btab
        if not moved.any():
            return
        b_idx, s_idx = np.nonzero(moved)
        b_t = self._t(b_idx, torch.long)
        src = self._t(old_btab[b_idx, s_idx], torch.long)
        dst = self._t(new_btab[b_idx, s_idx], torch.long)
        for lc in self.cache["layers"].values():
            if "k_pages" not in lc:  # a Mamba or xLSTM layer: no pages
                continue
            for key in ("k_pages", "v_pages"):
                arr = lc[key]  # (G, B, KVH, n_pool, page, hd)
                # advanced indices around a slice go first:
                # (n_moved, G, KVH, page, hd); src and dst are disjoint
                arr[:, b_t, :, dst] = arr[:, b_t, :, src]

    def maintenance(self):
        """One GPAC + tier window over the placement state, applied to the
        model cache."""
        old_btab = self._model_btab_from_gpt()
        if self.sched.cfg.use_gpac:
            B, pps = self.ecfg.max_seqs, self.n_pool
            logical = torch.arange(self.pcfg.n_logical, device=self.device)
            for b in range(B):
                allow = (logical >= b * pps) & (logical < (b + 1) * pps)
                hp_lo = b * self.seq_hp
                self.pstate = gpac.gpac_maintenance(
                    self.pcfg, self.pstate, "ipt", 2, allow=allow,
                    hp_range=(hp_lo, hp_lo + self.seq_hp),
                    kernel_backend=self.kernel_backend)
        self.pstate = tiering.tick(
            self.pcfg, self.pstate, self.sched.cfg.tier_policy, budget=32)
        self.pstate = telemetry.end_window(self.pcfg, self.pstate)
        new_btab = self._model_btab_from_gpt()
        self._apply_page_moves(old_btab, new_btab)
        self._sync_btab()

    # ------------------------------------------------------------------
    # telemetry: per-page attention mass (first attention layer probe)
    # ------------------------------------------------------------------
    def _attention_mass(self, tokens: torch.Tensor) -> np.ndarray:
        """float32 (B, pps): each logical page's share of the first
        attention layer's attention for the next token, averaged over heads;
        zeros where the model has no attention layer (xLSTM)."""
        cfg = self.model.cfg
        if not cfg.attn_layers:
            return np.zeros((self.ecfg.max_seqs, self.n_pool))
        j = cfg.attn_layers[0] % cfg.group_size
        lp = _layer0(self.params["groups"])[f"layer{j}"]
        k = self.cache["layers"][f"layer{j}"]["k_pages"][0]  # (B, KVH, n_pool, page, hd)
        lens = self.cache["lens"]
        h = L.embed(cfg, self.params["embed"], tokens)
        x = L.apply_norm(cfg, lp["norm1"], h)
        q, _, _ = L.qkv(cfg, lp["attn"], x, lens[:, None], rope=not cfg.encdec)
        B = tokens.shape[0]
        KVH, hd, page = cfg.n_kv_heads, cfg.hd, cfg.page_size
        btab = self.cache["btab"].long()
        bidx = torch.arange(B, device=self.device)[:, None]
        k = k[bidx, :, btab].transpose(1, 2)  # logical order (B, KVH, pps, page, hd)
        kf = k.reshape(B, KVH, self.n_pool * page, hd)
        qh = q.reshape(B, KVH, cfg.n_heads // KVH, hd)
        s = torch.einsum("bkgd,bksd->bkgs", qh.float(), kf.float()) * (hd ** -0.5)
        pos = torch.arange(self.n_pool * page, device=self.device)
        s = torch.where(pos <= lens.view(B, 1, 1, 1), s, float("-inf"))
        pr = torch.softmax(s, dim=-1)
        pr = torch.where(torch.isfinite(pr), pr, 0.0)
        mass = pr.mean(dim=(1, 2)).reshape(B, self.n_pool, page).sum(-1)
        return mass.cpu().numpy()

    def _record_mass(self, mass: np.ndarray, quantum: float = 0.02):
        B, pps = mass.shape
        counts = np.minimum((mass / quantum).astype(np.int64), 1 << 20)
        slots = np.arange(B * pps).reshape(B, pps)
        keep = counts > 0
        if not keep.any():
            return
        self.pstate = asp.record_accesses(
            self.pcfg, self.pstate, self._t(slots[keep], torch.int32),
            self._t(counts[keep], torch.int32), kernel_backend=self.kernel_backend)

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------
    def _reset_slot_placement(self, b: int):
        """Guest-reboot slot b: identity gpt over its segment, telemetry
        cleared (prefill writes pages at identity physical positions)."""
        pps, hp = self.n_pool, self.pcfg.hp_ratio
        seg_page0 = b * self.seq_hp * hp
        st = self.pstate
        gpt = st.gpt.cpu().numpy().copy()
        rmap = st.rmap.cpu().numpy().copy()
        counts = st.guest_counts.cpu().numpy().copy()
        hist = st.ipt_hist.cpu().numpy().copy()
        repoch = st.region_epoch.cpu().numpy().copy()
        rmap[seg_page0:seg_page0 + self.seq_hp * hp] = -1
        gpt[b * pps:(b + 1) * pps] = seg_page0 + np.arange(pps)
        rmap[seg_page0:seg_page0 + pps] = b * pps + np.arange(pps)
        counts[b * pps:(b + 1) * pps] = 0
        hist[b * pps:(b + 1) * pps] = 0
        repoch[b * self.seq_hp:(b + 1) * self.seq_hp] = -1
        self.pstate = dataclasses.replace(
            st, gpt=self._t(gpt, torch.int32), rmap=self._t(rmap, torch.int32),
            guest_counts=self._t(counts, torch.int32),
            ipt_hist=self._t(hist, torch.uint8),
            region_epoch=self._t(repoch, torch.int32))
        self._sync_btab()

    def _prefill_into_slot(self, req: Request):
        self._reset_slot_placement(req.seq_slot)
        toks = torch.tensor(req.prompt, dtype=torch.int32, device=self.device)[None]
        batch = {"tokens": toks}
        cfg = self.model.cfg
        if cfg.mrope:  # text only: three equal position streams
            S = toks.shape[1]
            batch["positions"] = torch.arange(S, dtype=torch.int32,
                                              device=self.device).expand(3, 1, S)
        if cfg.encdec:  # the stub audio frontend: zero frames
            batch["frames"] = torch.zeros((1, cfg.n_frames, cfg.d_model), dtype=cfg.dtype,
                                          device=self.device)
        logits, rcache = self.model.prefill(
            self.params, batch, max_seq=self.ecfg.max_seq_len, n_pool=self.n_phys)
        b = req.seq_slot
        for name, lc in self.cache["layers"].items():
            for key, dst in lc.items():
                if dst.dim() >= 2 and dst.shape[1] == self.ecfg.max_seqs:
                    dst[:, b] = rcache["layers"][name][key][:, 0]
        if cfg.encdec:
            for key in ("enc_k", "enc_v"):
                self.cache[key][:, b] = rcache[key][:, 0]
        self.cache["lens"][b] = len(req.prompt)
        req.out.append(int(torch.argmax(logits[0])))

    def step(self) -> dict:
        """One engine iteration: admit -> prefill -> batched decode ->
        telemetry -> cadenced maintenance."""
        for req in self.sched.admit(self.ecfg.max_seq_len - 1):
            self._prefill_into_slot(req)
        if not self.sched.running:
            return {}
        tokens = np.zeros((self.ecfg.max_seqs, 1), np.int32)
        for b, req in self.sched.running.items():
            tokens[b, 0] = req.out[-1] if req.out else 0
        tokens = self._t(tokens, torch.int32)
        mass = self._attention_mass(tokens)
        mass[[b for b in range(self.ecfg.max_seqs)
              if b not in self.sched.running]] = 0.0  # idle slots are silent
        logits, self.cache = self.decode_fn(self.params, self.cache, tokens)
        self._record_mass(mass)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for b, req in list(self.sched.running.items()):
            req.out.append(int(nxt[b]))
            if len(req.out) >= req.max_new:
                self.sched.finish(req)
        if self.sched.should_maintain():
            self.maintenance()
        return self.stats()

    def run(self, max_steps: int = 10_000) -> list:
        hist = []
        steps = 0
        while self.sched.has_work and steps < max_steps:
            hist.append(self.step())
            steps += 1
        return hist

    def stats(self) -> dict:
        return core_metrics.snapshot(self.pcfg, self.pstate)


# --------------------------------------------------------------------------
# steady-state tiering service (the churn engine's serving front)
# --------------------------------------------------------------------------
class TieringService:
    """Tenants arriving and departing on the churn engine's guest lanes.

    Each admitted tenant occupies one guest lane of an
    ``engine.EngineSpec`` fleet, its accesses made on the device from the
    lane's workload identity (``data.traces``); admission goes through the
    pressure-aware :class:`AdmissionQueue` (retries with exponential
    backoff while ``ChurnState.pressure`` is up), a departure is a crash
    fault (the lane's near blocks are reclaimed within the same window),
    and per-tenant QoS counters (admission latency, evictions, hit rate)
    accumulate from the churn series. The fleet's geometry never changes:
    lanes flip active and inactive. Runs on ``device`` (CUDA unless named),
    through the kernels unless ``kernel_backend="torch"``."""

    def __init__(
        self,
        spec,
        queue: AdmissionQueue | None = None,
        accesses_per_window: int = 512,
        policy: str = "memtierd",
        use_gpac: bool = True,
        budget: int = 64,
        slack: int = 1,
        *,
        kernel_backend: str | None = None,
        partitionable: bool = True,
        device=None,
    ):
        dev = runtime.resolve_device(device)
        if kernel_backend is not None:
            kernels_registry.resolve_backend(kernel_backend)
            spec = dataclasses.replace(spec, kernel_backend=kernel_backend)
        self.spec = spec
        self.queue = queue if queue is not None else AdmissionQueue()
        self.knobs = dict(
            policy=policy, use_gpac=use_gpac, budget=budget, slack=slack)
        n_g = spec.n_guests
        self.cs = ce.init_churn(spec, active=np.zeros((n_g,), bool), device=dev)
        self.lane_tenant = np.full((n_g,), -1, np.int64)  # lane -> tenant
        self._departing: set[int] = set()  # tenants crashing next tick
        self._near_cap_req: int | None = None
        plan, tables = ce._bind_synth(
            spec, ce.SynthTrace(1, accesses_per_window, partitionable=partitionable))
        self._plan = plan
        self._setup = tr.synth_setup(plan, tables, dev)
        self._prev_near = np.zeros((n_g,), np.int64)

    # ---- tenant lifecycle ----------------------------------------------
    @property
    def window(self) -> int:
        return int(self.cs.window)

    def submit(self, tenant: int, tier_floor: int = 0):
        """Queue a tenant; ``tier_floor`` names the deepest tier index its
        SLO tolerates (0 = near only; ``n_tiers - 1`` accepts any
        placement), against the spec's tier vector: a floor at the last
        tier counts every hit in-SLO, any other floor near hits only (the
        per-tenant hits resolve only the near/far split)."""
        n_tiers = self.spec.tier_vector.n_tiers
        self.queue.submit(
            tenant, now=self.window, tier_floor=min(tier_floor, n_tiers - 1))

    def depart(self, tenant: int):
        """Tenant leaves: its lane crashes on the next :meth:`tick` (blocks
        reclaimed inside that window)."""
        if tenant not in self.lane_tenant:
            raise ValueError(f"tenant {tenant} is not resident")
        self._departing.add(tenant)

    def set_near_cap(self, near_cap: int | None):
        """Inject an effective near-capacity (None restores the physical
        tier) from the next :meth:`tick` on."""
        self._near_cap_req = (
            self.spec.cfg.n_near if near_cap is None else int(near_cap))

    def lane_of(self, tenant: int) -> int:
        lanes = np.nonzero(self.lane_tenant == tenant)[0]
        return int(lanes[0]) if lanes.size else -1

    # ---- the window loop ------------------------------------------------
    def tick(self) -> dict:
        """One serving window: admit (pressure-aware) -> crash departures /
        restart admissions -> one churn engine step -> QoS accounting."""
        now, pressure = torch.stack([self.cs.window, self.cs.pressure]).tolist()
        n_g = self.spec.n_guests
        crash = np.zeros((n_g,), bool)
        for tenant in self._departing:
            lane = self.lane_of(tenant)
            if lane >= 0:
                crash[lane] = True
                self.lane_tenant[lane] = -1
        self._departing.clear()
        free = [int(l) for l in np.nonzero(self.lane_tenant < 0)[0]]
        restart = np.zeros((n_g,), bool)
        for tenant in self.queue.admit(now, pressure, len(free)):
            lane = free.pop(0)
            restart[lane] = True
            self.lane_tenant[lane] = tenant
            self._prev_near[lane] = 0
        row = dict(crash=crash, restart=restart)
        if self._near_cap_req is not None:
            row["near_cap"] = self._near_cap_req
            self._near_cap_req = None
        acc = tr.synth_accesses(self._plan, self._setup, now)
        self.cs, out = ce.step(
            self.spec, self.cs, acc, faults_row=row, **self.knobs)
        # ---- per-tenant QoS accounting ---------------------------------
        near = np.asarray(out["near_hits"])
        far = np.asarray(out["far_hits"])
        blocks = np.asarray(out["near_blocks"]).astype(np.int64)
        for lane in range(n_g):
            tenant = int(self.lane_tenant[lane])
            if tenant < 0:
                continue
            q = self.queue.qos[tenant]
            q.near_hits += int(near[lane])
            q.far_hits += int(far[lane])
            # SLO floor: near hits always satisfy the floor; a floor at the
            # deepest tier accepts everything
            q.floor_hits += int(near[lane])
            if q.tier_floor >= self.spec.tier_vector.n_tiers - 1:
                q.floor_hits += int(far[lane])
            if not restart[lane]:  # eviction = resident near blocks lost
                q.evictions += int(max(self._prev_near[lane] - blocks[lane], 0))
        self._prev_near = blocks
        return out

    def stats(self) -> dict:
        """Service-level snapshot: pressure/backoff state plus every
        tenant's QoS counters."""
        window, pressure, engaged, near_cap = torch.stack([
            self.cs.window, self.cs.pressure, self.cs.engaged.to(torch.int32),
            self.cs.near_cap]).tolist()
        return dict(
            window=window,
            pressure=pressure,
            engaged=bool(engaged),
            near_cap=near_cap,
            resident=int((self.lane_tenant >= 0).sum()),
            waiting=self.queue.n_waiting,
            tenants={
                t: dict(
                    admission_latency=q.admission_latency,
                    attempts=q.attempts,
                    evictions=q.evictions,
                    hit_rate=q.hit_rate,
                    tier_floor=q.tier_floor,
                    floor_hit_rate=q.floor_hit_rate,
                )
                for t, q in self.queue.qos.items()
            },
        )
