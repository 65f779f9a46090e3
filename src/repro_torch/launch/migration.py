"""Live guest migration: a mid-flight state handoff between lanes (port of
``repro.launch.migration``).

A guest migrates by re-homing its *lane*: the geometry never changes, the
guest's state moves from its source lane to a vacant destination lane (on
a sharded mesh, a lane of another rank's partition). Four host-side phases
on the replicated state, run between driver calls:

  1. **quiesce** -- flip the source lane inactive in the ``ChurnState``
     activity mask (the stepper then masks its accesses to -1);
  2. **extract** -- package the lane's segment-relative state: mappings,
     guest and host telemetry rows, and the payload read through the block
     table (``data[h] = pools[bt[h]]``);
  3. **release** -- crash-style reclaim of the source lane
     (``core.faults.apply_guest_faults``);
  4. **inject + resume** -- write the package into the destination lane's
     existing block-table slots (``block_table`` is a permutation, so no
     slot is allocated) and flip the lane active.

Every edit is a row copy on the replicated state, so a migration composes
with any mesh, fault schedule and the pressure controller. As everywhere in
the port, the state handed in is consumed: :func:`release_guest` and
:func:`inject_guest` write its pools in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core.types import FREE, TieredState


@dataclasses.dataclass(frozen=True)
class GuestPackage:
    """One extracted lane, segment-relative (every index rebased to the
    lane's own segment start). ``manifest`` is the bytes accounting:
    payload, mapping and telemetry."""

    source: int
    n_logical: int
    hp_size: int
    gpt: np.ndarray  # int32[n_logical] segment-relative gpa page ids
    rmap: np.ndarray  # int32[hp_size * ratio] segment-relative logical | FREE
    guest_counts: np.ndarray  # int32[n_logical]
    ipt_hist: np.ndarray  # uint8[n_logical]
    host_counts: np.ndarray  # int32[hp_size]
    host_hist: np.ndarray  # uint8[hp_size]
    last_touch_epoch: np.ndarray  # int32[hp_size]
    region_epoch: np.ndarray  # int32[hp_size]
    payload: np.ndarray  # dtype[hp_size, hp_ratio, base_elems]

    @property
    def manifest(self) -> dict:
        mapping = self.gpt.nbytes + self.rmap.nbytes
        telemetry = (self.guest_counts.nbytes + self.ipt_hist.nbytes
                     + self.host_counts.nbytes + self.host_hist.nbytes
                     + self.last_touch_epoch.nbytes + self.region_epoch.nbytes)
        return dict(
            payload_bytes=int(self.payload.nbytes),
            mapping_bytes=int(mapping),
            telemetry_bytes=int(telemetry),
            total_bytes=int(self.payload.nbytes + mapping + telemetry),
        )


def _check_lane(spec, g: int, what: str) -> None:
    if not 0 <= g < spec.n_guests:
        raise ValueError(f"{what} lane {g} outside [0, {spec.n_guests})")


def _compatible(spec, src: int, dst: int) -> None:
    if src == dst:
        raise ValueError(f"migration source and destination are both lane {src}")
    s, d = spec.guests[src], spec.guests[dst]
    if s.n_logical != d.n_logical:
        raise ValueError(
            f"lane geometry mismatch: source lane {src} has n_logical="
            f"{s.n_logical}, destination lane {dst} has {d.n_logical}")
    if spec.guest_cl(src) != spec.guest_cl(dst):
        raise ValueError(
            f"lane CL mismatch: source lane {src} has cl={spec.guest_cl(src)}, "
            f"destination lane {dst} has {spec.guest_cl(dst)}")


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def extract_guest(spec, state: TieredState, g: int) -> GuestPackage:
    """Package lane ``g``'s state, segment-relative (phase 2)."""
    from repro_torch.core.sharding import _pool_rows

    _check_lane(spec, g, "source")
    cfg = spec.cfg
    lo, hi = spec.logical_range(g)
    hp_lo, hp_hi = spec.hp_range(g)
    gpa_lo, gpa_hi = hp_lo * cfg.hp_ratio, hp_hi * cfg.hp_ratio
    rmap = _np(state.rmap[gpa_lo:gpa_hi])
    return GuestPackage(
        source=g,
        n_logical=hi - lo,
        hp_size=hp_hi - hp_lo,
        gpt=_np(state.gpt[lo:hi]) - np.int32(gpa_lo),
        rmap=np.where(rmap == FREE, FREE, rmap - lo).astype(np.int32),
        guest_counts=_np(state.guest_counts[lo:hi]),
        ipt_hist=_np(state.ipt_hist[lo:hi]),
        host_counts=_np(state.host_counts[hp_lo:hp_hi]),
        host_hist=_np(state.host_hist[hp_lo:hp_hi]),
        last_touch_epoch=_np(state.last_touch_epoch[hp_lo:hp_hi]),
        region_epoch=_np(state.region_epoch[hp_lo:hp_hi]),
        payload=_np(_pool_rows(cfg, state, state.block_table[hp_lo:hp_hi])),
    )


def release_guest(spec, state: TieredState, g: int) -> TieredState:
    """Crash-style reclaim of lane ``g`` (phase 3): segment freed,
    telemetry cleared, payload wiped -- the fault engine's transition."""
    _check_lane(spec, g, "source")
    n_g, dev = spec.n_guests, state.device
    one_hot = torch.zeros((n_g,), dtype=torch.bool, device=dev)
    one_hot[g] = True
    state, _ = faults_mod.apply_guest_faults(
        spec, state, torch.ones((n_g,), dtype=torch.bool, device=dev), one_hot,
        torch.zeros((n_g,), dtype=torch.bool, device=dev))
    return state


def inject_guest(spec, state: TieredState, g: int, pkg: GuestPackage) -> TieredState:
    """Re-home a package into vacant lane ``g`` (phase 4): offset-translated
    mapping and telemetry rows, the payload written through the lane's
    existing block-table slots."""
    _check_lane(spec, g, "destination")
    if pkg.source != g:
        _compatible(spec, pkg.source, g)
    cfg = spec.cfg
    lo, hi = spec.logical_range(g)
    hp_lo, hp_hi = spec.hp_range(g)
    if hi - lo != pkg.n_logical or hp_hi - hp_lo != pkg.hp_size:
        raise ValueError(
            f"package geometry ({pkg.n_logical} logical, {pkg.hp_size} hp) does "
            f"not fit lane {g} ({hi - lo} logical, {hp_hi - hp_lo} hp)")
    gpa_lo, gpa_hi = hp_lo * cfg.hp_ratio, hp_hi * cfg.hp_ratio
    if not bool((state.rmap[gpa_lo:gpa_hi] == FREE).all()):
        raise ValueError(
            f"destination lane {g} still holds allocated pages; release or "
            f"crash it before injecting")
    dev = state.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rmap_rel = t(pkg.rmap)
    slots = state.block_table[hp_lo:hp_hi]
    is_near = slots < cfg.n_near
    payload = t(pkg.payload).to(cfg.dtype)
    state.near_pool[slots[is_near]] = payload[is_near]
    state.far_pool[slots[~is_near] - cfg.n_near] = payload[~is_near]

    def rows(x, a, b, v):
        x = x.clone()
        x[a:b] = v
        return x

    return dataclasses.replace(
        state,
        gpt=rows(state.gpt, lo, hi, t(pkg.gpt) + gpa_lo),
        rmap=rows(state.rmap, gpa_lo, gpa_hi,
                  torch.where(rmap_rel == FREE, FREE, rmap_rel + lo)),
        guest_counts=rows(state.guest_counts, lo, hi, t(pkg.guest_counts)),
        ipt_hist=rows(state.ipt_hist, lo, hi, t(pkg.ipt_hist)),
        host_counts=rows(state.host_counts, hp_lo, hp_hi, t(pkg.host_counts)),
        host_hist=rows(state.host_hist, hp_lo, hp_hi, t(pkg.host_hist)),
        last_touch_epoch=rows(state.last_touch_epoch, hp_lo, hp_hi, t(pkg.last_touch_epoch)),
        region_epoch=rows(state.region_epoch, hp_lo, hp_hi, t(pkg.region_epoch)),
    )


def _with_lane(active: torch.Tensor, g: int, value: bool) -> torch.Tensor:
    out = active.clone()
    out[g] = value
    return out


def quiesce(cs, g: int):
    """Flip lane ``g`` inactive in a ChurnState (phase 1); the state is
    untouched."""
    return dataclasses.replace(cs, active=_with_lane(cs.active, g, False))


def resume(cs, g: int):
    """Flip lane ``g`` active again (end of phase 4)."""
    return dataclasses.replace(cs, active=_with_lane(cs.active, g, True))


def migrate_guest(spec, cs, src: int, dst: int):
    """The whole protocol on a ChurnState carry: quiesce(src), extract,
    release(src), inject(dst), resume(dst). Returns ``(cs, manifest)``. The
    destination lane must be vacant (inactive) and the source active; the
    next ``run_churn`` / ``step`` continues with the migrated lane live, on
    any mesh."""
    from repro_torch.core.engine import ChurnState

    if not isinstance(cs, ChurnState):
        raise TypeError(f"migrate_guest needs a ChurnState carry, got {type(cs).__name__}")
    _check_lane(spec, src, "source")
    _check_lane(spec, dst, "destination")
    _compatible(spec, src, dst)
    active = _np(cs.active)
    if not active[src]:
        raise ValueError(f"source lane {src} is not active")
    if active[dst]:
        raise ValueError(
            f"destination lane {dst} is active; migrate into a vacant (inactive) lane")
    cs = quiesce(cs, src)
    pkg = extract_guest(spec, cs.state, src)
    state = release_guest(spec, cs.state, src)
    state = inject_guest(spec, state, dst, pkg)
    return resume(dataclasses.replace(cs, state=state), dst), pkg.manifest
