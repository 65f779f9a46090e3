"""Guest-axis sharding over ``torch.distributed`` (port of
``repro.core.sharding``).

One rank per device, SPMD: every rank calls the driver with the same
arguments, runs its own contiguous block of guests and returns the
replicated result. A :class:`GuestMesh` is what JAX's 1-D ``"guest"`` mesh
is: a process group, this rank's index and its device. NCCL carries CUDA
tensors with one rank per card, gloo the CPU (and several ranks on one
card).

The engine's guest axis is embarrassingly parallel: the segment tables give
every guest disjoint logical and GPA segments. Each window therefore runs

1. the **access phase** on the rank's own guests, applied to its local copy
   of the state (a guest's counts, huge-page counts and touch epochs lie in
   its own segments);
2. the **GPAC phase** on the rank's own segment rows
   (``gpac.gpac_maintenance_rows``), in place on the local copy;
3. **one collective**: every element of every diverged array is owned by
   exactly one guest, so the rank zeroes what it does not own and one
   ``all_reduce(SUM)`` of the bit patterns rebuilds each array exactly (one
   non-zero contributor per element; floats travel as their int32 bits, so
   -0.0 and NaN payloads survive);
4. the **host tick**, replicated: the merged state is identical on every
   rank, so the shared near-tier arbitration is the paper's one host
   daemon.

Guest counts that do not divide the mesh are padded with empty segment rows
(all -1), which translate, select, allocate and own nothing.

The second half is the **host-partitioned near tier**
(``engine.run_sharded(host_sharded=True)``): each rank carries only its own
contiguous block range of the host state (:class:`HostPartition`), with the
payload stored per huge page, scores promotion and demotion locally, and
one exchange per arbitration group (``tiering``'s sharded ticks) resolves
the contention bit for bit against the replicated tick; the full state is
rebuilt once per chunk. Per-rank host-state bytes scale about as
1/n_ranks.

Collectives are issued unconditionally and in one order on every rank (a
rank holding only padding guests, or an empty host range, takes part in
every one), and every process group has a timeout, so a fault fails fast
instead of hanging the group.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import address_space as asp
from repro_torch.core import consolidator, gpac, metrics
from repro_torch.core import filter as pfilter
from repro_torch.core import telemetry, tiering
from repro_torch.core import tiers as tiers_mod
from repro_torch.core.types import FREE, GpacConfig, TieredState
from repro_torch.kernels import runtime

# every process group the port makes waits at most this long in a collective
TIMEOUT = datetime.timedelta(seconds=300)


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class GuestMesh:
    """The 1-D guest mesh of one rank: ``group`` (None: the default
    process group), this rank's index, the number of ranks, the rank's
    device and the group's backend."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def default_backend(device: torch.device) -> str:
    """NCCL for CUDA tensors (one rank per card), gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device, backend: str, rank: int) -> torch.device:
    dev = runtime.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        index = (rank % torch.cuda.device_count() if backend == "nccl"
                 else torch.cuda.current_device())
        dev = torch.device("cuda", index)
    return dev


def guest_mesh(n_devices: int | None = None, *, device=None) -> GuestMesh | None:
    """The guest mesh over ``n_devices`` ranks on ``device`` (CUDA unless
    named).

    In a job started by ``launch.multihost`` (``initialize()`` joined the
    default process group) the mesh spans every rank on the job's backend,
    and any other ``n_devices`` is refused. ``None`` is the no-mesh
    degradation: it returns None when the world has one rank, and the
    drivers then run unsharded. ``guest_mesh(1)`` in a single process
    forces a real one-rank group (on an in-memory store; NCCL on CUDA,
    gloo on the CPU), so the whole sharded path runs."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is None:
            if world == 1:
                return None
            n_devices = world
        if n_devices != world:
            raise ValueError(
                f"guest_mesh: a mesh must span all {world} ranks of the job, "
                f"got n_devices={n_devices}")
        rank, backend = dist.get_rank(), dist.get_backend()
    else:
        if n_devices is None:
            return None
        if n_devices != 1:
            raise ValueError(
                f"guest_mesh: asked for {n_devices} ranks in a single process; "
                f"start them with launch.multihost.launch (each rank calls "
                f"multihost.initialize())")
        backend = default_backend(runtime.resolve_device(device))
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
        rank = 0
    return GuestMesh(group=None, rank=rank, size=n_devices,
                     device=_rank_device(device, backend, rank), backend=backend)


def mesh_size(mesh: GuestMesh) -> int:
    """The number of ranks along the guest axis."""
    return mesh.size


def padded_guest_count(n_guests: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` >= ``n_guests``."""
    return -(-n_guests // n_shards) * n_shards


def pad_guest_rows(rows: np.ndarray, n_shards: int, fill=-1) -> np.ndarray:
    """Pad a per-guest matrix ``[n_guests, ...]`` with ``fill`` rows up to a
    multiple of ``n_shards``."""
    n_g = rows.shape[0]
    g_pad = padded_guest_count(n_g, n_shards)
    if g_pad == n_g:
        return rows
    pad = np.full((g_pad - n_g, *rows.shape[1:]), fill, rows.dtype)
    return np.concatenate([rows, pad], axis=0)


def guest_tables(spec, n_shards: int) -> dict[str, np.ndarray]:
    """The spec's per-guest segment tables padded to the mesh (rank ``r``
    takes rows ``[r * G_loc, (r + 1) * G_loc)``)."""
    return dict(
        logical_lo=pad_guest_rows(np.asarray(spec.logical_offsets[:-1], np.int32),
                                  n_shards, fill=0),
        logical_pad=pad_guest_rows(spec.logical_pad_index(), n_shards),
        hp_pad=pad_guest_rows(spec.hp_pad_index(), n_shards),
    )


# --------------------------------------------------------------------------
# the one collective of a site, and its byte record
# --------------------------------------------------------------------------
# Per site: the payload bytes of its last call, counted over the logical
# leaves (as the reference counts its psum's tree, not the packing), and the
# number of calls since the last reset.
_COLLECTIVE_BYTES: dict[str, int] = {}
_COLLECTIVE_CALLS: dict[str, int] = {}
_COLLECTIVE_TOTAL: dict[str, int] = {}


def reset_collective_bytes() -> None:
    """Clear the per-site record (call before the run to attribute)."""
    _COLLECTIVE_BYTES.clear()
    _COLLECTIVE_CALLS.clear()
    _COLLECTIVE_TOTAL.clear()


def collective_bytes() -> dict[str, int]:
    """Per-site payload bytes of the last visit: ``merge_window`` (the
    replicated and churn paths, one per window), ``host_exchange`` (the
    host-partitioned arbitration exchange, one per stride group) and
    ``host_chunk_exit`` (the host-partitioned rebuild, one per chunk); in
    data-parallel training (``models.dist``) ``grads`` (the gradient
    reduce, one per step), ``moe_counts`` and ``moe_top1`` (one each per
    MoE layer's forward, again when remat recomputes it), ``ce_count`` (one
    per micro-batch) and ``loss`` (one per step)."""
    return dict(_COLLECTIVE_BYTES)


def collective_bytes_total() -> dict[str, int]:
    """Per-site payload bytes summed over every visit since the last reset."""
    return dict(_COLLECTIVE_TOTAL)


def count_collective(site: str, nbytes: int, calls: int) -> None:
    """Record one visit of ``site``: ``nbytes`` of payload in ``calls``
    collective calls."""
    _COLLECTIVE_BYTES[site] = nbytes
    _COLLECTIVE_TOTAL[site] = _COLLECTIVE_TOTAL.get(site, 0) + nbytes
    _COLLECTIVE_CALLS[site] = _COLLECTIVE_CALLS.get(site, 0) + calls


def collective_calls() -> dict[str, int]:
    """Per-site number of ``all_reduce`` calls issued since the last reset:
    one per site visit, except gloo on CUDA tensors, which takes the
    packed leaves and each pool as calls of their own (three for a
    ``merge_window`` with GPAC)."""
    return dict(_COLLECTIVE_CALLS)


def _to_bits(x: torch.Tensor) -> torch.Tensor:
    """A leaf as flat int32 words for the exact integer sum: 4-byte leaves
    by their bit patterns, narrower integers widened, anything else by its
    bytes widened."""
    if x.dtype == torch.int32:
        return x.reshape(-1)
    if x.element_size() == 4:
        return x.contiguous().view(torch.int32).reshape(-1)
    if not x.is_floating_point() and x.element_size() < 4:
        return x.reshape(-1).to(torch.int32)
    return x.contiguous().view(torch.uint8).reshape(-1).to(torch.int32)


def _from_bits(words: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.int32:
        return words.view(like.shape)
    if like.element_size() == 4:
        return words.view(like.dtype).view(like.shape)
    if not like.is_floating_point() and like.element_size() < 4:
        return words.to(like.dtype).view(like.shape)
    return words.to(torch.uint8).view(like.dtype).view(like.shape)


def _n_words(x: torch.Tensor) -> int:
    if x.element_size() == 4 or (not x.is_floating_point() and x.element_size() < 4):
        return x.numel()
    return x.numel() * x.element_size()


def _inplace_view(x: torch.Tensor) -> torch.Tensor:
    """A pool as the integer view that is reduced in place."""
    return x.view(torch.int32) if x.element_size() == 4 else x.view(torch.uint8)


def _all_reduce(mesh: GuestMesh, tensors: list[torch.Tensor]) -> int:
    """``all_reduce(SUM)`` over ``tensors``, in place, as one call: a single
    tensor alone, several as one coalesced call (NCCL groups it into one
    launch). Gloo coalesces CPU tensors only, so on CUDA tensors it takes
    them one by one. Returns the number of calls issued."""
    if len(tensors) == 1:
        dist.all_reduce(tensors[0], group=mesh.group)
        return 1
    same = len({t.dtype for t in tensors}) == 1
    if same and (mesh.backend == "nccl" or tensors[0].device.type == "cpu"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            warnings.simplefilter("ignore", UserWarning)
            dist.all_reduce_coalesced(tensors, group=mesh.group)
        return 1
    for t in tensors:
        dist.all_reduce(t, group=mesh.group)
    return len(tensors)


def _psum(mesh: GuestMesh, site: str, leaves: list[torch.Tensor],
          inplace: tuple[torch.Tensor, ...] = ()) -> list[torch.Tensor]:
    """The site's collective: ``leaves`` packed into one flat int32 buffer,
    ``inplace`` (the payload pools, their non-owned rows already zero)
    reduced where they lie, beside it. Returns the summed leaves in their
    own dtypes and shapes; the pools hold their sums."""
    flat = torch.cat([_to_bits(t) for t in leaves])
    n_calls = _all_reduce(mesh, [flat, *(_inplace_view(p) for p in inplace)])
    count_collective(site, sum(t.numel() * t.element_size() for t in (*leaves, *inplace)),
                     n_calls)
    out, at = [], 0
    for t in leaves:
        n = _n_words(t)
        out.append(_from_bits(flat[at:at + n], t))
        at += n
    return out


# --------------------------------------------------------------------------
# this rank's tables
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class RankTables:
    """One rank's share of the segment tables, as tensors on its device,
    with the static ownership masks of its guests."""

    g_loc: int
    logical_lo: torch.Tensor  # int32[G_loc, 1]
    logical_pad: torch.Tensor  # int32[G_loc, max_logical]
    hp_pad: torch.Tensor  # int32[G_loc, max_hp]
    cl_per_logical: torch.Tensor  # int32[n_logical] (global)
    own_logical: torch.Tensor  # bool[n_logical]
    own_hp: torch.Tensor  # bool[n_gpa_hp]
    own_gpa: torch.Tensor  # bool[n_gpa]


def _own_mask(idx_rows: torch.Tensor, n: int) -> torch.Tensor:
    """bool[n]: the ids covered by these (-1 padded) segment rows."""
    flat = idx_rows.reshape(-1)
    out = torch.zeros((n + 1,), dtype=torch.bool, device=flat.device)
    out[torch.where(flat >= 0, flat, n).long()] = True
    return out[:n]


@functools.lru_cache(maxsize=16)
def rank_tables(spec, n_shards: int, rank: int, device: torch.device) -> RankTables:
    t = guest_tables(spec, n_shards)
    g_loc = t["logical_lo"].shape[0] // n_shards
    rows = slice(rank * g_loc, (rank + 1) * g_loc)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    logical_pad, hp_pad = dev(t["logical_pad"][rows]), dev(t["hp_pad"][rows])
    own_hp = _own_mask(hp_pad, spec.cfg.n_gpa_hp)
    return RankTables(
        g_loc=g_loc,
        logical_lo=dev(t["logical_lo"][rows][:, None]),
        logical_pad=logical_pad,
        hp_pad=hp_pad,
        cl_per_logical=spec.tables(device).cl_per_logical,
        own_logical=_own_mask(logical_pad, spec.cfg.n_logical),
        own_hp=own_hp,
        own_gpa=own_hp.repeat_interleave(spec.cfg.hp_ratio),
    )


def _owned(x: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
    """This rank's contribution: its owned elements, 0 elsewhere."""
    return torch.where(own, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _spread_rows(mesh: GuestMesh, x_loc: torch.Tensor) -> torch.Tensor:
    """This rank's per-local-guest vector at its global guest positions in
    zeros ``[G_pad]``: rows are contiguous per rank, so the sum over ranks
    (inside the window's one collective) is the whole vector."""
    g_loc = x_loc.shape[0]
    out = x_loc.new_zeros((g_loc * mesh.size,))
    out[mesh.rank * g_loc:(mesh.rank + 1) * g_loc] = x_loc
    return out


# --------------------------------------------------------------------------
# the replicated-host window
# --------------------------------------------------------------------------
def merge_window(cfg: GpacConfig, mesh: GuestMesh, T: RankTables, base_stats: dict,
                 local: TieredState, extras: list[torch.Tensor], merged_gpac: bool):
    """Rebuild the replicated state from every rank's local window phases
    with **one** collective. The access phase wrote the counts and touch
    epochs, the GPAC phase the mappings, ``region_epoch`` and the pools;
    ``slot_owner`` is unchanged by both, so slot ``s`` belongs to the guest
    owning huge page ``slot_owner[s]``. Stats are int32 counters: the base
    plus the sum of per-rank deltas is exact. The pools' non-owned rows are
    zeroed in place and the pools reduced in place: no pool-sized
    contribution is built. Returns the state and the summed ``extras``."""
    keys = list(base_stats)
    leaves = [
        _owned(local.guest_counts, T.own_logical),
        _owned(local.host_counts, T.own_hp),
        _owned(local.last_touch_epoch, T.own_hp),
        *[local.stats[k] - base_stats[k] for k in keys],
        *extras,
    ]
    inplace = ()
    if merged_gpac:
        leaves += [_owned(local.gpt, T.own_logical), _owned(local.rmap, T.own_gpa),
                   _owned(local.region_epoch, T.own_hp)]
        if mesh.size > 1:  # one rank owns every row
            own_slot = T.own_hp[local.slot_owner]
            local.near_pool.masked_fill_(~own_slot[: cfg.n_near, None, None], 0)
            local.far_pool.masked_fill_(~own_slot[cfg.n_near:, None, None], 0)
        inplace = (local.near_pool, local.far_pool)
    merged = _psum(mesh, "merge_window", leaves, inplace)
    gc, hc, lt = merged[:3]
    deltas = merged[3:3 + len(keys)]
    n_x = len(extras)
    merged_extras = merged[3 + len(keys):3 + len(keys) + n_x]
    state = dataclasses.replace(
        local, guest_counts=gc, host_counts=hc, last_touch_epoch=lt,
        stats={k: base_stats[k] + d for k, d in zip(keys, deltas)})
    if merged_gpac:
        gpt, rmap, re = merged[3 + len(keys) + n_x:]
        state = dataclasses.replace(state, gpt=gpt, rmap=rmap, region_epoch=re)
    return state, merged_extras


def window_phases(mesh: GuestMesh, spec, state: TieredState, acc: torch.Tensor,
                  backend: str, use_gpac: bool, max_batches: int,
                  collect: tuple[str, ...], drop: bool = False):
    """The sharded form of ``engine._window_phases``: the access and GPAC
    phases of one window on this rank's guests (``acc`` int32[G_loc, k]),
    on its local copy of the state, then the window's one merge. Returns
    the replicated state and the window's hit vectors, bit for bit the
    unsharded phases' on the unpadded guests. ``drop`` zeroes the access
    histogram (a churn dropout window)."""
    cfg = spec.cfg
    T = rank_tables(spec, mesh.size, mesh.rank, state.device)
    base_stats = dict(state.stats)
    ids = torch.where(acc >= 0, acc + T.logical_lo, -1)
    slot, _, valid = asp.translate(cfg, state, ids)
    near_loc = (valid & (slot < cfg.n_near)).sum(dim=1).to(torch.int32)
    far_loc = (valid & (slot >= cfg.n_near)).sum(dim=1).to(torch.int32)
    kb = spec.kernel_backend
    h = asp.access_histogram(cfg, ids, valid, kb)
    if drop:
        h = h * 0  # the reference's integer dropout gate
    local = asp.apply_access_histogram(cfg, state, h, kb)
    if use_gpac:
        local = gpac.gpac_maintenance_rows(
            cfg, local, backend, max_batches, T.cl_per_logical, T.logical_pad,
            T.hp_pad, kb)
    extras = [_spread_rows(mesh, near_loc), _spread_rows(mesh, far_loc)]
    if "tco" in collect:
        extras.append(tiers_mod.tier_hit_counts(spec.tier_vector, slot, valid))
    state, mx = merge_window(cfg, mesh, T, base_stats, local, extras, use_gpac)
    window = dict(near_hits=mx[0][: spec.n_guests], far_hits=mx[1][: spec.n_guests])
    if "tco" in collect:
        window["tier_hits"] = mx[2]
    return state, window


def churn_phases(mesh: GuestMesh, spec, state: TieredState, acc: torch.Tensor,
                 active: torch.Tensor, drop: bool, backend: str, use_gpac: bool,
                 max_batches: int, collect: tuple[str, ...]):
    """The sharded form of ``engine._churn_phases``: the activity mask is
    replicated, so each rank masks its own rows of it, then
    :func:`window_phases`."""
    T = rank_tables(spec, mesh.size, mesh.rank, state.device)
    lo = mesh.rank * T.g_loc
    act_loc = torch.zeros((T.g_loc,), dtype=torch.bool, device=state.device)
    n_real = max(0, min(T.g_loc, spec.n_guests - lo))
    act_loc[:n_real] = active[lo:lo + n_real]
    acc = torch.where(act_loc[:, None], acc, -1)
    return window_phases(mesh, spec, state, acc, backend, use_gpac, max_batches,
                         collect, drop)


# ==========================================================================
# host-partitioned near tier
#
# Rank d owns the huge pages of its own guests' GPA segments (guest blocks
# are contiguous and guests are dealt to ranks in contiguous blocks), and
# holds only
#
#   * its rows of block_table / host_counts / host_hist / last_touch_epoch /
#     region_epoch, and
#   * the hp-owned payload ``data[h - hp_lo]`` -- huge page h's bytes, the
#     replicated ``pools[block_table[h]]`` row. Data follows the huge page,
#     so an arbitrated migration relabels slots only and no payload crosses
#     ranks; ``slot_owner`` (the labels' inverse) is rebuilt once per chunk.
#
# Each arbitration group (``EngineSpec.arbitration_stride`` windows) has ONE
# collective: the per-range candidate sets, a few scalar sums and the
# group's per-window collector rows. The full state exists only at chunk
# boundaries (sliced on entry, summed on exit).
# ==========================================================================
# replicated host-state bytes per huge page: block_table + slot_owner +
# host_counts + last_touch_epoch + region_epoch (int32) + host_hist (uint8)
HOST_META_BYTES = 4 * 5 + 1
# the partitioned carry drops slot_owner (rebuilt at chunk exit)
LOCAL_META_BYTES = 4 * 4 + 1
# huge pages copied per step between the pools and the hp-owned payload
# (bounds the temporary of the entry slice and the exit rebuild)
_COPY_ROWS = 256


@dataclasses.dataclass(frozen=True)
class HostPartition:
    """Contiguous per-rank block ranges of the host state: rank ``d`` owns
    huge pages ``[hp_lo[d], hp_hi[d])``, its own guests' GPA segments. The
    ranges tile ``[0, n_gpa_hp)``; a rank holding only padding guests owns
    an empty range. ``h_loc`` is the widest range (every rank pads its
    local arrays to it with -1 rows)."""

    hp_lo: tuple[int, ...]
    hp_hi: tuple[int, ...]
    h_loc: int

    @property
    def n_shards(self) -> int:
        return len(self.hp_lo)

    def hp_ids(self) -> np.ndarray:
        """int32[n_shards, h_loc]: global block ids per rank, -1 padded."""
        out = np.full((self.n_shards, self.h_loc), -1, np.int32)
        for d, (lo, hi) in enumerate(zip(self.hp_lo, self.hp_hi)):
            out[d, : hi - lo] = np.arange(lo, hi, dtype=np.int32)
        return out


def host_partition(spec, n_shards: int) -> HostPartition:
    """The block ranges of ``engine.run_sharded``'s guest dealing."""
    g_loc = padded_guest_count(spec.n_guests, n_shards) // n_shards
    lo, hi = [], []
    for d in range(n_shards):
        a = min(d * g_loc, spec.n_guests)
        z = min((d + 1) * g_loc, spec.n_guests)
        lo.append(spec.hp_offsets[a])
        hi.append(spec.hp_offsets[z])
    h_loc = max(1, max(h - l for l, h in zip(lo, hi)))
    return HostPartition(tuple(lo), tuple(hi), h_loc)


def _payload_bytes(cfg: GpacConfig) -> int:
    return cfg.hp_ratio * cfg.base_elems * cfg.dtype.itemsize


def host_state_bytes(cfg: GpacConfig) -> int:
    """Bytes of host state every rank holds on the replicated path: block
    and slot tables, host telemetry and both payload pools."""
    return cfg.n_gpa_hp * (HOST_META_BYTES + _payload_bytes(cfg))


def host_state_bytes_sharded(cfg: GpacConfig, part: HostPartition) -> int:
    """Bytes of the partitioned host-state carry per rank (every rank pads
    its range to the widest one)."""
    return part.h_loc * (LOCAL_META_BYTES + _payload_bytes(cfg))


def host_tables(spec, n_shards: int) -> tuple[HostPartition, dict]:
    """The guest segment tables plus the host-partition tables."""
    part = host_partition(spec, n_shards)
    tables = guest_tables(spec, n_shards)
    tables.update(hp_ids=part.hp_ids(), hp_lo=np.asarray(part.hp_lo, np.int32),
                  hp_hi=np.asarray(part.hp_hi, np.int32))
    return part, tables


def _pool_rows(cfg: GpacConfig, state: TieredState, slots: torch.Tensor) -> torch.Tensor:
    """The payload rows of ``slots``, whichever pool holds each."""
    is_near = (slots < cfg.n_near)[:, None, None]
    return torch.where(is_near, state.near_pool[slots.clamp(max=cfg.n_near - 1)],
                       state.far_pool[(slots - cfg.n_near).clamp(min=0)])


def _slice_host_local(cfg: GpacConfig, state: TieredState, hp_ids: torch.Tensor) -> dict:
    """This rank's host-state rows out of a replicated state. Padding rows
    get inert sentinels (slot ``n_gpa_hp`` classifies as far and scatters
    off every table). Huge page ``h``'s payload row is read through its
    slot: ``data[row(h)] == pools[block_table[h]]``, the layout invariant
    of the whole partitioned path. The copy goes ``_COPY_ROWS`` huge pages
    at a time."""
    v = hp_ids >= 0
    t = hp_ids.clamp(min=0).long()
    bt = torch.where(v, state.block_table[t], cfg.n_gpa_hp)
    data = torch.zeros((hp_ids.shape[0], cfg.hp_ratio, cfg.base_elems),
                       dtype=cfg.dtype, device=hp_ids.device)
    for s in range(0, hp_ids.shape[0], _COPY_ROWS):
        rows = slice(s, s + _COPY_ROWS)
        data[rows] = torch.where(v[rows, None, None],
                                 _pool_rows(cfg, state, torch.where(v[rows], bt[rows], 0)), 0)
    return dict(
        bt=bt,
        hc=torch.where(v, state.host_counts[t], 0),
        hh=torch.where(v, state.host_hist[t], 0).to(torch.uint8),
        lt=torch.where(v, state.last_touch_epoch[t], 0),
        re=torch.where(v, state.region_epoch[t], -1),
        data=data,
    )


def _spread_hp(x_loc: torch.Tensor, hp_ids: torch.Tensor, n: int, fill: int) -> torch.Tensor:
    """Local block rows in a full-size view filled with ``fill`` elsewhere
    (only ever read at this rank's own blocks)."""
    out = torch.full((n + 1,), fill, dtype=x_loc.dtype, device=x_loc.device)
    out[torch.where(hp_ids >= 0, hp_ids, n).long()] = x_loc
    return out[:n]


def _place_block(mesh: GuestMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's candidate block at its mesh row in zeros: the exchange's
    sum concatenates every rank's nominations."""
    out = x.new_zeros((mesh.size, *x.shape))
    out[mesh.rank] = x
    return out


def _view_state(cfg: GpacConfig, gpt, rmap, gc, ih, re_view, epoch, stats) -> TieredState:
    """A state view for the guest-side GPAC classifiers: the real guest
    arrays and the local ``region_epoch`` spread; the host arrays are
    placeholders (telemetry and the filter never read them)."""
    z = torch.zeros((1,), dtype=torch.int32, device=gpt.device)
    zp = torch.zeros((1, 1, 1), dtype=cfg.dtype, device=gpt.device)
    return TieredState(
        gpt=gpt, rmap=rmap, block_table=z, slot_owner=z, near_pool=zp, far_pool=zp,
        guest_counts=gc, ipt_hist=ih, host_counts=z,
        host_hist=torch.zeros((1,), dtype=torch.uint8, device=gpt.device),
        last_touch_epoch=z, region_epoch=re_view, epoch=epoch, stats=stats)


def _near_blocks_local(cfg: GpacConfig, alloc: torch.Tensor, bt: torch.Tensor,
                       hp_lo: int, hp_pad: torch.Tensor) -> torch.Tensor:
    """Per own guest: allocated blocks in the near tier, counted over this
    rank's block rows (pre-tick; the arbitrated swaps correct it)."""
    h_loc = bt.shape[0]
    row = torch.where(hp_pad >= 0, hp_pad - hp_lo, 0).clamp(0, h_loc - 1).long()
    good = alloc & (bt < cfg.n_near)
    return ((hp_pad >= 0) & good[row]).sum(dim=1).to(torch.int32)


def _near_blocks_delta(spec, swaps, g_pad: int) -> torch.Tensor:
    """Replicated per-guest near-block delta of the arbitrated swap rounds:
    each committed candidate moves from its slot to its partner's, so it
    adds ``(partner near) - (self near)`` (0 for an N-tier swap below the
    near boundary)."""
    n_near = spec.cfg.n_near
    dev = swaps[0][2].device
    hp_off = torch.tensor(spec.hp_offsets, dtype=torch.int32, device=dev)
    delta = torch.zeros((g_pad + 1,), dtype=torch.int32, device=dev)
    for far, near, ok in swaps:
        for cand, other in ((far, near), (near, far)):
            g = torch.searchsorted(hp_off, cand["id"], right=True) - 1
            w = torch.where(ok & (cand["alloc"] > 0),
                            (other["slot"] < n_near).to(torch.int32)
                            - (cand["slot"] < n_near).to(torch.int32), 0)
            delta.index_add_(0, torch.where(ok, g, g_pad).long(), w.to(torch.int32))
    return delta[:g_pad]


def _near_scalar_delta(cfg: GpacConfig, swaps) -> torch.Tensor:
    """The host-wide form of :func:`_near_blocks_delta` (for ``snapshot``)."""
    d = torch.zeros((), dtype=torch.int32, device=swaps[0][2].device)
    for far, near, ok in swaps:
        for cand, other in ((far, near), (near, far)):
            d = d + torch.where(ok & (cand["alloc"] > 0),
                                (other["slot"] < cfg.n_near).to(torch.int32)
                                - (cand["slot"] < cfg.n_near).to(torch.int32),
                                0).sum().to(torch.int32)
    return d


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict / list, in insertion order (the same on
    every rank)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for x in items for t in _leaves(x)]


def _unflatten(tree, flat: list[torch.Tensor]):
    it = iter(flat)

    def go(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        return [go(v) for v in x]

    return go(tree)


@dataclasses.dataclass(frozen=True, eq=False)
class HostRank:
    """One rank's host partition: its block ids, range and guest tables."""

    hp_ids: torch.Tensor  # int32[h_loc], -1 padded
    hp_lo: int
    hp_hi: int
    guests: RankTables


@functools.lru_cache(maxsize=16)
def host_rank(spec, n_shards: int, rank: int, device: torch.device) -> HostRank:
    part = host_partition(spec, n_shards)
    return HostRank(
        hp_ids=torch.from_numpy(part.hp_ids()[rank].copy()).to(device),
        hp_lo=part.hp_lo[rank], hp_hi=part.hp_hi[rank],
        guests=rank_tables(spec, n_shards, rank, device))


def _host_sharded_group(spec, mesh: GuestMesh, H: HostRank, carry: dict,
                        accs: list[torch.Tensor], policy: str, backend: str,
                        use_gpac: bool, max_batches: int, budget: int,
                        collect: tuple[str, ...]):
    """One arbitration group -- ``spec.arbitration_stride`` windows -- on the
    partitioned host state, with ONE collective for the whole group; bit for
    bit ``engine._window`` at that stride on the unpadded guests.

    Every window runs its access and GPAC phases and its telemetry roll
    locally; only the group's last window nominates tick candidates, on the
    stride's accumulated telemetry. The per-window collector rows ride the
    last window's candidate exchange; the arbitrated swaps correct only the
    last window's rows (the earlier windows ran no tick). Returns the carry
    and the group's per-window output dicts."""
    cfg = spec.cfg
    T = H.guests
    hp_ids, hp_lo = H.hp_ids, H.hp_lo
    stride = spec.arbitration_stride
    gpt, rmap = carry["gpt"], carry["rmap"]
    gc, ih = carry["guest_counts"], carry["ipt_hist"]
    epoch, stats = carry["epoch"], dict(carry["stats"])
    loc = dict(carry["loc"])
    gstats = dict(carry["gstats"]) if "gstats" in carry else None
    epoch_in = epoch
    kb = spec.kernel_backend
    tv = spec.tier_vector if "tco" in collect else None
    prepare, apply = tiering.sharded_tick_fns(policy)
    tkw = {} if spec.tiers is None else dict(tiers=spec.tiers)
    safe_ids = hp_ids.clamp(min=0).long()

    def roll():
        nonlocal ih, gc, epoch
        ih = (ih << 1) | (gc > 0).to(torch.uint8)
        loc["hh"] = (loc["hh"] << 1) | (loc["hc"] > 0).to(torch.uint8)
        gc = torch.zeros_like(gc)
        loc["hc"] = torch.zeros_like(loc["hc"])
        epoch = epoch + 1

    per_win = []
    L = payload = None
    for j, acc in enumerate(accs):
        stats0 = dict(stats)
        # ---- 1. access phase (local: own guests touch own blocks) ---------
        ids = torch.where(acc >= 0, acc + T.logical_lo, -1)
        valid = (ids >= 0) & (ids < cfg.n_logical)
        hp = gpt[torch.where(valid, ids, 0)] // cfg.hp_ratio
        slot = _spread_hp(loc["bt"], hp_ids, cfg.n_gpa_hp, cfg.n_gpa_hp)[hp]
        near_loc = (valid & (slot < cfg.n_near)).sum(dim=1).to(torch.int32)
        far_loc = (valid & (slot >= cfg.n_near)).sum(dim=1).to(torch.int32)
        h = asp.access_histogram(cfg, ids, valid, kb)
        gc = gc + h
        inc_full = asp.host_histogram(cfg, gpt, h, kb)
        inc_loc = torch.where(hp_ids >= 0, inc_full[safe_ids], 0)
        loc["hc"] = loc["hc"] + inc_loc
        loc["lt"] = torch.where(inc_loc > 0, torch.maximum(loc["lt"], epoch), loc["lt"])
        stats["near_hits"] = stats["near_hits"] + near_loc.sum().to(torch.int32)
        stats["far_hits"] = stats["far_hits"] + far_loc.sum().to(torch.int32)

        # ---- 2. GPAC phase (own segment rows, hp-owned payload) -----------
        if use_gpac:
            re_view = _spread_hp(loc["re"], hp_ids, cfg.n_gpa_hp, -1)
            view = _view_state(cfg, gpt, rmap, gc, ih, re_view, epoch, stats)
            hot = telemetry.hot_mask(cfg, view, backend)
            score = pfilter.candidate_score(cfg, view, hot, T.cl_per_logical, kb)
            batches = pfilter.select_batches_from_rows(cfg, score, T.logical_pad,
                                                       max_batches, kb)
            gpt, rmap, loc["data"], loc["re"], stats = consolidator.consolidate_rounds_local(
                cfg, gpt, rmap, loc["data"], loc["re"], epoch, stats, batches,
                T.hp_pad, hp_lo, kb)

        # ---- 3a. this window's share of the group's collective ------------
        alloc_full = (rmap.view(cfg.n_gpa_hp, cfg.hp_ratio) != FREE).any(dim=1)
        alloc_loc = torch.where(hp_ids >= 0, alloc_full[safe_ids], False)
        contrib = dict(near=_spread_rows(mesh, near_loc), far=_spread_rows(mesh, far_loc))
        if "near_blocks" in collect:
            contrib["near_blocks"] = _spread_rows(
                mesh, _near_blocks_local(cfg, alloc_loc, loc["bt"], hp_lo, T.hp_pad))
        if tv is not None:
            contrib["tier_hits"] = tiers_mod.tier_hit_counts(tv, slot, valid)
            contrib["tier_blocks"] = tiers_mod.tier_block_counts(tv, loc["bt"], alloc_loc)
        if gstats is not None:
            contrib["stat_delta"] = {k: stats[k] - stats0[k] for k in stats}
            contrib["alloc_near"] = (alloc_loc & (loc["bt"] < cfg.n_near)).sum().to(torch.int32)
            contrib["alloc_tot"] = alloc_loc.sum().to(torch.int32)
        per_win.append(contrib)

        if j < stride - 1:
            roll()  # tick-less window: telemetry accumulates over the stride
        else:
            # ---- 3b. nominate on the stride's accumulated telemetry --------
            L = dict(hp_ids=hp_ids, hp_lo=hp_lo, hp_hi=H.hp_hi, bt=loc["bt"],
                     hc=loc["hc"], hh=loc["hh"], lt=loc["lt"], alloc=alloc_loc)
            payload = prepare(cfg, L, budget, **tkw)

    # ---- 3c. the group's one collective -----------------------------------
    exchange = dict(
        cands={n: {f: _place_block(mesh, x) for f, x in c.items()}
               for n, c in payload["cands"].items()},
        sums=payload["sums"],
        win=per_win,
    )
    merged = _unflatten(exchange, _psum(mesh, "host_exchange", _leaves(exchange)))
    mwin = merged["win"]

    # ---- 4. arbitration: replicated decisions, local block-table writes ---
    loc["bt"], tick_stats, swaps = apply(
        cfg, L, dict(cands=merged["cands"], sums=merged["sums"]), budget, **tkw)
    if mesh.rank == 0:  # replicated deltas: counted on one rank only
        for s in tick_stats:
            stats[s] = stats[s] + tick_stats[s]

    # ---- 5. the last window's roll (telemetry.end_window, by residency) ---
    roll()

    # ---- 6. per-window collector outputs -----------------------------------
    n_g = spec.n_guests
    emits = []
    for j in range(stride):
        last = j == stride - 1
        w = mwin[j]
        out_j = {}
        for name in collect:
            if name == "hits":
                emitted = dict(near_hits=w["near"][:n_g], far_hits=w["far"][:n_g])
            elif name == "near_blocks":
                pre = w["near_blocks"]
                if last:
                    pre = pre + _near_blocks_delta(spec, swaps, pre.shape[0])
                emitted = dict(near_blocks=pre[:n_g])
            elif name == "snapshot":
                # metrics.device_snapshot from the exchange: the same int
                # sums, so the same float32 quotients
                gstats = {k: gstats[k] + w["stat_delta"][k]
                          + (tick_stats[k] if last and k in tick_stats else 0)
                          for k in gstats}
                alloc_near = w["alloc_near"] + (_near_scalar_delta(cfg, swaps) if last else 0)
                emitted = dict(
                    epoch=epoch_in + j + 1,
                    near_usage=metrics._ratio(alloc_near, w["alloc_tot"].clamp(min=1)),
                    # the reference divides by the constant n_near inside
                    # jax.jit: a multiply by float32(1 / n_near)
                    near_capacity_used=alloc_near.to(torch.float32)
                    * float(np.float32(1) / np.float32(cfg.n_near)),
                    hit_rate=metrics._ratio(
                        gstats["near_hits"],
                        (gstats["near_hits"] + gstats["far_hits"]).clamp(min=1)),
                    **gstats,
                )
            elif name == "tco":
                blocks = w["tier_blocks"]
                if last:
                    blocks = blocks + tiers_mod.tier_count_delta(tv, swaps)
                emitted = tiers_mod.tco_metrics(cfg, tv, blocks, w["tier_hits"],
                                                jit_rounding=True)
            else:  # engine.run_sharded validates the collectors upfront
                raise ValueError(f"collector {name!r} has no host-sharded form")
            clash = set(emitted) & set(out_j)
            if clash:
                raise ValueError(
                    f"collector {name!r} emits keys {sorted(clash)} already "
                    f"produced by an earlier collector in {collect}")
            out_j.update(emitted)
        emits.append(out_j)

    new_carry = dict(gpt=gpt, rmap=rmap, guest_counts=gc, ipt_hist=ih, epoch=epoch,
                     stats=stats, loc=loc)
    if gstats is not None:
        new_carry["gstats"] = gstats
    return new_carry, emits


def _merge_host_final(cfg: GpacConfig, mesh: GuestMesh, H: HostRank, base: TieredState,
                      base_stats: dict, carry: dict) -> TieredState:
    """Chunk exit: rebuild the replicated state with one collective of
    ownership-placed contributions (segment rows for the guest arrays,
    block ranges for the host arrays, the payload written into the base
    pools at each own huge page's slot), then ``slot_owner`` as the merged
    block table's inverse -- the inverse ``tiering.swap_blocks`` keeps. The
    base pools are rewritten in place (this rank's rows, the rest zero) and
    reduced in place."""
    T = H.guests
    loc = carry["loc"]
    hp_ids = H.hp_ids
    n = cfg.n_gpa_hp
    keys = list(base_stats)

    def scatter_zero(x):
        out = x.new_zeros((n + 1,))
        out[torch.where(hp_ids >= 0, hp_ids, n).long()] = x
        return out[:n]

    leaves = [
        _owned(carry["gpt"], T.own_logical),
        _owned(carry["rmap"], T.own_gpa),
        _owned(carry["guest_counts"], T.own_logical),
        _owned(carry["ipt_hist"], T.own_logical),
        scatter_zero(loc["bt"]), scatter_zero(loc["hc"]), scatter_zero(loc["hh"]),
        scatter_zero(loc["lt"]), scatter_zero(loc["re"]),
        *[carry["stats"][k] - base_stats[k] for k in keys],
        (carry["epoch"] - base.epoch) * int(mesh.rank == 0),
    ]
    if mesh.size > 1:  # one rank rewrites every row
        base.near_pool.zero_()
        base.far_pool.zero_()
    valid = hp_ids >= 0
    for s in range(0, hp_ids.shape[0], _COPY_ROWS):
        rows = slice(s, s + _COPY_ROWS)
        slot, data = loc["bt"][rows], loc["data"][rows]
        to_near = valid[rows] & (slot < cfg.n_near)
        to_far = valid[rows] & (slot >= cfg.n_near) & (slot < cfg.n_slots)
        base.near_pool[slot[to_near]] = data[to_near]
        base.far_pool[slot[to_far] - cfg.n_near] = data[to_far]
    m = _psum(mesh, "host_chunk_exit", leaves, (base.near_pool, base.far_pool))
    gpt, rmap, gc, ih, bt, hc, hh, lt, re = m[:9]
    deltas, d_epoch = m[9:9 + len(keys)], m[9 + len(keys)]
    slot_owner = torch.zeros((cfg.n_slots,), dtype=torch.int32, device=bt.device)
    slot_owner[bt.long()] = torch.arange(n, dtype=torch.int32, device=bt.device)
    return dataclasses.replace(
        base, gpt=gpt, rmap=rmap, guest_counts=gc, ipt_hist=ih, block_table=bt,
        slot_owner=slot_owner, host_counts=hc, host_hist=hh, last_touch_epoch=lt,
        region_epoch=re, stats={k: base_stats[k] + d for k, d in zip(keys, deltas)},
        epoch=base.epoch + d_epoch)


def run_chunk_host_sharded(spec, mesh: GuestMesh, state: TieredState,
                           accs: list[torch.Tensor], *, policy: str, backend: str,
                           use_gpac: bool, max_batches: int, budget: int,
                           collect: tuple[str, ...]):
    """One chunk of the host-partitioned engine (``engine.run_sharded(
    host_sharded=True)``'s inner loop): slice the replicated state into this
    rank's range, run the chunk's arbitration groups on the partitioned
    carry, rebuild the state at the exit. ``accs`` holds this rank's
    accesses of every window of the chunk (a whole number of groups).
    Returns the state and one output dict per window."""
    cfg = spec.cfg
    stride = spec.arbitration_stride
    H = host_rank(spec, mesh.size, mesh.rank, state.device)
    base_stats = dict(state.stats)
    carry = dict(gpt=state.gpt, rmap=state.rmap, guest_counts=state.guest_counts,
                 ipt_hist=state.ipt_hist, epoch=state.epoch, stats=dict(state.stats),
                 loc=_slice_host_local(cfg, state, H.hp_ids))
    if "snapshot" in collect:
        carry["gstats"] = dict(state.stats)
    outs = []
    for g in range(0, len(accs), stride):
        carry, emits = _host_sharded_group(
            spec, mesh, H, carry, accs[g:g + stride], policy, backend, use_gpac,
            max_batches, budget, collect)
        outs.extend(emits)
    return _merge_host_final(cfg, mesh, H, state, base_stats, carry), outs
