"""The registered invariant contracts (port of ``repro.contracts.invariants``,
DESIGN.md §15).

Ten contracts: churn no-op, crash reclaim, the 2-tier special case and the
pressure controller's bounds (DESIGN.md §10's ledger), ownership merge,
chunking invariance, synthesis determinism and the arbitration tie-break,
the kernel backend's exactness (§16) and the multi-rank exactness of the
distributed runtime and its batched arbitration exchange (§17). Each
``check_fn(draw, device=None)`` takes one
:class:`~repro_torch.contracts.draws.ContractDraw`, runs on ``device``
(CUDA unless named) and raises ``AssertionError`` on violation.

The port's state is updated in place by the drivers (``core.types``), so
every run here starts from a state of its own
(``engine.init_engine_state``), never from one an earlier run consumed.
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from repro_torch.contracts.draws import ContractDraw, build_engine, trace_source
from repro_torch.contracts.registry import register_contract


# --------------------------------------------------------------------------
# shared assertion helpers
# --------------------------------------------------------------------------
def _leaves(tree) -> list:
    """Every array leaf of a state, a churn carry or a nested dict, in a
    fixed order (dataclass fields in order, dict keys sorted)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    raise TypeError(f"no array leaves in a {type(tree).__name__}")


def _bits(x) -> tuple:
    """(dtype, shape, the bytes) of one leaf, copied to the host."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return str(t.dtype), tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy()
    a = np.ascontiguousarray(x)
    return str(a.dtype), a.shape, a.reshape(-1).view(np.uint8)


def _assert_same_leaf(x, y, msg: str) -> None:
    dx, sx, bx = _bits(x)
    dy, sy, by = _bits(y)
    assert dx == dy, f"{msg}: dtype {dx} != {dy}"
    assert sx == sy, f"{msg}: shape {sx} != {sy}"
    assert np.array_equal(bx, by), f"{msg}: values differ"


def assert_states_equal(a, b, msg: str = ""):
    """Bit-for-bit equality of two states or carries, every leaf, dtype
    included (the §10 exactness discipline)."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), f"{msg}: leaf count {len(la)} != {len(lb)}"
    for i, (x, y) in enumerate(zip(la, lb)):
        _assert_same_leaf(x, y, f"{msg} (leaf {i})")


def assert_series_equal(a: dict, b: dict, msg: str = ""):
    assert set(a) == set(b), f"{msg}: keys {sorted(a)} != {sorted(b)}"
    for k in a:
        _assert_same_leaf(a[k], b[k], f"{msg}:{k}")


def _fresh(spec, device):
    """A new identity state: what ``build_engine`` returned, unconsumed."""
    from repro_torch.core import engine

    return engine.init_engine_state(spec, device=device)


def _copy_state(state):
    return dataclasses.replace(
        state, **{f.name: getattr(state, f.name).clone()
                  for f in dataclasses.fields(state) if f.name != "stats"},
        stats={k: v.clone() for k, v in state.stats.items()})


def _runs(draw: ContractDraw) -> dict:
    return dict(policy=draw.policy, use_gpac=draw.use_gpac)


# --------------------------------------------------------------------------
# §9/§11 -- ownership merge
# --------------------------------------------------------------------------
@register_contract(
    "INV-OWNERSHIP-MERGE-EXACT", "§9/§11",
    drivers=("run", "run_sharded", "run_sharded(host_sharded=True)"),
    pins=(
        "tests/test_torch_sharding.py::test_sharded_run_matches_reference",
        "tests/test_torch_host_sharding.py::test_host_sharded_run_matches_reference",
    ),
    max_examples=3,
)
def check_ownership_merge_exact(draw: ContractDraw, device=None):
    """Segment/slot-ownership psums reconstruct every array exactly:
    ``run_sharded`` (on a one-rank process group, the whole collective
    path, both host paths) is bit-identical to ``run`` for any geometry,
    policy and gpac draw."""
    from repro_torch.core import engine, sharding

    spec, s0 = build_engine(draw, device)
    dev = s0.device
    source = trace_source(draw, spec)
    mesh = sharding.guest_mesh(1, device=dev)
    ref_state, ref = engine.run(spec, s0, source, device=dev, **_runs(draw))
    sh_state, sh = engine.run_sharded(
        spec, _fresh(spec, dev), source, mesh=mesh,
        host_sharded=draw.host_sharded, device=dev, **_runs(draw))
    assert_states_equal(ref_state, sh_state, "run_sharded state diverged")
    assert_series_equal(ref, sh, "run_sharded series diverged")


# --------------------------------------------------------------------------
# §7/§9 -- chunking invariance (replay path)
# --------------------------------------------------------------------------
@register_contract(
    "INV-CHUNKING-INVARIANT", "§7/§9",
    drivers=("run", "run_sharded", "run_churn"),
    pins=(
        "tests/test_torch_engine.py::test_run_matches_reference",
        "tests/test_torch_churn.py::test_chunking_and_split_calls_are_invariant",
    ),
    max_examples=3,
)
def check_chunking_invariant(draw: ContractDraw, device=None):
    """``windows_per_step`` is a pure batching knob: any chunking of the
    window loop -- including non-dividing strict sizes with a shorter
    trailing chunk -- yields the bit-identical final state and series."""
    from repro_torch.core import engine

    spec, s0 = build_engine(draw, device)
    dev = s0.device
    traces = engine.guest_traces(
        spec, n_windows=draw.n_windows,
        accesses_per_window=draw.accesses_per_window)
    ref_state, ref = engine.run(spec, s0, traces, device=dev, **_runs(draw))
    ch_state, ch = engine.run(
        spec, _fresh(spec, dev), traces, windows_per_step=draw.windows_per_step,
        strict_wps=True, device=dev, **_runs(draw))
    assert_states_equal(ref_state, ch_state, "chunked state diverged")
    assert_series_equal(ref, ch, "chunked series diverged")


# --------------------------------------------------------------------------
# §12 -- on-device synthesis determinism
# --------------------------------------------------------------------------
@register_contract(
    "INV-SYNTH-DETERMINISM", "§12",
    drivers=("run", "run_sharded", "run_churn"),
    pins=(
        "tests/test_torch_synth.py::test_run_over_synth_trace_matches_reference",
        "tests/test_torch_synth.py::test_window_functions_match",
    ),
    max_examples=2,
)
def check_synth_determinism(draw: ContractDraw, device=None):
    """Counter-based synthesis depends only on ``(workload, seed, gid, w)``:
    re-running and re-chunking a SynthTrace run is bit-identical, and the
    host-side materializer is deterministic per spec."""
    from repro_torch.core import engine
    from repro_torch.data import traces as tr

    spec, s0 = build_engine(draw, device)
    dev = s0.device
    synth = engine.SynthTrace(
        n_windows=draw.n_windows,
        accesses_per_window=draw.accesses_per_window)
    a_state, a = engine.run(spec, s0, synth, device=dev, **_runs(draw))
    b_state, b = engine.run(  # identical second run
        spec, _fresh(spec, dev), synth, device=dev, **_runs(draw))
    assert_states_equal(a_state, b_state, "synth rerun diverged")
    assert_series_equal(a, b, "synth rerun series diverged")
    c_state, c = engine.run(  # any chunking re-derives identical windows
        spec, _fresh(spec, dev), synth, windows_per_step=draw.windows_per_step,
        strict_wps=True, device=dev, **_runs(draw))
    assert_states_equal(a_state, c_state, "synth chunking diverged")
    assert_series_equal(a, c, "synth chunking series diverged")
    g = draw.guests[draw.seed % len(draw.guests)]
    ts = tr.TraceSpec(
        workload=g.workload, n_logical=g.n_logical, hp_ratio=draw.hp_ratio,
        n_windows=2, accesses_per_window=draw.accesses_per_window,
        seed=g.seed)
    assert_series_equal(
        {"trace": tr.synth_generate(ts, gid=3, device=dev)},
        {"trace": tr.synth_generate(ts, gid=3, device=dev)},
        "synth_generate not deterministic per (workload, seed, gid)")


# --------------------------------------------------------------------------
# §11 -- arbitration tie-break
# --------------------------------------------------------------------------
@register_contract(
    "INV-ARBITRATION-TIEBREAK", "§11",
    drivers=("run_sharded(host_sharded=True)",),
    pins=("tests/test_torch_host_sharding.py::test_arbitration_edge_layouts",),
    max_examples=75,
)
def check_arbitration_tiebreak(draw: ContractDraw, device=None):
    """Per-partition ``nominate`` + replicated ``rank_select`` reproduces
    ``jax.lax.top_k`` over the full per-block score array bit-for-bit --
    ties resolve to the lowest block id -- for any partition layout,
    including empty ranges and mass-tie score fields.

    The oracle is a stable descending ``torch.sort`` of the whole array on
    the host, which orders ties as ``lax.top_k`` does (``torch.topk``
    leaves their order unspecified on CUDA)."""
    from repro_torch.core import tiering
    from repro_torch.kernels import runtime

    dev = runtime.resolve_device(device)
    rng = np.random.default_rng(draw.seed)
    n_blocks = int(rng.integers(6, 40))
    b = min(draw.budget, n_blocks)
    # small value range -> heavy cross-partition tie pressure
    val = rng.integers(0, 4, n_blocks).astype(np.int32)
    mask = rng.random(n_blocks) < 0.7
    parts = min(draw.n_guests + 1, n_blocks)
    cuts = np.linspace(0, n_blocks, parts + 1).astype(int)
    h_loc = max(1, int(max(hi - lo for lo, hi in zip(cuts[:-1], cuts[1:]))))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    noms = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        hp_ids = np.full(h_loc, -1, np.int32)
        hp_ids[: hi - lo] = np.arange(lo, hi, dtype=np.int32)
        take = np.clip(hp_ids, 0, None)
        cnt = np.where(hp_ids >= 0, val[take], 0).astype(np.int32)
        noms.append(tiering.nominate(
            t(np.where(hp_ids >= 0, mask[take], False)), t(cnt), b,
            hp_ids=t(hp_ids), slot=t(take.astype(np.int32)),
            alloc=t(np.ones(h_loc, np.int32)), cnt=t(cnt)))
    merged = {f: torch.stack([n[f] for n in noms]).reshape(-1) for f in noms[0]}
    picked = tiering.rank_select(merged, b)

    full = torch.from_numpy(np.where(mask, val, int(tiering.NEG)).astype(np.int32))
    ref_v, ref_i = torch.sort(full, descending=True, stable=True)
    ref_v, ref_i = ref_v[:b].numpy(), ref_i[:b].numpy().astype(np.int32)
    ref_ids = np.where(ref_v > tiering.NEG, ref_i, -1).astype(np.int32)
    ref_vals = np.where(ref_ids >= 0, ref_v, tiering.NEG).astype(np.int32)
    assert np.array_equal(picked["id"].cpu().numpy(), ref_ids), (
        "rank_select ids diverge from the full-array top-k tie-break: "
        f"{picked['id'].tolist()} != {ref_ids.tolist()}")
    assert np.array_equal(picked["val"].cpu().numpy(), ref_vals), (
        "rank_select vals diverge from the full-array top-k")


# --------------------------------------------------------------------------
# §13 -- churn no-op exactness
# --------------------------------------------------------------------------
@register_contract(
    "INV-CHURN-NOOP-EXACT", "§13",
    drivers=("run", "run_churn"),
    pins=("tests/test_torch_churn.py::test_no_fault_churn_equals_run",),
    max_examples=3,
)
def check_churn_noop_exact(draw: ContractDraw, device=None):
    """With no faults scheduled the §13 stepper is a provable no-op:
    ``run_churn`` is bit-identical to ``run`` in the final state and every
    collector series, with all lanes active and zero pressure."""
    from repro_torch.core import engine

    spec, s0 = build_engine(draw, device)
    dev = s0.device
    source = trace_source(draw, spec)
    ref_state, ref = engine.run(spec, s0, source, device=dev, **_runs(draw))
    cs, se = engine.run_churn(
        spec, engine.init_churn(spec, _fresh(spec, dev), device=dev), source,
        device=dev, **_runs(draw))
    assert_states_equal(ref_state, cs.state, "idle churn state diverged")
    assert_series_equal(
        ref, {k: v for k, v in se.items() if k not in engine._CHURN_SERIES},
        "idle churn series diverged")
    assert np.asarray(se["active"]).all(), "idle churn deactivated a lane"
    assert not np.asarray(se["pressure"]).any(), "idle churn reported pressure"


# --------------------------------------------------------------------------
# §13 -- crash reclaim completeness
# --------------------------------------------------------------------------
@register_contract(
    "INV-CRASH-RECLAIM-COMPLETE", "§13",
    drivers=("run_churn",),
    pins=("tests/test_torch_churn.py::test_every_fault_kind_matches_reference",),
    max_examples=3,
)
def check_crash_reclaim_complete(draw: ContractDraw, device=None):
    """Within the window a guest crashes its whole GPA segment is FREE with
    no allocated huge pages, its near blocks return to the pool (the crash
    window already reports zero), and the block table stays a permutation
    with ``slot_owner`` its inverse."""
    from repro_torch.core import engine, faults
    from repro_torch.core.types import FREE, allocated_hp_mask

    spec, s0 = build_engine(draw, device)
    dev = s0.device
    victim = draw.seed % draw.n_guests
    crash_w = draw.n_windows // 2
    sched = faults.FaultSchedule(draw.n_guests).crash(crash_w, victim)
    cs, se = engine.run_churn(
        spec, engine.init_churn(spec, s0, device=dev), trace_source(draw, spec),
        faults=sched, device=dev, **_runs(draw))
    blocks = np.asarray(se["near_blocks"])
    assert (blocks[crash_w:, victim] == 0).all(), (
        "crashed guest still holds near blocks after its crash window")
    hp_lo, hp_hi = spec.hp_range(victim)
    r = spec.cfg.hp_ratio
    rmap = cs.state.rmap.cpu().numpy()
    assert (rmap[hp_lo * r: hp_hi * r] == FREE).all(), (
        "crashed guest's GPA segment is not fully FREE")
    alloc = allocated_hp_mask(spec.cfg, cs.state).cpu().numpy()
    assert not alloc[hp_lo:hp_hi].any(), (
        "allocated huge pages orphaned in the crashed guest's segment")
    bt = cs.state.block_table.cpu().numpy()
    assert len(np.unique(bt)) == bt.size, "block table lost permutation"
    so = cs.state.slot_owner.cpu().numpy()
    assert np.array_equal(so[bt], np.arange(bt.size)), (
        "slot_owner is no longer the block table's inverse")


# --------------------------------------------------------------------------
# §14 -- 2-tier special case of the flow generalization
# --------------------------------------------------------------------------
def _touched_state(draw: ContractDraw, spec, device):
    """Every allocated block far, then 64 seeded accesses recorded."""
    from repro_torch.core import address_space as asp
    from repro_torch.core import init_state, start_all_far

    cfg = spec.cfg
    rng = np.random.default_rng(draw.seed)
    state = start_all_far(cfg, init_state(cfg, device=device))
    ids = torch.from_numpy(
        rng.integers(0, cfg.n_logical, size=64).astype(np.int32)).to(device)
    return asp.record_accesses(cfg, state, ids)


@register_contract(
    "INV-TIER-2SPECIALCASE-EXACT", "§14",
    drivers=("run", "run_sharded", "run_sharded(host_sharded=True)",
             "run_churn"),
    pins=("tests/test_torch_tiers.py::test_two_tier_special_case",),
    max_examples=40,
)
def check_tier_2specialcase_exact(draw: ContractDraw, device=None):
    """Every legacy policy tick equals its ``two_tier`` flow
    parameterization bit-for-bit for any config/telemetry: the extra
    tier-range predicates are tautologies on ``(0, n_near, n_slots)``."""
    from repro_torch.core import tiering, tiers

    spec, s0 = build_engine(draw, device)
    cfg = spec.cfg
    state = _touched_state(draw, spec, s0.device)
    legacy = tiering.tick(cfg, _copy_state(state), draw.policy, budget=draw.budget)
    flow = tiering.tick(cfg, state, draw.policy, budget=draw.budget,
                        tiers=tiers.two_tier(cfg))
    assert_states_equal(legacy, flow, f"{draw.policy} two_tier flow diverged")


# --------------------------------------------------------------------------
# §13/§14 -- pressure controller bounds
# --------------------------------------------------------------------------
@register_contract(
    "INV-PRESSURE-NO-OVERCOMMIT", "§13/§14",
    drivers=("run_churn",),
    pins=("tests/test_torch_churn.py::test_pressure_tick_shrink_and_grow_back",),
    max_examples=40,
)
def check_pressure_no_overcommit(draw: ContractDraw, device=None):
    """The pressure controller never promotes, demotes at most ``budget``
    blocks, reports ``engaged == (usage > cap)``, and lands exactly on the
    low watermark whenever enough cold candidates, free far slots and
    budget exist."""
    from repro_torch.core import tiering
    from repro_torch.core.types import allocated_hp_mask

    spec, s0 = build_engine(draw, device)
    dev = s0.device
    cfg = spec.cfg
    state = tiering.tick(cfg, _touched_state(draw, spec, dev), "memtierd")

    def near_used(s):
        alloc = allocated_hp_mask(cfg, s).cpu().numpy()
        return int((alloc & (s.block_table.cpu().numpy() < cfg.n_near)).sum())

    used = near_used(state)
    n_alloc = int(allocated_hp_mask(cfg, state).sum())
    out, engaged, _ = tiering.pressure_tick(
        cfg, state, torch.full((), draw.cap, dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        budget=draw.budget, slack=draw.slack)
    used2 = near_used(out)
    bt = out.block_table.cpu().numpy()
    assert sorted(bt) == list(range(cfg.n_slots)), "lost slot permutation"
    assert bool(engaged) == (used > draw.cap), "engaged != (usage > cap)"
    assert used2 <= used, "pressure tick promoted"
    assert used - used2 <= draw.budget, "demoted more than the budget"
    target = max(draw.cap - draw.slack, 0)
    free_far = (cfg.n_slots - cfg.n_near) - (n_alloc - used)
    if used > draw.cap and used - target <= draw.budget \
            and free_far >= used - target:
        assert used2 == target, "did not land on the low watermark"


# --------------------------------------------------------------------------
# §16 -- kernel backend exactness
# --------------------------------------------------------------------------
# the engine's hand kernels K2-K4, which GPAC maintenance launches (K1,
# bincount, runs in every churn window)
GPAC_KERNELS = ("hot_count", "topk_rows", "gather_rows")


@register_contract(
    "INV-KERNEL-BACKEND-EXACT", "§16",
    drivers=("run", "run_sharded", "run_sharded(host_sharded=True)",
             "run_churn"),
    pins=(
        "tests/test_torch_kernels.py::test_torch_backend_runs_the_plain_version",
        "tests/test_torch_churn.py::test_churn_kernels_match_plain_on_card",
    ),
    max_examples=2,
)
def check_kernel_backend_exact(draw: ContractDraw, device=None):
    """The engine's hot-path kernels are backend-transparent: running any
    driver with ``kernel_backend="auto"`` (the hand kernels) is
    bit-identical to ``kernel_backend="torch"`` (their plain versions) in
    the final state and every collector series, for any geometry/policy/gpac
    draw.

    On CUDA the check also reads the kernels' launch counts: the three
    ``"auto"`` runs must have launched ``bincount``, and with GPAC on also
    ``hot_count``, ``topk_rows`` and ``gather_rows``; the ``"torch"`` runs
    must have launched none. On the CPU the ``"auto"`` wrappers take their
    plain versions (the tensors lie on the CPU), so there the check holds
    the plain version to itself and launches nothing."""
    from repro_torch.core import engine, sharding
    from repro_torch.kernels import registry as kernels

    spec, s0 = build_engine(draw, device)
    dev = s0.device
    source = trace_source(draw, spec)
    mesh = sharding.guest_mesh(1, device=dev)

    def drivers(kernel_backend: str, state0):
        """run, run_sharded and run_churn under one backend, and the
        launches they made."""
        kw = dict(kernel_backend=kernel_backend, device=dev, **_runs(draw))
        before = kernels.launch_counts()
        out = dict(
            run=engine.run(spec, state0, source, **kw),
            run_sharded=engine.run_sharded(
                spec, _fresh(spec, dev), source, mesh=mesh,
                host_sharded=draw.host_sharded, **kw))
        cs, se = engine.run_churn(
            spec, engine.init_churn(spec, _fresh(spec, dev), device=dev), source, **kw)
        out["run_churn"] = (cs.state, {k: v for k, v in se.items()
                                       if k not in engine._CHURN_SERIES})
        after = kernels.launch_counts()
        return out, {k: after[k] - before[k] for k in after}

    plain, plain_launches = drivers("torch", s0)
    ref_state, ref = plain["run"]
    auto, auto_launches = drivers("auto", _fresh(spec, dev))
    for name, (st, series) in (*plain.items(), *auto.items()):
        assert_states_equal(ref_state, st, f"{name} state diverged")
        assert_series_equal(ref, series, f"{name} series diverged")
    assert not any(plain_launches.values()), (
        f"kernel_backend='torch' launched kernels: {plain_launches}")
    if dev.type == "cuda":
        want = ("bincount", *GPAC_KERNELS) if draw.use_gpac else ("bincount",)
        missing = [k for k in want if not auto_launches[k]]
        assert not missing, (
            f"kernel_backend='auto' never launched {missing}: {auto_launches}")


# --------------------------------------------------------------------------
# §17 -- multi-rank exactness
# --------------------------------------------------------------------------
_MULTIHOST_JOB_VERIFIED = False
MULTIHOST_MARKER = "MULTIHOST CHECK OK"


@register_contract(
    "INV-MULTIHOST-EXACT", "§17",
    drivers=("run", "run_sharded", "run_sharded(host_sharded=True)",
             "run_churn"),
    pins=(
        "tests/test_torch_multihost.py::test_two_rank_job_migrates_and_churns_like_the_reference",
    ),
    max_examples=2,
)
def check_multihost_exact(draw: ContractDraw, device=None):
    """An engine run spanning OS processes, and any ``arbitration_stride``
    batching of its exchange, is bit-identical to the single-process
    default: stride=1 is the default program, a dividing stride>1 matches
    across ``run``/``run_sharded`` on both host paths, and a coordinated
    2-process job reproduces the in-process run.

    The job (``contracts/multihost_check.py``, 2 ranks over gloo on the
    draw's device type: NCCL refuses two ranks on one card) runs once per
    process."""
    from repro_torch.core import engine, sharding

    spec, s0 = build_engine(draw, device)
    dev = s0.device
    source = trace_source(draw, spec)
    ref_state, ref = engine.run(spec, s0, source, device=dev, **_runs(draw))
    s1_state, s1 = engine.run(  # stride=1 is the default program
        spec, _fresh(spec, dev), source, arbitration_stride=1, device=dev,
        **_runs(draw))
    assert_states_equal(ref_state, s1_state, "stride=1 state diverged")
    assert_series_equal(ref, s1, "stride=1 series diverged")

    # smallest prime factor of n_windows: a dividing stride > 1 when one
    # exists (prime window counts only get the stride=1 pin above)
    stride = next((d for d in range(2, draw.n_windows + 1)
                   if draw.n_windows % d == 0), 1)
    if stride > 1:
        st_state, st = engine.run(
            spec, _fresh(spec, dev), source, arbitration_stride=stride,
            device=dev, **_runs(draw))
        mesh = sharding.guest_mesh(1, device=dev)
        sh_state, sh = engine.run_sharded(
            spec, _fresh(spec, dev), source, mesh=mesh,
            host_sharded=draw.host_sharded, arbitration_stride=stride,
            device=dev, **_runs(draw))
        assert_states_equal(
            st_state, sh_state, f"stride={stride} sharded state diverged")
        assert_series_equal(
            st, sh, f"stride={stride} sharded series diverged")

    # the coordinated 2-process job, once per process (two interpreter and
    # torch starts; the worker asserts bit-equality against each rank's own
    # single-process run)
    global _MULTIHOST_JOB_VERIFIED
    if not _MULTIHOST_JOB_VERIFIED:
        from repro_torch.launch import multihost

        worker = pathlib.Path(__file__).resolve().with_name("multihost_check.py")
        multihost.launch_check(
            str(worker), marker=MULTIHOST_MARKER, num_processes=2,
            device=dev.type, backend="gloo", cwd=str(worker.parents[3]),
            timeout=300)
        _MULTIHOST_JOB_VERIFIED = True
