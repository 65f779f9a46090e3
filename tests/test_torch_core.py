"""The port's core modules against the JAX reference, one module at a time.

Each test feeds the same numpy state and inputs to a JAX function and to its
PyTorch counterpart (on the CPU, i.e. the kernels' plain versions) and holds
the results equal bit for bit, dtypes included. The shared starting states
come from one JAX computation per module: a small two-guest engine with a
distinct payload per page, run for three windows so that histories, touch
epochs and consolidated regions are populated.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import address_space as jasp  # noqa: E402
from repro.core import consolidator as jcons  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import filter as jfilter  # noqa: E402
from repro.core import gpac as jgpac  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import telemetry as jtel  # noqa: E402
from repro.core import tiering as jtier  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import address_space as asp  # noqa: E402
from repro_torch.core import consolidator as cons  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import filter as pfilter  # noqa: E402
from repro_torch.core import gpac  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core import telemetry as tel  # noqa: E402
from repro_torch.core import tiering  # noqa: E402
from repro_torch.core import types  # noqa: E402

HOST = dict(hp_ratio=16, near_fraction=0.25, base_elems=3, cl=6)
GUESTS = (256, 300)
MAX_BATCHES = 3
BUDGET = 6  # fewer than the candidates, so the budget binds


def to_numpy(state) -> dict:
    """Either package's state as a dict of numpy arrays."""
    if isinstance(state, types.TieredState):
        return interop.state_to_numpy(state)
    d = {f.name: np.asarray(getattr(state, f.name))
         for f in dataclasses.fields(state) if f.name != "stats"}
    d["stats"] = {k: np.asarray(v) for k, v in state.stats.items()}
    return d


def jax_state(d: dict):
    kw = {k: jnp.asarray(v) for k, v in d.items() if k != "stats"}
    kw["stats"] = {k: jnp.asarray(v) for k, v in d["stats"].items()}
    return jtypes.TieredState(**kw)


def jit(fn, *static):
    """A JAX reference function jitted, ``static`` its hashable argument
    positions: eager JAX dispatches op by op, which takes seconds here."""
    return jax.jit(fn, static_argnums=static)


def port_state(d: dict):
    return interop.state_from_numpy(d, device="cpu")


def same(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), what


def same_state(ref, got):
    ref, got = to_numpy(ref), to_numpy(got)
    for k in ref:
        if k == "stats":
            assert set(ref[k]) == set(got[k])
            for s in ref[k]:
                same(ref[k][s], got[k][s], f"stats.{s}")
        else:
            same(ref[k], got[k], k)


class World:
    """The shared reference: specs of both packages, a lived-in state after
    three windows (``s0``, counts cleared) and the same state in the middle
    of a window (``s1``, this window's accesses recorded)."""

    def __init__(self):
        jguests = [jengine.GuestSpec(n, seed=g) for g, n in enumerate(GUESTS)]
        self.jspec, st = jengine.build(jguests, jengine.HostSpec(**HOST))
        self.spec, _ = engine.build(
            [engine.GuestSpec(n, seed=g) for g, n in enumerate(GUESTS)],
            engine.HostSpec(**HOST), device="cpu")
        self.cfg, self.jcfg = self.spec.cfg, self.jspec.cfg
        n, e = self.cfg.n_logical, self.cfg.base_elems
        self.fill = (np.arange(n * e, dtype=np.float32).reshape(n, e) * 0.25 - 7.0)
        st = jit(jasp.write_logical, 0)(self.jcfg, st, np.arange(n, dtype=np.int32), self.fill)
        self.fresh = to_numpy(st)
        tr = jengine.guest_traces(self.jspec, 4, 512)
        st, _ = jengine.run(self.jspec, st, tr[:, :3], max_batches=MAX_BATCHES)
        self.s0 = to_numpy(st)
        self.batch = self.jspec.localize(jnp.asarray(tr[:, 3])).reshape(-1)
        st = jit(jasp.record_accesses, 0)(self.jcfg, st, self.batch)
        self.s1 = to_numpy(st)
        # the next GPAC pass's batches
        hot = jtel.hot_mask_ipt(self.jcfg, st)
        self.batches = np.array(jit(jfilter.select_batches_ragged, 0, 3)(
            self.jspec, st, hot, MAX_BATCHES))


@pytest.fixture(scope="module")
def w():
    return World()


# ---- types -----------------------------------------------------------------
def test_config_validation_matches():
    for kw in (dict(n_logical=0), dict(n_logical=100, hp_ratio=0),
               dict(n_logical=100, hp_ratio=8, cl=8, n_gpa_hp=5),
               dict(n_logical=100, hp_ratio=8, cl=8, n_near=40),
               dict(n_logical=100, hp_ratio=8, cl=9)):
        with pytest.raises(ValueError):
            jtypes.GpacConfig(**kw)
        with pytest.raises(ValueError):
            types.GpacConfig(**kw)
    a = jtypes.GpacConfig(n_logical=1000, hp_ratio=16, cl=16)
    b = types.GpacConfig(n_logical=1000, hp_ratio=16, cl=16)
    assert (a.n_gpa_hp, a.n_near, a.base_bytes) == (b.n_gpa_hp, b.n_near, b.base_bytes)


def test_init_state_with_fill_and_start_all_far(w):
    jst = jtypes.init_state(w.jcfg, jnp.asarray(w.fill))
    st = types.init_state(w.cfg, torch.from_numpy(w.fill), device="cpu")
    same_state(jst, st)
    same_state(jit(jtypes.start_all_far, 0)(w.jcfg, jst), types.start_all_far(w.cfg, st))
    same(jtypes.allocated_hp_mask(w.jcfg, jst), types.allocated_hp_mask(w.cfg, st))


# ---- address_space ---------------------------------------------------------
def test_translate_and_fused_translation(w):
    ids = np.array([-3, 0, 5, w.cfg.n_logical - 1, w.cfg.n_logical, 10**6, 77], np.int32)
    ref = jit(jasp.translate, 0)(w.jcfg, jax_state(w.s0), jnp.asarray(ids))
    got = asp.translate(w.cfg, port_state(w.s0), torch.from_numpy(ids))
    for r, g, name in zip(ref, got, ("slot", "off", "valid")):
        same(r, g, name)
    same(jasp.fused_translation(w.jcfg, jax_state(w.s0)),
         asp.fused_translation(w.cfg, port_state(w.s0)))


def test_read_and_write_logical(w):
    ids = np.array([-1, 0, 3, 17, w.cfg.n_logical - 1, w.cfg.n_logical + 4], np.int32)
    same(jit(jasp.read_logical, 0)(w.jcfg, jax_state(w.s0), jnp.asarray(ids)),
         asp.read_logical(w.cfg, port_state(w.s0), torch.from_numpy(ids)))
    vals = np.full((ids.size, w.cfg.base_elems), 3.5, np.float32)
    same_state(jit(jasp.write_logical, 0)(w.jcfg, jax_state(w.s0), jnp.asarray(ids),
                                          jnp.asarray(vals)),
               asp.write_logical(w.cfg, port_state(w.s0), torch.from_numpy(ids),
                                 torch.from_numpy(vals)))


def test_record_accesses(w):
    """Both branches: the histogram (2k >= n) and the per-access scatter,
    unweighted and weighted."""
    rng = np.random.default_rng(3)
    n = w.cfg.n_logical
    for branch in ("histogram", "scatter", "weighted"):
        k = n if branch == "histogram" else n // 4
        ids = rng.integers(-5, n + 5, size=k).astype(np.int32)
        counts = rng.integers(0, 4, size=k).astype(np.int32) if branch == "weighted" else None
        jc = None if counts is None else jnp.asarray(counts)
        tc = None if counts is None else torch.from_numpy(counts)
        same_state(jit(jasp.record_accesses, 0)(w.jcfg, jax_state(w.s0), jnp.asarray(ids), jc),
                   asp.record_accesses(w.cfg, port_state(w.s0), torch.from_numpy(ids), tc))


def test_alloc_free_huge_region(w):
    for rng_ in (None, (0, 5), (9, 12), (3, 3)):
        same(jit(jasp.alloc_free_huge_region, 0, 2)(w.jcfg, jax_state(w.s0), rng_),
             asp.alloc_free_huge_region(w.cfg, port_state(w.s0), rng_))


# ---- telemetry -------------------------------------------------------------
def test_end_window(w):
    same_state(jit(jtel.end_window, 0)(w.jcfg, jax_state(w.s1)),
               tel.end_window(w.cfg, port_state(w.s1)))


def test_hot_masks(w):
    """The ipt, damon and pebs classifiers and the per-huge-page counts
    (pebs in jax's default threefry layout, which the port's pebs draws
    in)."""
    for backend in ("ipt", "damon"):
        jhot = jtel.hot_mask(w.jcfg, jax_state(w.s1), backend)
        hot = tel.hot_mask(w.cfg, port_state(w.s1), backend)
        same(jhot, hot, backend)
        same(jit(jtel.hot_subpages_per_hp, 0)(w.jcfg, jax_state(w.s1), jhot),
             tel.hot_subpages_per_hp(w.cfg, port_state(w.s1), hot), backend)
    same(jit(jtel.accessed_subpages_per_hp, 0)(w.jcfg, jax_state(w.s1)),
         tel.accessed_subpages_per_hp(w.cfg, port_state(w.s1)))
    layout = bool(jax.config.jax_threefry_partitionable)
    jax.config.update("jax_threefry_partitionable", True)
    try:
        jhot = jtel.hot_mask(w.jcfg, jax_state(w.s1), "pebs")
    finally:
        jax.config.update("jax_threefry_partitionable", layout)
    same(jhot, tel.hot_mask(w.cfg, port_state(w.s1), "pebs"), "pebs")


# ---- filter ----------------------------------------------------------------
def test_candidate_score_and_batch_selection(w):
    jst, st = jax_state(w.s1), port_state(w.s1)
    jhot, hot = jtel.hot_mask_ipt(w.jcfg, jst), tel.hot_mask_ipt(w.cfg, st)
    cl = w.jspec.cl_per_logical()
    jscore = jit(jfilter.candidate_score, 0)(w.jcfg, jst, jhot, jnp.asarray(cl))
    score = pfilter.candidate_score(w.cfg, st, hot, torch.from_numpy(cl))
    same(jscore, score)
    same(jfilter._hotness_score(jst), pfilter._hotness_score(st))
    pad = w.jspec.logical_pad_index()
    for mb in (1, MAX_BATCHES, 40):  # 40 * 16 > max_logical pads the rows
        same(jit(jfilter.select_batches_from_rows, 0, 3)(w.jcfg, jscore, jnp.asarray(pad), mb),
             pfilter.select_batches_from_rows(w.cfg, score, torch.from_numpy(pad), mb))
    same(w.batches, pfilter.select_batches_ragged(w.spec, st, hot, MAX_BATCHES))


# ---- consolidator and gpac -------------------------------------------------
def test_consolidate_rounds_with_fill(w):
    jst, batches = jax_state(w.s1), w.batches
    assert (batches >= 0).sum() > 0  # the payload copy really moves pages
    hp_pad = w.jspec.hp_pad_index()
    ref = jit(jcons.consolidate_rounds, 0)(w.jcfg, jst, jnp.asarray(batches), jnp.asarray(hp_pad))
    got = cons.consolidate_rounds(w.cfg, port_state(w.s1), torch.from_numpy(batches),
                                  torch.from_numpy(hp_pad))
    same_state(ref, got)
    assert int(got.stats["consolidated_pages"]) > int(w.s1["stats"]["consolidated_pages"])
    # consolidation moved bytes and mappings but lost no page's payload
    all_ids = torch.arange(w.cfg.n_logical, dtype=torch.int32)
    same(w.fill, asp.read_logical(w.cfg, got, all_ids))


def test_consolidate_pages_and_ragged_forms(w):
    """One invocation confined to a guest's segment, one round over every
    guest, and every guest's batches round-major from the spec."""
    batches, seg = w.batches, w.jspec.hp_range(1)
    ref = jit(jcons.consolidate_pages, 0, 3)(
        w.jcfg, jax_state(w.s1), jnp.asarray(batches[1, 0]), seg)
    same_state(ref, cons.consolidate_pages(w.cfg, port_state(w.s1),
                                           torch.from_numpy(batches[1, 0]), seg))
    ref = jit(jcons.consolidate_pages_ragged, 0)(
        w.jspec, jax_state(w.s1), jnp.asarray(batches[:, 0]))
    same_state(ref, cons.consolidate_pages_ragged(w.spec, port_state(w.s1),
                                                  torch.from_numpy(batches[:, 0])))
    ref = jit(jcons.consolidate_batches_ragged, 0)(
        w.jspec, jax_state(w.s1), jnp.asarray(batches))
    same_state(ref, cons.consolidate_batches_ragged(w.spec, port_state(w.s1),
                                                    torch.from_numpy(batches)))


def test_gpac_maintenance_ragged(w):
    same_state(jit(jgpac.gpac_maintenance_ragged, 0, 2, 3)(w.jspec, jax_state(w.s1), "ipt",
                                                            MAX_BATCHES),
               gpac.gpac_maintenance_ragged(w.spec, port_state(w.s1), "ipt", MAX_BATCHES))


# ---- tiering ---------------------------------------------------------------
def test_swap_blocks(w):
    bt = w.s0["block_table"]
    far = np.flatnonzero(bt >= w.cfg.n_near)[:5].astype(np.int32)
    near = np.flatnonzero(bt < w.cfg.n_near)[:5].astype(np.int32)
    far[1] = -1            # dropped: a -1 id
    near[2] = far[3]       # dropped: both ids in the far tier
    for k in (0, 3, 5):
        same_state(jit(jtier.swap_blocks, 0)(w.jcfg, jax_state(w.s0), jnp.asarray(far),
                                     jnp.asarray(near), k),
                   tiering.swap_blocks(w.cfg, port_state(w.s0), torch.from_numpy(far),
                                       torch.from_numpy(near), k))


def jax_tick(cfg, state, policy):
    return jtier.tick(cfg, state, policy, budget=BUDGET)


def test_policy_ticks(w):
    same(jtier._block_score(w.jcfg, jax_state(w.s1)),
         tiering._block_score(w.cfg, port_state(w.s1)))
    for policy in ("memtierd", "autonuma", "tpp"):
        same_state(jit(jax_tick, 0, 2)(w.jcfg, jax_state(w.s1), policy),
                   tiering.tick(w.cfg, port_state(w.s1), policy, budget=BUDGET))


def test_strided_tick_gate(w):
    st = port_state(w.s1)
    assert tiering.strided_tick(w.cfg, st, "memtierd", stride=3, budget=BUDGET, epoch=0) is st
    same_state(jit(jax_tick, 0, 2)(w.jcfg, jax_state(w.s1), "memtierd"),
               tiering.strided_tick(w.cfg, port_state(w.s1), "memtierd", stride=3,
                                    budget=BUDGET, epoch=2))


# ---- engine --------------------------------------------------------------
def test_step_matches_reference(w):
    """One window through the single-window entry point, collectors too."""
    acc = np.asarray(jengine.guest_traces(w.jspec, 4, 512)[:, 3])
    jst, jout = jengine.step(w.jspec, jax_state(w.s0), jnp.asarray(acc), budget=BUDGET)
    st, out = engine.step(w.spec, port_state(w.s0), torch.from_numpy(acc), budget=BUDGET)
    same_state(jst, st)
    assert set(jout) == set(out)
    for k in jout:
        same(jout[k], out[k], k)


# ---- metrics ---------------------------------------------------------------
def test_snapshot(w):
    assert jmetrics.snapshot(w.jcfg, jax_state(w.s1)) == metrics.snapshot(w.cfg, port_state(w.s1))
    ref = jmetrics.device_snapshot(w.jcfg, jax_state(w.s1))
    got = metrics.device_snapshot(w.cfg, port_state(w.s1))
    assert set(ref) == set(got)
    for k in ref:
        same(ref[k], got[k], k)
    nh, fh = np.array([[3.0, 0.0]]), np.array([[1.0, 0.0]])
    for a, b in zip(jmetrics.throughput_from_hits(nh, fh, "hbm_dram"),
                    metrics.throughput_from_hits(nh, fh, "hbm_dram")):
        same(a, b)
    assert metrics.TIER_LATENCY_NS == jmetrics.TIER_LATENCY_NS
    assert metrics.TIER_PAIRS == jmetrics.TIER_PAIRS
