"""The PyTorch port's reference drivers, deprecated shims and figure
metrics against the JAX package, bit for bit.

The same numpy states and traces go through both packages; the port runs on
the CPU, i.e. through the kernels' plain PyTorch versions. ``run_windows``
goes through the engine's jitted collector and ``run_windows_reference``
through eager ``metrics.snapshot``: at n_near 41 the two round
``near_capacity_used`` differently in the reference, and the port must
reproduce each one as it is.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import consolidator as jcons  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import filter as jfilter  # noqa: E402
from repro.core import gpac as jgpac  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core import telemetry as jtel  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.data import traces as jtraces  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import consolidator as cons  # noqa: E402
from repro_torch.core import engine, gpac, metrics, simulate, telemetry, types  # noqa: E402
from repro_torch.core import filter as pfilter  # noqa: E402

RAGGED = (  # (n_logical, cl, gpa_slack, workload)
    (300, 4, 0.25, "redis"),
    (200, None, 0.5, "hash"),
    (260, 8, 0.25, "ocean_ncp"),
)
HOST = dict(hp_ratio=16, near_fraction=0.3, base_elems=2, cl=6)  # n_near 14
N_WINDOWS, APW = 6, 128
# one guest whose near tier fills: n_near 41 rounds alike in neither package
SINGLE = dict(n_logical=1000, hp_ratio=16, n_gpa_hp=80, n_near=41, base_elems=2, cl=6)
MG = dict(n_guests=3, logical_per_guest=256, hp_ratio=16, near_fraction=0.3,
          base_elems=2, cl=6)


def same(a, b, what: str = "") -> None:
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), what


def same_tree(ref, got, what: str = "") -> None:
    if isinstance(ref, (list, tuple)):
        assert len(ref) == len(got), what
        for i, (r, g) in enumerate(zip(ref, got)):
            same_tree(r, g, f"{what}[{i}]")
    elif isinstance(ref, dict):
        assert set(ref) == set(got), (what, sorted(ref), sorted(got))
        for k in ref:
            same_tree(ref[k], got[k], f"{what}.{k}")
    elif isinstance(ref, float):  # a snapshot's Python float: same double bits
        assert type(got) is float and np.float64(ref).tobytes() == np.float64(got).tobytes(), what
    elif isinstance(ref, int):
        assert type(got) is int and ref == got, what
    else:
        same(ref, got, what)


def np_state(state) -> dict:
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


def port_state(d: dict):
    return interop.state_from_numpy(d, device="cpu")


@pytest.fixture(scope="module")
def ragged():
    """Both specs, a starting state three windows in (histories, touch
    epochs and consolidated regions populated), and the traces."""
    jspec, jst = jengine.build(
        [jengine.GuestSpec(n, cl=cl, gpa_slack=sl, workload=w, seed=i)
         for i, (n, cl, sl, w) in enumerate(RAGGED)], jengine.HostSpec(**HOST))
    spec, _ = engine.build(
        [engine.GuestSpec(n, cl=cl, gpa_slack=sl, workload=w, seed=i)
         for i, (n, cl, sl, w) in enumerate(RAGGED)], engine.HostSpec(**HOST), device="cpu")
    traces = jengine.guest_traces(jspec, N_WINDOWS + 3, APW)
    jst, _ = jengine.run(jspec, jst, traces[:, :3], policy="tpp", budget=4)
    return dict(jspec=jspec, spec=spec, state0=np_state(jst), traces=traces[:, 3:])


@pytest.fixture(scope="module")
def single():
    cfg_j, cfg = jtypes.GpacConfig(**SINGLE), types.GpacConfig(**SINGLE)
    trace = jtraces.generate(jtraces.TraceSpec(
        "masim", n_logical=SINGLE["n_logical"], hp_ratio=SINGLE["hp_ratio"],
        n_windows=N_WINDOWS, accesses_per_window=2048, seed=0))
    return cfg_j, cfg, np_state(jtypes.init_state(cfg_j)), trace


@pytest.mark.parametrize("policy", ["memtierd", "autonuma", "tpp"])
def test_run_reference_matches_reference(ragged, policy):
    """The sequential per-guest oracle, window by window, against the JAX
    one, and against the port's batched engine."""
    kw = dict(policy=policy, max_batches=3, budget=6)
    jst, jseries = jengine.run_reference(ragged["jspec"], jax_state(ragged["state0"]),
                                         ragged["traces"], **kw)
    st, series = engine.run_reference(ragged["spec"], port_state(ragged["state0"]),
                                      ragged["traces"], device="cpu", **kw)
    same_tree(np_state(jst), np_state(st))
    same_tree(jseries, series)
    st2, run_series = engine.run(ragged["spec"], port_state(ragged["state0"]),
                                 ragged["traces"], device="cpu", **kw)
    same_tree(np_state(st), np_state(st2))
    same_tree(series, run_series)


def test_run_windows_round_as_their_reference(single):
    """run_windows rounds near_capacity_used as the jitted engine does,
    run_windows_reference as eager JAX does; at n_near 41 the two differ in
    every window, in both packages alike."""
    cfg_j, cfg, state0, trace = single
    kw = dict(budget=8, max_batches=3)
    with pytest.warns(DeprecationWarning):
        jst, jser = jgpac.run_windows(cfg_j, jax_state(state0), trace, windows_per_step=3, **kw)
    with pytest.warns(DeprecationWarning):
        st, ser = gpac.run_windows(cfg, port_state(state0), trace, windows_per_step=3,
                                   device="cpu", **kw)
    same_tree(np_state(jst), np_state(st))
    same_tree(jser, ser)
    jst_r, jser_r = jgpac.run_windows_reference(cfg_j, jax_state(state0), trace, **kw)
    st_r, ser_r = gpac.run_windows_reference(cfg, port_state(state0), trace, device="cpu", **kw)
    same_tree(np_state(jst_r), np_state(st_r))
    same_tree(jser_r, ser_r)
    assert all(a["near_capacity_used"] != b["near_capacity_used"] for a, b in zip(ser, ser_r))
    same_tree(np_state(st), np_state(st_r))
    with pytest.warns(DeprecationWarning):
        assert gpac.run_windows(cfg, port_state(state0), trace[:0], device="cpu")[1] == []


def test_window_step_and_batched_maintenance(ragged, single):
    cfg_j, cfg, state0, trace = single
    step = jax.jit(jgpac.window_step, static_argnums=0, static_argnames=("policy", "budget"))
    jst = step(cfg_j, jax_state(state0), trace[0], policy="autonuma", budget=5)
    st = gpac.window_step(cfg, port_state(state0), torch.from_numpy(trace[0]),
                          policy="autonuma", budget=5)
    same_tree(np_state(jst), np_state(st))
    # two symmetric guests over the single config's space, after one window
    jst = jgpac.gpac_maintenance_batched(cfg_j, jst, "ipt", 3, 4, 2, 500, 40)
    st = gpac.gpac_maintenance_batched(cfg, st, "ipt", 3, 4, 2, 500, 40)
    same_tree(np_state(jst), np_state(st))
    assert int(st.stats["consolidated_pages"]) > 0
    with pytest.raises(ValueError, match="tile"):
        gpac.gpac_maintenance_batched(cfg, st, "ipt", 3, 4, 3, 333, 26)


@pytest.fixture(scope="module")
def multi():
    """Both packages' symmetric fleets and a numpy trace with -1 padding."""
    with pytest.warns(DeprecationWarning):
        jmg, jst = jsim.make_multi_guest(**MG)
    with pytest.warns(DeprecationWarning):
        mg, st = simulate.make_multi_guest(**MG, device="cpu")
    rng = np.random.default_rng(0)
    traces = rng.integers(-1, MG["logical_per_guest"], size=(3, N_WINDOWS, 200)).astype(np.int32)
    traces[:, :, :64] = rng.integers(0, 48, size=(3, N_WINDOWS, 64))  # a hot set
    return jmg, jst, mg, st, traces


def test_multi_guest_reference_and_shims(multi):
    jmg, jst0, mg, st0, traces = multi
    assert (mg.n_guests, mg.logical_per_guest, mg.hp_per_guest) == (
        jmg.n_guests, jmg.logical_per_guest, jmg.hp_per_guest)
    same_tree(np_state(jst0), np_state(st0))
    state0 = np_state(st0)
    kw = dict(policy="memtierd", max_batches=2, budget=6, cl=5)
    jst, jser = jsim.run_multi_guest_reference(jmg, jax_state(state0), traces, **kw)
    st, ser = simulate.run_multi_guest_reference(mg, port_state(state0), traces,
                                                 device="cpu", **kw)
    same_tree(np_state(jst), np_state(st))
    same_tree(jser, ser)
    with pytest.warns(DeprecationWarning):
        jst2, jser2 = jsim.run_multi_guest(jmg, jax_state(state0), traces, **kw)
    with pytest.warns(DeprecationWarning):
        st2, ser2 = simulate.run_multi_guest(mg, port_state(state0), traces,
                                             windows_per_step=2, device="cpu", **kw)
    same_tree(np_state(jst2), np_state(st2))
    same_tree(jser2, ser2)
    same_tree(ser, ser2)
    acc = traces[:, 0]
    with pytest.warns(DeprecationWarning):
        jst3, jout = jsim.multi_guest_window(jmg, jax_state(state0), acc, **kw)
    with pytest.warns(DeprecationWarning):
        st3, out = simulate.multi_guest_window(mg, port_state(state0), torch.from_numpy(acc), **kw)
    same_tree(np_state(jst3), np_state(st3))
    same_tree(jout, out)
    st4, out4 = simulate.multi_guest_window_reference(mg, port_state(state0),
                                                      torch.from_numpy(acc), **kw)
    same_tree(np_state(st3), np_state(st4))
    same_tree(out, out4)
    same(jmg.localize_all(acc), mg.localize_all(torch.from_numpy(acc)))


def test_select_batches_per_guest_and_multi_consolidation(multi):
    """The deprecated symmetric filter and both ``*_multi`` consolidations,
    from the fresh fleet with every fifth page accessed this window (three
    hot subpages per huge page, under the CL of 5)."""
    jmg, _, mg, st0, _ = multi
    counts = np.zeros(mg.cfg.n_logical, np.int32)
    counts[::5] = np.random.default_rng(2).integers(1, 9, counts[::5].shape)
    state1 = dict(np_state(st0), guest_counts=counts)
    jst, st = jax_state(state1), port_state(state1)
    jhot, hot = jtel.hot_mask(jmg.cfg, jst, "ipt"), telemetry.hot_mask(mg.cfg, st, "ipt")
    same(jhot, hot, "hot")
    jb = jfilter.select_batches_per_guest(jmg.cfg, jst, jhot, 3, 5, 3, MG["logical_per_guest"])
    b = pfilter.select_batches_per_guest(mg.cfg, st, hot, 3, 5, 3, MG["logical_per_guest"])
    same(jb, b, "batches")
    assert (b >= 0).sum() > 0
    with pytest.raises(ValueError, match="tile"):
        pfilter.select_batches_per_guest(mg.cfg, st, hot, 3, 5, 2, 100)
    hpg = mg.hp_per_guest
    jst1 = jcons.consolidate_pages_multi(jmg.cfg, jst, jb[:, 0], hpg)
    st1 = cons.consolidate_pages_multi(mg.cfg, st, b[:, 0].clone(), hpg)
    same_tree(np_state(jst1), np_state(st1))
    jst2 = jcons.consolidate_batches_multi(jmg.cfg, jst1, jb, hpg)
    st2 = cons.consolidate_batches_multi(mg.cfg, st1, b, hpg)
    same_tree(np_state(jst2), np_state(st2))
    assert int(st2.stats["consolidated_pages"]) > 0
    with pytest.raises(ValueError, match="tile"):
        cons.consolidate_batches_multi(mg.cfg, st2, b, hpg + 1)


def test_figure_metrics(ragged):
    """skew_cdf and skewed_hot_fraction on numpy counts (empty ones too);
    the modeled access time and throughput, float32, on a run's stats and
    on hand-set counts, for every tier pair."""
    rng = np.random.default_rng(1)
    for counts in (rng.integers(0, 17, 300), np.zeros(40, np.int64)):
        same(jmetrics.skew_cdf(counts, 16), metrics.skew_cdf(counts, 16), "skew_cdf")
        for cl in (1, 6, 17):
            a = jmetrics.skewed_hot_fraction(counts, cl)
            b = metrics.skewed_hot_fraction(counts, cl)
            assert type(a) is type(b) and a == b
    states = [ragged["state0"]]
    for h, f in ((0, 0), (7, 3), (123_457, 98_765), (2**31 - 9, 3)):
        d = dict(ragged["state0"], stats=dict(ragged["state0"]["stats"]))
        d["stats"]["near_hits"], d["stats"]["far_hits"] = np.int32(h), np.int32(f)
        states.append(d)
    for d in states:
        jst, st = jax_state(d), port_state(d)
        for pair in metrics.TIER_PAIRS:
            same(jmetrics.modeled_access_time_ns(jst, pair),
                 metrics.modeled_access_time_ns(st, pair), pair)
            same(jmetrics.modeled_throughput(jst, pair), metrics.modeled_throughput(st, pair), pair)
        same(jmetrics.modeled_throughput(jst, "dram_cxl", 512.5, 2.25, 37.125),
             metrics.modeled_throughput(st, "dram_cxl", 512.5, 2.25, 37.125), "custom")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        same_tree(jmetrics.snapshot(ragged["jspec"].cfg, jax_state(ragged["state0"])),
                  metrics.snapshot(ragged["spec"].cfg, port_state(ragged["state0"])))
