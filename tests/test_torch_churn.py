"""The PyTorch port's churn engine against the JAX reference, bit for bit.

Four ragged guests of a few hundred pages (``hp_ratio`` 16, n_near 26, not
a power of two), each page holding a distinct payload, replay the same numpy
traces in both packages. The port runs on the CPU, i.e. through the
kernels' plain PyTorch versions. Final ``ChurnState``s and every series
(``active``, ``near_cap`` and ``pressure`` included) must be identical,
dtypes included. The JAX runs are computed once per schedule and shared.
The JAX package is imported by a fixture, not at the top: the card test at
the end needs no JAX (``python -m pytest -m cuda tests/test_torch_churn.py``
on a machine with the card).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro_torch import interop  # noqa: E402
from repro_torch.core import engine, faults, tiering  # noqa: E402

GUESTS = (  # (n_logical, cl, gpa_slack, workload)
    (256, 4, 0.5, "redis"),
    (320, 8, 0.25, "masim"),
    (200, None, 1.0, "hash"),
    (288, 6, 0.25, "memcached"),
)
HOST = dict(hp_ratio=16, near_fraction=0.4, base_elems=2, cl=6)
N_WINDOWS = 12
APW = {"histogram": 256, "scatter": 64}  # run's telemetry branch at n_logical 1,064
RUN = dict(policy="memtierd", max_batches=3, budget=8, slack=1)


def every_fault_kind(n_near: int) -> list:
    """Crash, restart, a reboot, a crash of a lane already down, a restart of
    a live lane, a shrink and its grow-back, a dropout."""
    return [("crash", 3, 1), ("restart", 7, 1), ("crash", 5, 2), ("restart", 5, 2),
            ("crash", 4, 1), ("restart", 2, 0), ("shrink", 4, int(0.6 * n_near)),
            ("shrink", 8, n_near), ("dropout", 6)]


def schedule(mod, n_guests: int, events: list):
    sched = mod.FaultSchedule(n_guests)
    for kind, *args in events:
        getattr(sched, kind)(*args)
    return sched


def same(a, b, what: str) -> None:
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), what


def same_tree(ref: dict, got: dict, what: str = "") -> None:
    assert set(ref) == set(got), (what, sorted(ref), sorted(got))
    for k in ref:
        if isinstance(ref[k], dict):
            same_tree(ref[k], got[k], f"{what}{k}.")
        else:
            same(ref[k], got[k], what + k)


def jax_state_to_numpy(state) -> dict:
    d = {f.name: np.asarray(getattr(state, f.name))
         for f in dataclasses.fields(state) if f.name != "stats"}
    d["stats"] = {k: np.asarray(v) for k, v in state.stats.items()}
    return d


def jax_churn_to_numpy(cs) -> dict:
    d = {k: np.asarray(getattr(cs, k)) for k in interop.CHURN_FIELDS}
    d["state"] = jax_state_to_numpy(cs.state)
    return d


def jax_state(j, d: dict):
    kw = {k: j.jnp.asarray(v) for k, v in d.items() if k != "stats"}
    kw["stats"] = {k: j.jnp.asarray(v) for k, v in d["stats"].items()}
    return j.types.TieredState(**kw)


class Fleet:
    """Both packages' specs over one geometry, the filled starting state as
    numpy, the traces, and the JAX runs, each computed once."""

    def __init__(self, j):
        self.j = j
        jguests = [self.j.engine.GuestSpec(n, cl=cl, gpa_slack=sl, workload=w, seed=i)
                   for i, (n, cl, sl, w) in enumerate(GUESTS)]
        guests = [engine.GuestSpec(n, cl=cl, gpa_slack=sl, workload=w, seed=i)
                  for i, (n, cl, sl, w) in enumerate(GUESTS)]
        self.jspec, jst = self.j.engine.build(jguests, self.j.engine.HostSpec(**HOST))
        self.spec, _ = engine.build(guests, engine.HostSpec(**HOST), device="cpu")
        cfg = self.jspec.cfg
        self.n_near = cfg.n_near
        fill = (np.arange(cfg.n_logical * cfg.base_elems, dtype=np.float32)
                .reshape(cfg.n_logical, cfg.base_elems) + 0.5)
        jst = self.j.jax.jit(self.j.asp.write_logical, static_argnums=0)(
            cfg, jst, np.arange(cfg.n_logical, dtype=np.int32), fill)
        self.state0 = jax_state_to_numpy(jst)
        self.traces = {b: self.j.engine.guest_traces(self.jspec, N_WINDOWS, k)
                       for b, k in APW.items()}
        self._runs = {}

    def jax_churn(self, key, events=None, active=None, branch="histogram", **kw):
        """The reference's run_churn (``events`` a fault list, or a
        schedule), cached under ``key``."""
        if key not in self._runs:
            from torch_jax_core import jitted_service  # the JAX side only

            with jitted_service():  # tests/torch_jax_core.py: boot-time faults jitted
                cs = self.j.engine.init_churn(self.jspec, jax_state(self.j, self.state0),
                                              active=active)
            sched = (events if isinstance(events, self.j.faults.FaultSchedule) or events is None
                     else schedule(self.j.faults, len(GUESTS), events))
            cs, series = self.j.engine.run_churn(self.jspec, cs, self.traces[branch],
                                                 faults=sched, **RUN, **kw)
            self._runs[key] = (jax_churn_to_numpy(cs), series)
        return self._runs[key]

    def jax_run(self, branch):
        key = ("run", branch)
        if key not in self._runs:
            st, series = self.j.engine.run(
                self.jspec, jax_state(self.j, self.state0), self.traces[branch],
                **{k: v for k, v in RUN.items() if k != "slack"})
            self._runs[key] = (jax_state_to_numpy(st), series)
        return self._runs[key]

    def port_churn(self, events=None, active=None, branch="histogram", **kw):
        st = interop.state_from_numpy(self.state0, device="cpu")
        cs = engine.init_churn(self.spec, st, active=active, device="cpu")
        sched = (events if isinstance(events, faults.FaultSchedule) or events is None
                 else schedule(faults, len(GUESTS), events))
        cs, series = engine.run_churn(self.spec, cs, self.traces[branch], faults=sched,
                                      device="cpu", **RUN, **kw)
        return interop.churn_to_numpy(cs), series


@pytest.fixture(scope="module")
def j():
    """The JAX package's modules."""
    import jax
    import jax.numpy as jnp
    from repro.core import address_space, engine, faults, tiering
    from repro.core import types as jtypes

    return types.SimpleNamespace(jax=jax, jnp=jnp, asp=address_space, engine=engine,
                                 faults=faults, tiering=tiering, types=jtypes)


@pytest.fixture(scope="module")
def fleet(j):
    return Fleet(j)


def test_geometry(fleet):
    assert fleet.n_near == fleet.spec.cfg.n_near == 26  # not a power of two
    assert fleet.spec.hp_offsets == fleet.jspec.hp_offsets


def test_fault_tables_match_reference(fleet, j):
    """Every event kind, ranges that start mid-run and a seeded Poisson mix
    compile to the reference's dense rows."""
    events = every_fault_kind(fleet.n_near)
    sa, sb = schedule(j.faults, 4, events), schedule(faults, 4, events)
    assert sa.n_events == sb.n_events
    for n_w, start in ((12, 0), (5, 3), (4, 9), (0, 2)):
        ta, tb = sa.tables(n_w, fleet.n_near, start), sb.tables(n_w, fleet.n_near, start)
        assert ta.start == tb.start
        for f in ("crash", "restart", "near_cap", "drop"):
            same(getattr(ta, f), getattr(tb, f), f)
    pa = j.faults.poisson_churn(4, 40, 0.3, 0.1, seed=5, initially_active=[1, 0, 1, 1], start=2)
    pb = faults.poisson_churn(4, 40, 0.3, 0.1, seed=5, initially_active=[1, 0, 1, 1], start=2)
    assert (pa.crashes, pa.restarts) == (pb.crashes, pb.restarts) and pa.n_events > 4
    with pytest.raises(ValueError, match="out of range"):
        faults.FaultSchedule(4).crash(0, 4)


def test_every_fault_kind_matches_reference(fleet):
    """Crash, restart, reboot, shrink, grow-back and dropout: the final carry
    and every series bit for bit, with the crash reclaim complete in its own
    window."""
    events = every_fault_kind(fleet.n_near)
    ref_cs, ref_series = fleet.jax_churn("faults", events)
    cs, series = fleet.port_churn(events, windows_per_step=5)
    same_tree(ref_cs, cs)
    same_tree(ref_series, series)
    act = series["active"]
    assert not act[3:7, 1].any() and act[7:, 1].all() and act[:, 0].all()
    assert (series["near_blocks"][3:7, 1] == 0).all()
    assert series["pressure"][4] >= 1 and (series["pressure"][8:] == 0).all()
    assert series["near_cap"][4] < fleet.n_near == series["near_cap"][8]


def test_poisson_churn_matches_reference(fleet, j):
    sa = j.faults.poisson_churn(4, N_WINDOWS, 0.4, 0.15, seed=3)
    sb = faults.poisson_churn(4, N_WINDOWS, 0.4, 0.15, seed=3)
    assert len(sb.crashes) >= 2 and sb.restarts
    ref_cs, ref_series = fleet.jax_churn("poisson", sa)
    cs, series = fleet.port_churn(sb, windows_per_step=4)
    same_tree(ref_cs, cs)
    same_tree(ref_series, series)


@pytest.mark.parametrize("branch", ["histogram", "scatter"])
def test_no_fault_churn_equals_run(fleet, branch):
    """INV-CHURN-NOOP-EXACT on both of run's telemetry branches: the churn
    window always takes the histogram path."""
    ref_state, ref_series = fleet.jax_run(branch)
    cs, series = fleet.port_churn(None, branch=branch, windows_per_step=4)
    st = interop.state_from_numpy(fleet.state0, device="cpu")
    st, run_series = engine.run(fleet.spec, st, fleet.traces[branch], device="cpu",
                                **{k: v for k, v in RUN.items() if k != "slack"})
    same_tree(interop.state_to_numpy(st), cs["state"])
    same_tree(ref_state, cs["state"])
    same_tree(run_series, {k: v for k, v in series.items() if k not in engine._CHURN_SERIES})
    same_tree(ref_series, run_series)
    assert series["active"].all() and (series["near_cap"] == fleet.n_near).all()
    assert not series["pressure"].any()


def test_chunking_and_split_calls_are_invariant(fleet, j):
    """windows_per_step 1 against one chunk, two driver calls against one
    (the second call's schedule resumes at the carried window), and a
    no-fault second call, which keeps the shrunk capacity it carries."""
    events = every_fault_kind(fleet.n_near)
    ref_cs, ref_series = fleet.jax_churn("faults", events)
    for wps in (1, 0):
        cs, series = fleet.port_churn(events, windows_per_step=wps)
        same_tree(ref_cs, cs)
        same_tree(ref_series, series)
    sched = schedule(faults, 4, events)
    cs = engine.init_churn(fleet.spec, interop.state_from_numpy(fleet.state0, device="cpu"),
                           device="cpu")
    tr = fleet.traces["histogram"]
    cs, first = engine.run_churn(fleet.spec, cs, tr[:, :5], faults=sched, device="cpu", **RUN)
    cs, second = engine.run_churn(fleet.spec, cs, tr[:, 5:], faults=sched, device="cpu", **RUN)
    same_tree(ref_cs, interop.churn_to_numpy(cs))
    same_tree(ref_series, {k: np.concatenate([first[k], second[k]]) for k in first})

    jcs = j.engine.init_churn(fleet.jspec, jax_state(j, fleet.state0))
    jcs, _ = j.engine.run_churn(fleet.jspec, jcs, tr[:, :6], faults=schedule(j.faults, 4, events),
                                **RUN)
    jcs, jsecond = j.engine.run_churn(fleet.jspec, jcs, tr[:, 6:], **RUN)
    cs = engine.init_churn(fleet.spec, interop.state_from_numpy(fleet.state0, device="cpu"),
                           device="cpu")
    cs, _ = engine.run_churn(fleet.spec, cs, tr[:, :6], faults=sched, device="cpu", **RUN)
    cs, second = engine.run_churn(fleet.spec, cs, tr[:, 6:], device="cpu", **RUN)
    same_tree(jax_churn_to_numpy(jcs), interop.churn_to_numpy(cs))
    same_tree(jsecond, second)
    assert (second["near_cap"] == int(0.6 * fleet.n_near)).all()


def test_step_churn_loop_equals_one_run(fleet):
    """A step loop with each window's fault row, through engine.step's
    dispatch on a ChurnState, equals one run_churn call."""
    events = every_fault_kind(fleet.n_near)
    ref_cs, ref_series = fleet.jax_churn("faults", events)
    ft = schedule(faults, 4, events).tables(N_WINDOWS, fleet.n_near)
    cs = engine.init_churn(fleet.spec, interop.state_from_numpy(fleet.state0, device="cpu"),
                           device="cpu")
    tr = torch.from_numpy(fleet.traces["histogram"])
    steps = []
    for w in range(N_WINDOWS):
        row = dict(crash=ft.crash[w], restart=ft.restart[w], near_cap=int(ft.near_cap[w]),
                   drop=bool(ft.drop[w]))
        cs, out = engine.step(fleet.spec, cs, tr[:, w], faults_row=row,
                              policy=RUN["policy"], max_batches=RUN["max_batches"],
                              budget=RUN["budget"], slack=RUN["slack"])
        steps.append(out)
    same_tree(ref_cs, interop.churn_to_numpy(cs))
    same_tree(ref_series, {k: np.stack([o[k] for o in steps]) for k in steps[0]})
    st = interop.state_from_numpy(fleet.state0, device="cpu")
    with pytest.raises(TypeError, match="ChurnState"):
        engine.step(fleet.spec, st, tr[:, 0], faults_row={})
    with pytest.raises(ValueError, match="unknown faults_row keys"):
        engine.step_churn(fleet.spec, cs, tr[:, 0], faults_row={"shrink": 3})


def test_lanes_inactive_at_boot_match_reference(fleet, j):
    """init_churn reclaims lanes marked inactive (their payload wiped), and a
    later restart boots them with a fresh identity mapping."""
    active = np.array([True, False, True, False])
    from torch_jax_core import jitted_service  # the JAX side only

    with jitted_service():  # tests/torch_jax_core.py
        jcs = j.engine.init_churn(fleet.jspec, jax_state(j, fleet.state0), active=active)
    cs = engine.init_churn(fleet.spec, interop.state_from_numpy(fleet.state0, device="cpu"),
                           active=active, device="cpu")
    same_tree(jax_churn_to_numpy(jcs), interop.churn_to_numpy(cs))
    assert not interop.churn_to_numpy(cs)["state"]["far_pool"].all()  # wiped rows
    events = [("restart", 2, 1), ("restart", 6, 3), ("crash", 9, 0)]
    ref_cs, ref_series = fleet.jax_churn("boot", events, active=active)
    got_cs, series = fleet.port_churn(events, active=active, windows_per_step=6)
    same_tree(ref_cs, got_cs)
    same_tree(ref_series, series)
    back = interop.churn_to_numpy(interop.churn_from_numpy(got_cs, device="cpu"))
    same_tree(got_cs, back)


def test_pressure_tick_shrink_and_grow_back(fleet, j):
    """The controller alone, from a state whose near tier is full: a shrink
    engages it (demotions within the budget, pressure counting up), the
    grow-back disengages it; a capacity tensor and a host int agree."""
    ref_state, _ = fleet.jax_run("histogram")
    cfg, jcfg = fleet.spec.cfg, fleet.jspec.cfg
    jst = jax_state(j, ref_state)
    jeng, jpress = j.jnp.zeros((), bool), j.jnp.zeros((), j.jnp.int32)
    tick = j.jax.jit(j.tiering.pressure_tick, static_argnums=0,
                   static_argnames=("budget", "slack"))
    st_int = interop.state_from_numpy(ref_state, device="cpu")
    st_t = interop.state_from_numpy(ref_state, device="cpu")
    eng_i = eng_t = torch.zeros((), dtype=torch.bool)
    press_i = press_t = torch.zeros((), dtype=torch.int32)
    caps = [12, 12, 12, 3, 3, cfg.n_near, cfg.n_near + 5]  # the run leaves 17 blocks near
    engaged_seen = []
    for cap in caps:
        jst, jeng, jpress = tick(jcfg, jst, j.jnp.int32(min(cap, jcfg.n_near)), jeng, jpress,
                                 budget=4, slack=2)
        st_int, eng_i, press_i = tiering.pressure_tick(
            cfg, st_int, min(cap, cfg.n_near), eng_i, press_i, budget=4, slack=2)
        st_t, eng_t, press_t = tiering.pressure_tick(
            cfg, st_t, torch.tensor(min(cap, cfg.n_near), dtype=torch.int32), eng_t, press_t,
            budget=4, slack=2)
        for got in ((st_int, eng_i, press_i), (st_t, eng_t, press_t)):
            same_tree(jax_state_to_numpy(jst), interop.state_to_numpy(got[0]))
            same(jeng, got[1], "engaged")
            same(jpress, got[2], "pressure")
        engaged_seen.append(bool(jeng))
    assert engaged_seen == [True, True, False, True, True, False, False]
    assert int(jst.stats["demoted_blocks"]) > ref_state["stats"]["demoted_blocks"]


def test_unported_paths_raise(fleet, j):
    cs = engine.init_churn(fleet.spec, device="cpu")
    tr = fleet.traces["histogram"]
    with pytest.raises(TypeError, match="expected a TraceSource"):  # the JAX package's
        engine.run_churn(fleet.spec, cs, j.engine.SynthTrace(4, 16), device="cpu")
    # a mesh whose rank runs on another device than the carry is refused
    from repro_torch.core import sharding

    other = sharding.GuestMesh(None, 0, 1, torch.device("meta"), "gloo")
    with pytest.raises(ValueError, match="the mesh's rank runs on meta"):
        engine.run_churn(fleet.spec, cs, tr, mesh=other, device="cpu")
    # an N-tier vector makes the controller the reference's per-tier cascade
    from repro.core import tiers as jtiers
    from repro_torch.core import tiers

    cfg = fleet.spec.cfg
    jtv = jtiers.resolve(jtiers.compressed_specs(0.1, 0.1, 2.0), cfg.n_slots, cfg.n_gpa_hp)
    tv = tiers.resolve(tiers.compressed_specs(0.1, 0.1, 2.0), cfg.n_slots, cfg.n_gpa_hp)
    jout = j.tiering.pressure_tick(fleet.jspec.cfg, jax_state(j, fleet.state0), 3,
                                   j.jnp.zeros((), bool), j.jnp.zeros((), j.jnp.int32),
                                   tiers=jtv)
    out = tiering.pressure_tick(cfg, interop.state_from_numpy(fleet.state0, device="cpu"), 3,
                                cs.engaged, cs.pressure, tiers=tv)
    same_tree(jax_state_to_numpy(jout[0]), interop.state_to_numpy(out[0]))
    same(jout[1], out[1], "engaged")
    same(jout[2], out[2], "pressure")
    with pytest.raises(TypeError, match="ChurnState"):
        engine.run_churn(fleet.spec, cs.state, tr, device="cpu")
    with pytest.raises(ValueError, match="fault tables cover"):
        engine.run_churn(fleet.spec, cs, tr, device="cpu",
                         faults=faults.no_faults(4).tables(N_WINDOWS, 26, start=1))


@pytest.mark.cuda
def test_churn_kernels_match_plain_on_card():
    """On the card: a tiny faulted run_churn through the kernels equals the
    plain run bit for bit, with K1-K4 launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import registry

    guests = [engine.GuestSpec(n, cl=cl, gpa_slack=sl, workload=w, seed=i)
              for i, (n, cl, sl, w) in enumerate(GUESTS)]
    spec, _ = engine.build(guests, engine.HostSpec(**HOST), device="cuda")
    tr = engine.guest_traces(spec, N_WINDOWS, APW["histogram"])
    sched = schedule(faults, 4, every_fault_kind(spec.cfg.n_near))
    runs = {}
    for backend in ("auto", "torch"):
        registry.reset_launch_counts()
        cs = engine.init_churn(spec)
        cs, series = engine.run_churn(spec, cs, tr, faults=sched, kernel_backend=backend, **RUN)
        runs[backend] = (interop.churn_to_numpy(cs), series, registry.launch_counts())
    same_tree(runs["torch"][0], runs["auto"][0])
    same_tree(runs["torch"][1], runs["auto"][1])
    for name in ("bincount", "hot_count", "topk_rows", "gather_rows"):
        assert runs["auto"][2][name] > 0 and runs["torch"][2][name] == 0, name
