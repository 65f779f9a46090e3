"""The port's N-tier hierarchies (``repro_torch.core.tiers``) against the JAX
reference, bit for bit, on the CPU.

The JAX package's own test geometry (``tests/test_tiers.py``): three ragged
guests of 96, 176 and 64 pages, ``hp_ratio`` 16, a DRAM / zram / NVMM
hierarchy from ``compressed_specs(0.2, 0.2, 3.0)`` (boundaries 0 / 4 / 16 /
30; a compression of 3.0 makes the zram tier's price inexact in float32),
each page holding a distinct payload. Both packages start from the same
state and replay the same accesses; states and every series, ``tco``
included, must be identical, dtypes included. The JAX runs are computed once
and shared.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import address_space as jasp  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import tiering as jtiering  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.serve import engine as jserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine, faults, tiering, tiers  # noqa: E402
from repro_torch.serve import engine as serve  # noqa: E402

GUESTS = (  # (n_logical, cl, gpa_slack, workload, seed)
    (96, 3, 0.5, "redis", 0),
    (176, 8, 0.25, "masim", 1),
    (64, None, 1.0, "hash", 2),
)
HOST = dict(hp_ratio=16, near_fraction=0.4, base_elems=2, cl=6)
SPECS = dict(near_fraction=0.2, mid_fraction=0.2, compression=3.0)
N_WINDOWS, APW = 6, 96  # at 96 accesses some windows' tco needs the engine's FMAs
POLICIES = ("memtierd", "autonuma", "tpp", "compressed", "hybridtier")
COLLECT = ("hits", "near_blocks", "tco")
P = bool(jax.config.jax_threefry_partitionable)


def same(a, b, what: str = "") -> None:
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


def jstate_np(state) -> dict:
    d = {f.name: np.asarray(getattr(state, f.name))
         for f in dataclasses.fields(state) if f.name != "stats"}
    d["stats"] = {k: np.asarray(v) for k, v in state.stats.items()}
    return d


def jstate(d: dict):
    from repro.core.types import TieredState as JState

    kw = {k: jnp.asarray(v) for k, v in d.items() if k != "stats"}
    kw["stats"] = {k: jnp.asarray(v) for k, v in d["stats"].items()}
    return JState(**kw)


def jchurn_np(cs) -> dict:
    d = {k: np.asarray(getattr(cs, k)) for k in interop.CHURN_FIELDS}
    d["state"] = jstate_np(cs.state)
    return d


def build_pair(specs=SPECS, host=HOST):
    """The JAX and the port's spec over the same guests and tiers (None:
    two tiers by ``near_fraction``), and the JAX-built starting state (a
    distinct payload per page) as numpy."""
    jg = [jengine.GuestSpec(n, cl=cl, gpa_slack=s, workload=w, seed=sd)
          for n, cl, s, w, sd in GUESTS]
    g = [engine.GuestSpec(n, cl=cl, gpa_slack=s, workload=w, seed=sd)
         for n, cl, s, w, sd in GUESTS]
    jt = t = None
    if specs is not None:
        jt, t = jtiers.compressed_specs(**specs), tiers.compressed_specs(**specs)
    jspec, st = jengine.build(jg, jengine.HostSpec(**host, tiers=jt))
    spec, _ = engine.build(g, engine.HostSpec(**host, tiers=t), device="cpu")
    cfg = jspec.cfg
    fill = (np.arange(cfg.n_logical * cfg.base_elems, dtype=np.float32)
            .reshape(cfg.n_logical, cfg.base_elems) + 0.5)
    st = jax.jit(jasp.write_logical, static_argnums=0)(
        cfg, st, np.arange(cfg.n_logical, dtype=np.int32), fill)
    return jspec, spec, jstate_np(st)


class _Ref:
    """JAX runs over the 3-tier fleet, computed once and shared."""

    def __init__(self):
        self.jspec, self.spec, self.s0 = build_pair()
        self.traces = jengine.guest_traces(self.jspec, N_WINDOWS, APW)
        self._runs = {}
        self.ticked = _ticked_state(self)

    def source(self, kind: str, port: bool):
        if kind == "array":
            return self.traces
        mod = engine if port else jengine
        kw = dict(partitionable=P) if port else {}
        return mod.SynthTrace(N_WINDOWS, APW, **kw)

    def jax(self, policy: str, kind: str):
        if (policy, kind) not in self._runs:
            st, series = jengine.run(self.jspec, jstate(self.s0), self.source(kind, False),
                                     policy=policy, collect=COLLECT, windows_per_step=3)
            self._runs[policy, kind] = jstate_np(st), series
        return self._runs[policy, kind]

    def port(self, policy: str, kind: str):
        st, series = engine.run(self.spec, interop.state_from_numpy(self.s0, device="cpu"),
                                self.source(kind, True), policy=policy, collect=COLLECT,
                                windows_per_step=3, device="cpu")
        return interop.state_to_numpy(st), series


@pytest.fixture(scope="module")
def ref():
    return _Ref()


def test_spec_validation_matches_reference():
    """TierSpec, TierVector, resolve and HostSpec(tiers=...) refuse the same
    inputs with the JAX package's messages; the sharded tick raises."""
    for kw in (dict(capacity=0.0), dict(capacity=1.5), dict(latency_ns=0.0),
               dict(bandwidth_gbps=-1.0), dict(compression=0.5), dict(cost_per_gb=-0.1)):
        args = dict(name="x", capacity=0.5, latency_ns=90.0) | kw
        with pytest.raises(ValueError) as je:
            jtiers.TierSpec(**args)
        with pytest.raises(ValueError) as pe:
            tiers.TierSpec(**args)
        assert str(pe.value) == str(je.value)
    one = (tiers.TierSpec("a", 0.5, 90.0),)
    jone = (jtiers.TierSpec("a", 0.5, 90.0),)
    for jv, v in (((jone, (0, 4)), (one, (0, 4))),
                  ((jone * 2, (0, 4)), (one * 2, (0, 4))),
                  ((jone * 2, (1, 4, 8)), (one * 2, (1, 4, 8))),
                  ((jone * 2, (0, 4, 4)), (one * 2, (0, 4, 4)))):
        with pytest.raises(ValueError) as je:
            jtiers.TierVector(*jv)
        with pytest.raises(ValueError) as pe:
            tiers.TierVector(*v)
        assert str(pe.value) == str(je.value)
    for jkw, kw in ((dict(tiers=jone * 2, n_near=4), dict(tiers=one * 2, n_near=4)),
                    (dict(tiers=jone), dict(tiers=one)),
                    (dict(tiers=("near", "far")), dict(tiers=("near", "far")))):
        with pytest.raises(ValueError) as je:
            jengine.HostSpec(**jkw)
        with pytest.raises(ValueError) as pe:
            engine.HostSpec(**kw)
        assert str(pe.value) == str(je.value)
    for n in (1, 2):
        with pytest.raises(ValueError) as je:
            jtiers.resolve(jone * 2, n, 10) if n == 1 else jtiers.resolve(jone, 8, 10)
        with pytest.raises(ValueError) as pe:
            tiers.resolve(one * 2, n, 10) if n == 1 else tiers.resolve(one, 8, 10)
        assert str(pe.value) == str(je.value)
    # the host-sharded compressed tick waits for the sharded engine
    for fn in (tiers._compressed_prepare, tiers.flow_outcome, tiers._compressed_apply):
        with pytest.raises(NotImplementedError, match="item 13"):
            fn(None, {}, 4)


def test_resolve_and_tier_of_slot(ref):
    for kw in (SPECS, dict(near_fraction=0.15, mid_fraction=0.25, compression=3.0),
               dict(near_fraction=0.5, mid_fraction=0.9, compression=4.0)):
        for n_slots, need in ((30, 21), (8000, 6400), (12, 12), (5, 100)):
            jv = jtiers.resolve(jtiers.compressed_specs(**kw), n_slots, need)
            v = tiers.resolve(tiers.compressed_specs(**kw), n_slots, need)
            assert v.boundaries == jv.boundaries and v.n_tiers == jv.n_tiers
            assert [dataclasses.asdict(s) for s in v.tiers] == \
                [dataclasses.asdict(s) for s in jv.tiers]
    assert ref.spec.tiers.boundaries == ref.jspec.tiers.boundaries == (0, 4, 16, 30)
    assert ref.spec.cfg.n_near == ref.jspec.cfg.n_near == 4
    assert tiers.two_tier(ref.spec.cfg).boundaries == jtiers.two_tier(ref.jspec.cfg).boundaries
    assert ref.spec.tier_vector == tiers.as_vector(ref.spec.cfg, ref.spec.tiers)
    slots = np.arange(-2, 34, dtype=np.int32)
    same(jtiers.tier_of_slot(ref.jspec.tiers, jnp.asarray(slots)),
         tiers.tier_of_slot(ref.spec.tiers, torch.from_numpy(slots)))
    assert ([tiers.amat_per_hit_ns(ref.spec.cfg, t) for t in ref.spec.tiers.tiers]
            == [jtiers.amat_per_hit_ns(ref.jspec.cfg, t) for t in ref.jspec.tiers.tiers])


def _ticked_state(ref):
    """The fleet after two memtierd windows, with a third window's accesses
    recorded (host counts set, no tick yet): the state every tick test
    starts from."""
    st, _ = jengine.run(ref.jspec, jstate(ref.s0), ref.traces[:, :2], policy="memtierd",
                        collect=())
    acc = jnp.asarray(ref.jspec.localize(jnp.asarray(ref.traces[:, 2])).reshape(-1))
    st = jax.jit(jasp.record_accesses, static_argnums=0)(ref.jspec.cfg, st, acc)
    return jstate_np(st)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_tick_on_three_tiers(ref, policy):
    s = ref.ticked
    jst = jax.jit(jtiering.tick, static_argnums=(0, 2), static_argnames=("tiers", "budget"))(
        ref.jspec.cfg, jstate(s), policy, tiers=ref.jspec.tiers, budget=4)
    st = tiering.tick(ref.spec.cfg, interop.state_from_numpy(s, device="cpu"), policy,
                      tiers=ref.spec.tiers, budget=4)
    same_tree(jstate_np(jst), interop.state_to_numpy(st))


def test_pressure_cascade_with_a_full_middle_tier(ref):
    """After memtierd's flows the zram tier holds only allocated blocks, so
    its cap (size - slack) engages every window; tier 0 under a shrunk cap
    (a tensor and a host int) and at its size (the no-sync skip)."""
    s = ref.ticked
    cfg, tv = ref.jspec.cfg, ref.jspec.tiers
    jst = jtiering.tick(cfg, jstate(s), "memtierd", tiers=tv)
    s = jstate_np(jst)
    alloc = np.asarray(jengine.allocated_hp_mask(cfg, jst))
    mid = (s["block_table"] >= 4) & (s["block_table"] < 16)
    assert (alloc & mid).sum() == 12  # full: usage 12 > cap 11
    jcascade = jax.jit(jtiers.pressure_cascade, static_argnums=(0, 2))
    for cap in (1, 4, torch.tensor(2, dtype=torch.int32)):
        jcap = jnp.int32(int(cap))
        press = 3
        jout = jcascade(cfg, jstate(s), tv, jcap, jnp.int32(press))
        out = tiering.pressure_tick(
            ref.spec.cfg, interop.state_from_numpy(s, device="cpu"), cap,
            torch.tensor(False), torch.tensor(press, dtype=torch.int32), tiers=ref.spec.tiers)
        same_tree(jstate_np(jout[0]), interop.state_to_numpy(out[0]), f"cap {cap} ")
        same(jout[1], out[1], "engaged")
        same(jout[2], out[2], "pressure")
        assert int(np.asarray(jout[0].stats["demoted_blocks"])) > int(s["stats"]["demoted_blocks"])


@pytest.mark.parametrize("policy", POLICIES)
def test_run_with_tco_matches_reference(ref, policy):
    """ArrayTrace and SynthTrace, the tco series (float32) included."""
    for kind in ("array", "synth"):
        jst, jser = ref.jax(policy, kind)
        st, ser = ref.port(policy, kind)
        same_tree(jst, st, f"{policy} {kind} ")
        same_tree(jser, ser, f"{policy} {kind} series.")


def test_tco_metrics_and_count_delta():
    """Called eagerly, tco_metrics rounds every product and sum, as eager
    JAX does; tier_count_delta's swap rounds."""
    jspec, spec, _ = build_pair()
    rng = np.random.default_rng(0)
    for _ in range(50):
        blocks = rng.integers(0, 3000, size=3).astype(np.int32)
        hits = rng.integers(0, 200000, size=3).astype(np.int32)
        jm = jtiers.tco_metrics(jspec.cfg, jspec.tiers, jnp.asarray(blocks), jnp.asarray(hits))
        m = tiers.tco_metrics(spec.cfg, spec.tiers, torch.from_numpy(blocks),
                              torch.from_numpy(hits))
        same_tree({k: np.asarray(v) for k, v in jm.items()}, m)
    swaps_np = [(dict(slot=rng.integers(0, 30, 6).astype(np.int32),
                      alloc=rng.integers(0, 2, 6).astype(np.int32)),
                 dict(slot=rng.integers(0, 30, 6).astype(np.int32),
                      alloc=rng.integers(0, 2, 6).astype(np.int32)),
                 rng.random(6) < 0.6) for _ in range(2)]

    def conv(f):
        return [tuple({k: f(v) for k, v in d.items()} if isinstance(d, dict) else f(d)
                      for d in sw) for sw in swaps_np]

    same(jtiers.tier_count_delta(jspec.tiers, conv(jnp.asarray)),
         tiers.tier_count_delta(spec.tiers, conv(torch.from_numpy)))


def test_run_churn_with_tiers_under_a_shrink():
    """The churn engine with tiers over a SynthTrace: a crash, a shrink of
    tier 0 at window 2 that drives the cascade, its grow-back, a restart."""
    jspec, spec, s0 = build_pair()
    fs = [("crash", 1, 2), ("shrink", 2, 1), ("shrink", 4, jspec.cfg.n_near),
          ("restart", 4, 2)]
    jsched, sched = jfaults.FaultSchedule(3), faults.FaultSchedule(3)
    for kind, *args in fs:
        getattr(jsched, kind)(*args)
        getattr(sched, kind)(*args)
    for policy in ("tpp", "hybridtier"):
        jcs, jser = jengine.run_churn(jspec, jengine.init_churn(jspec, jstate(s0)),
                                      jengine.SynthTrace(N_WINDOWS, APW), faults=jsched,
                                      policy=policy, collect=COLLECT, windows_per_step=2)
        cs, ser = engine.run_churn(
            spec, engine.init_churn(spec, interop.state_from_numpy(s0, device="cpu"),
                                    device="cpu"),
            engine.SynthTrace(N_WINDOWS, APW, partitionable=P), faults=sched, policy=policy,
            collect=COLLECT, windows_per_step=2, device="cpu")
        same_tree(jchurn_np(jcs), interop.churn_to_numpy(cs), f"{policy} ")
        same_tree(jser, ser, f"{policy} series.")
        assert jser["pressure"].max() >= 1


def test_tiering_service_with_tiers():
    """TieringService over the 3-tier fleet: four tenants (floors 0, 1, 2
    and one above the deepest tier) into three lanes, a departure, a
    shrink; stats() after every tick."""
    jspec, spec, _ = build_pair()
    jsvc = jserve.TieringService(jspec, accesses_per_window=96, policy="hybridtier")
    svc = serve.TieringService(spec, accesses_per_window=96, policy="hybridtier",
                               partitionable=P, device="cpu")
    for t, floor in enumerate((0, 1, 2, 5)):
        jsvc.submit(t, tier_floor=floor)
        svc.submit(t, tier_floor=floor)
    for tick in range(6):
        if tick == 2:
            jsvc.depart(1), svc.depart(1)
        if tick == 3:
            jsvc.set_near_cap(1), svc.set_near_cap(1)
        jout, out = jsvc.tick(), svc.tick()
        same_tree({k: np.asarray(v) for k, v in jout.items()}, out, f"tick {tick} ")
        assert svc.stats() == jsvc.stats(), tick
    assert {t["tier_floor"] for t in svc.stats()["tenants"].values()} == {0, 1, 2}


def test_two_tier_special_case():
    """A 2-tier TierSpec tuple that resolves to the no-tiers n_near builds
    the same host and equals the near/far run in run and run_churn, and
    both equal the reference's near/far run (its legacy 2-tier ticks)."""
    two = dict(hp_ratio=16, near_fraction=0.4, base_elems=2, cl=6)
    jspec0, spec0, s0 = build_pair(None, two)
    specs2 = (tiers.TierSpec("dram", 0.4, 90.0), tiers.TierSpec("nvmm", 1.0, 350.0))
    g = [engine.GuestSpec(n, cl=cl, gpa_slack=s, workload=w, seed=sd)
         for n, cl, s, w, sd in GUESTS]
    spec2, _ = engine.build(g, engine.HostSpec(hp_ratio=16, base_elems=2, cl=6,
                                               tiers=specs2), device="cpu")
    assert spec2.tiers.n_tiers == 2 and spec2.cfg == spec0.cfg
    traces = jengine.guest_traces(jspec0, 4, APW)
    fs = jfaults.no_faults(3).shrink(1, 3).crash(2, 1)
    pfs = faults.no_faults(3).shrink(1, 3).crash(2, 1)
    jst, jser = jengine.run(jspec0, jstate(s0), traces, policy="tpp")
    jcs, jcser = jengine.run_churn(jspec0, jengine.init_churn(jspec0, jstate(s0)), traces,
                                   faults=fs)
    for spec in (spec0, spec2):
        st, ser = engine.run(spec, interop.state_from_numpy(s0, device="cpu"), traces,
                             policy="tpp", device="cpu")
        same_tree(jstate_np(jst), interop.state_to_numpy(st))
        same_tree(jser, ser)
        cs, cser = engine.run_churn(
            spec, engine.init_churn(spec, interop.state_from_numpy(s0, device="cpu"),
                                    device="cpu"), traces, faults=pfs, device="cpu")
        same_tree(jchurn_np(jcs), interop.churn_to_numpy(cs))
        same_tree(jcser, cser)
