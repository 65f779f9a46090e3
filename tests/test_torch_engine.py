"""The PyTorch port's engine against the JAX reference, bit for bit.

Both packages start from the same state (built by the JAX package, handed
over as numpy arrays) and replay the same numpy traces; the port runs on the
CPU, i.e. through the kernels' plain PyTorch versions. Final states and every
series must be identical, dtypes included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.core import address_space as jasp  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine, types  # noqa: E402

# the bench geometry (benchmarks/bench_engine.py): redis, 2 x 1,024 pages
HOST = dict(hp_ratio=32, near_fraction=0.25, base_elems=2, cl=8)
N_WINDOWS, APW = 12, 2048
POLICIES = ("memtierd", "autonuma", "tpp")


def jax_state_to_numpy(state) -> dict:
    d = {f.name: np.asarray(getattr(state, f.name))
         for f in dataclasses.fields(state) if f.name != "stats"}
    d["stats"] = {k: np.asarray(v) for k, v in state.stats.items()}
    return d


def assert_same_arrays(a: np.ndarray, b: np.ndarray, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), what


def assert_same_state(ref: dict, got: dict) -> None:
    assert set(ref) == set(got)
    for k in ref:
        if k == "stats":
            assert set(ref[k]) == set(got[k])
            for s in ref[k]:
                assert_same_arrays(ref[k][s], got[k][s], f"stats.{s}")
        else:
            assert_same_arrays(ref[k], got[k], k)


def assert_same_series(ref: dict, got: dict) -> None:
    assert set(ref) == set(got)
    for k in ref:
        assert_same_arrays(ref[k], got[k], f"series.{k}")


def _setup(guests):
    """JAX spec, the starting state as numpy (a distinct payload per page)
    and the packed traces."""
    spec, state = jengine.build(guests, jengine.HostSpec(**HOST))
    cfg = spec.cfg
    fill = (np.arange(cfg.n_logical * cfg.base_elems, dtype=np.float32)
            .reshape(cfg.n_logical, cfg.base_elems) + 0.5)
    # jitted: eager JAX dispatches the scatter op by op, which takes seconds
    state = jax.jit(jasp.write_logical, static_argnums=0)(
        cfg, state, np.arange(cfg.n_logical, dtype=np.int32), fill)
    traces = jengine.guest_traces(spec, N_WINDOWS, APW)
    return spec, jax_state_to_numpy(state), traces


def _port_spec(jspec, host=HOST):
    guests = [engine.GuestSpec(g.n_logical, cl=g.cl, gpa_slack=g.gpa_slack,
                               workload=g.workload, seed=g.seed)
              for g in jspec.guests]
    spec, _ = engine.build(guests, engine.HostSpec(**host), device="cpu")
    return spec


BENCH_GUESTS = [jengine.GuestSpec(1024, seed=g) for g in range(2)]
RAGGED_GUESTS = [
    # a hash guest with no GPA slack runs out of free regions (-ENOMEM)
    jengine.GuestSpec(700, cl=16, gpa_slack=0.0, workload="hash", seed=0),
    jengine.GuestSpec(1024, seed=1),
    jengine.GuestSpec(1500, cl=16, gpa_slack=0.5, seed=2),
]


class _Ref:
    """JAX runs, computed once per configuration and shared by the tests."""

    def __init__(self, guests):
        self.jspec, self.state0, self.traces = _setup(guests)
        self.spec = _port_spec(self.jspec)
        self._runs = {}

    def jax(self, **kw):
        key = tuple(sorted(kw.items()))
        if key not in self._runs:
            st, series = jengine.run(
                self.jspec, interop_jax_state(self.state0), self.traces, **kw)
            self._runs[key] = (jax_state_to_numpy(st), series)
        return self._runs[key]

    def port(self, **kw):
        st = interop.state_from_numpy(self.state0, device="cpu")
        st, series = engine.run(self.spec, st, self.traces, device="cpu", **kw)
        return interop.state_to_numpy(st), series


def interop_jax_state(d: dict):
    """A JAX TieredState from the numpy dict (fresh device arrays)."""
    import jax.numpy as jnp
    from repro.core.types import TieredState as JState

    kw = {k: jnp.asarray(v) for k, v in d.items() if k != "stats"}
    kw["stats"] = {k: jnp.asarray(v) for k, v in d["stats"].items()}
    return JState(**kw)


@pytest.fixture(scope="module")
def bench():
    return _Ref(BENCH_GUESTS)


@pytest.fixture(scope="module")
def ragged():
    return _Ref(RAGGED_GUESTS)


def test_spec_and_initial_state_match(bench, ragged):
    for ref in (bench, ragged):
        assert ref.spec.logical_offsets == ref.jspec.logical_offsets
        assert ref.spec.hp_offsets == ref.jspec.hp_offsets
        jcfg, cfg = ref.jspec.cfg, ref.spec.cfg
        for f in ("n_logical", "hp_ratio", "n_gpa_hp", "n_near", "cl", "base_elems"):
            assert getattr(jcfg, f) == getattr(cfg, f), f
        _, jstate = jengine.build(list(ref.jspec.guests), jengine.HostSpec(**HOST))
        port_state = engine.init_engine_state(ref.spec, device="cpu")
        assert_same_state(jax_state_to_numpy(jstate), interop.state_to_numpy(port_state))


@pytest.mark.parametrize("use_gpac", [True, False])
@pytest.mark.parametrize("policy", POLICIES)
def test_run_matches_reference(bench, policy, use_gpac):
    """Every chunking of the port's run (one chunk, 4 windows, and 5, which
    rounds to 4 over 12 windows) against the reference's one run."""
    ref_state, ref_series = bench.jax(policy=policy, use_gpac=use_gpac)
    for wps in (0, 4, 5):
        state, series = bench.port(policy=policy, use_gpac=use_gpac,
                                   windows_per_step=wps)
        assert_same_state(ref_state, state)
        assert_same_series(ref_series, series)


def test_ragged_guests_match_reference(ragged):
    """Distinct sizes, CLs, slacks and workloads; one guest hits -ENOMEM."""
    ref_state, ref_series = ragged.jax(policy="tpp")
    assert ref_state["stats"]["consolidation_enomem"] > 0
    state, series = ragged.port(policy="tpp", windows_per_step=4)
    assert_same_state(ref_state, state)
    assert_same_series(ref_series, series)


def test_snapshot_collector_and_stride_match_reference(bench):
    """The snapshot collector's series, with the host tick every 3rd window."""
    ref_state, ref_series = bench.jax(collect=("snapshot",), arbitration_stride=3)
    state, series = bench.port(collect=("snapshot",), arbitration_stride=3,
                               windows_per_step=5)
    assert series["near_usage"].dtype == np.float32
    assert_same_state(ref_state, state)
    assert_same_series(ref_series, series)


def test_run_series_matches_reference(bench):
    jst, jout = jengine.run_series(
        bench.jspec, interop_jax_state(bench.state0), bench.traces,
        policy="autonuma")
    st = interop.state_from_numpy(bench.state0, device="cpu")
    st, out = engine.run_series(bench.spec, st, bench.traces, device="cpu",
                                policy="autonuma", windows_per_step=4)
    assert_same_state(jax_state_to_numpy(jst), interop.state_to_numpy(st))
    assert_same_series(jout, out)


def test_interop_round_trip(bench):
    back = interop.state_to_numpy(interop.state_from_numpy(bench.state0, device="cpu"))
    assert_same_state(bench.state0, back)


def test_empty_and_unknown_inputs(bench):
    st = interop.state_from_numpy(bench.state0, device="cpu")
    st2, out = engine.run(bench.spec, st, bench.traces[:, :0], device="cpu")
    assert out == {} and st2 is st
    with pytest.raises(ValueError, match="unknown metric collector"):
        engine.run(bench.spec, st, bench.traces, collect=("nope",), device="cpu")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        engine.run(bench.spec, st, bench.traces, kernel_backend="xla", device="cpu")
    st2, out = engine.run(bench.spec, st, engine.SynthTrace(0, 16), device="cpu")
    assert out == {} and st2 is st
    with pytest.raises(ValueError, match="unknown workload"):
        engine.run(bench.spec, st, engine.SynthTrace(2, 16, workloads=("nope", "redis")),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        engine.run_sharded(bench.spec, st, engine.SynthTrace(2, 16))
    with pytest.raises(ValueError, match="tiers entries must be TierSpec"):  # the JAX package's
        engine.HostSpec(tiers=("near", "far"))


def test_spec_helpers_match():
    guest_fields = ("n_logical", "cl", "gpa_slack", "workload", "seed")
    kw = dict(n_logical=512, hp_ratio=16, n_gpa_hp=40, cl=8)
    jcfg, cfg = jtypes.GpacConfig(**kw), types.GpacConfig(**kw)
    for j, p in ((jengine.spec_from_config(jcfg, "hash", 3),
                  engine.spec_from_config(cfg, "hash", 3)),
                 (jengine.symmetric_spec(jcfg, 2, cl=4), engine.symmetric_spec(cfg, 2, cl=4))):
        assert (j.logical_offsets, j.hp_offsets) == (p.logical_offsets, p.hp_offsets)
        assert ([[getattr(g, f) for f in guest_fields] for g in j.guests]
                == [[getattr(g, f) for f in guest_fields] for g in p.guests])
    with pytest.raises(ValueError, match="not divisible"):
        engine.symmetric_spec(cfg, 3)


def test_snapshot_rounds_as_the_jitted_reference():
    """ROADMAP Fault 1: inside jax.jit the reference's snapshot collector
    divides by the constant n_near as a multiply by float32(1 / n_near); at
    n_near 102 that differs from the true quotient in the last bit, and the
    port's collector must round the same way."""
    workloads = ("ocean_ncp", "liblinear", "hash", "redis", "memcached", "masim")
    host = dict(hp_ratio=16, near_fraction=0.3, base_elems=3, cl=8, ipt_windows=3,
                ipt_min_hits=2, reconsolidate_cooldown=0)
    jspec, jstate = jengine.build(
        [jengine.GuestSpec(900, cl=4 + g, workload=w, seed=g) for g, w in enumerate(workloads)],
        jengine.HostSpec(**host))
    assert jspec.cfg.n_near == 102
    traces = jengine.guest_traces(jspec, 8, 4096)
    state0 = jax_state_to_numpy(jstate)
    kw = dict(policy="tpp", max_batches=8, budget=5, collect=("near_blocks", "snapshot"))
    ref_state, ref_series = jengine.run(jspec, jstate, traces, **kw)
    state, series = engine.run(_port_spec(jspec, host), interop.state_from_numpy(state0, device="cpu"),
                               traces, device="cpu", windows_per_step=4, **kw)
    assert_same_state(jax_state_to_numpy(ref_state), interop.state_to_numpy(state))
    assert_same_series(ref_series, series)
    exact = series["near_blocks"].sum(axis=1).astype(np.float32) / np.float32(102)
    assert (series["near_capacity_used"] != exact).any()  # the inputs show the fault
