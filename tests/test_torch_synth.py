"""The port's on-device trace synthesis against the JAX package, bit for
bit, on the CPU: the eleven window functions through ``synth_generate``,
``synth_setup`` / ``synth_accesses`` on a mixed plan, and ``engine.run`` /
``run_series`` over ``SynthTrace``.

The port's streams take the threefry bit layout the installed jax uses
(``jax_threefry_partitionable``). The JAX runs are computed once per module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.data import traces as jtraces  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data import traces  # noqa: E402
from test_torch_engine import (  # noqa: E402
    HOST, _port_spec, _setup, assert_same_series, assert_same_state, interop_jax_state,
    jax_state_to_numpy)

P = bool(jax.config.jax_threefry_partitionable)
SPECS = (  # (n_logical, accesses_per_window, n_windows, seed, gid)
    (777, 300, 3, 4, 0),
    (5000, 513, 2, -7, 3),
)
# k above 46,340: the reference's _stride_positions wraps in int32
WRAP_SPEC = (100_000, 65_536, 2, 1, 0)


def generate_both(workload: str, n: int, k: int, n_w: int, seed: int, gid: int):
    spec = dict(n_logical=n, hp_ratio=16, n_windows=n_w, accesses_per_window=k, seed=seed)
    ref = jtraces.synth_generate(jtraces.TraceSpec(workload, **spec), gid=gid)
    got = traces.synth_generate(traces.TraceSpec(workload, **spec), gid=gid,
                                partitionable=P, device="cpu")
    return ref, got


@pytest.mark.parametrize("workload", sorted(jtraces.workloads()))
def test_window_functions_match(workload):
    assert traces.workloads() == jtraces.workloads()
    specs = SPECS + ((WRAP_SPEC,) if workload in ("liblinear", "ocean_ncp") else ())
    for s in specs:
        ref, got = generate_both(workload, *s)
        assert ref.dtype == got.dtype and ref.shape == got.shape, s
        assert np.array_equal(ref, got), (workload, s)
    if workload == "liblinear":  # the wrap shows: positions off floor(i*n/k), not monotone
        n, k = WRAP_SPEC[:2]
        exact = np.arange(k, dtype=np.int64) * n // k
        assert (got[0] != exact).sum() == 3225 and (np.diff(got[0]) < 0).any()


def test_synth_accesses_mixed_plan_with_padding_row():
    """Three workloads over four rows, the last a padding row (gid -1): the
    setup's keys and scatter tables and two windows' accesses."""
    tables = dict(seeds=np.array([3, 3, 8, 0], np.int32), gids=np.array([0, 1, 2, -1], np.int32),
                  wid=np.array([2, 0, 1, -1], np.int32),
                  n_logical=np.array([500, 300, 450, 1], np.int32))
    kw = dict(workload_set=("hash", "masim", "redis"), accesses_per_window=257, hp_ratio=16,
              max_logical=500)
    jplan, plan = jtraces.SynthPlan(**kw), traces.SynthPlan(**kw, partitionable=P)
    jsetup = jtraces.synth_setup(jplan, {k: jnp.asarray(v) for k, v in tables.items()})
    setup = traces.synth_setup(plan, tables, device="cpu")
    assert np.array_equal(np.asarray(jsetup["win_base"]).astype(np.int64),
                          setup["win_base"].numpy())
    assert np.array_equal(np.asarray(jsetup["scatter"]).astype(np.int64), setup["scatter"].numpy())
    for w in (0, 5):
        ref = np.asarray(jtraces.synth_accesses(jplan, jsetup, jnp.int32(w)))
        got = traces.synth_accesses(plan, setup, w).numpy()
        assert ref.dtype == got.dtype and np.array_equal(ref, got), w
        assert (got[3] == -1).all()


# every workload in one fleet, ragged sizes and seeds
FLEET = ("redis", "zipf", "gauss", "memcached", "hash_drift", "ocean_ncp", "liblinear",
         "masim", "uniform", "redis_drift", "hash")
N_WINDOWS, APW = 6, 700


@pytest.fixture(scope="module")
def fleet():
    guests = [jengine.GuestSpec(600 + 97 * i, seed=i + 1, workload=w) for i, w in enumerate(FLEET)]
    jspec, state0, _ = _setup(guests)
    ref = jengine.run(jspec, interop_jax_state(state0), jengine.SynthTrace(N_WINDOWS, APW),
                      policy="tpp", windows_per_step=3)
    return jspec, _port_spec(jspec), state0, (jax_state_to_numpy(ref[0]), ref[1])


def test_run_over_synth_trace_matches_reference(fleet):
    """Two chunkings, and the same run over an ArrayTrace of the port's
    synth_generate output (each guest's own workload, seed and gid)."""
    jspec, spec, state0, (ref_state, ref_series) = fleet
    source = engine.SynthTrace(N_WINDOWS, APW, partitionable=P)
    for wps in (0, 4):
        st, series = engine.run(spec, interop.state_from_numpy(state0, device="cpu"), source,
                                device="cpu", policy="tpp", windows_per_step=wps)
        assert_same_state(ref_state, interop.state_to_numpy(st))
        assert_same_series(ref_series, series)
    per_guest = [traces.synth_generate(
        traces.TraceSpec(g.workload, n_logical=g.n_logical, hp_ratio=spec.cfg.hp_ratio,
                         n_windows=N_WINDOWS, accesses_per_window=APW, seed=g.seed),
        gid=i, partitionable=P, device="cpu") for i, g in enumerate(spec.guests)]
    st, series = engine.run(spec, interop.state_from_numpy(state0, device="cpu"),
                            engine.pack_traces(per_guest), device="cpu", policy="tpp")
    assert_same_state(ref_state, interop.state_to_numpy(st))
    assert_same_series(ref_series, series)


def test_run_series_over_synth_trace_matches_reference(fleet):
    jspec, spec, state0, _ = fleet
    over = dict(workloads=("hash",) * 5 + ("zipf",) * 6, seeds=tuple(range(20, 31)))
    jst, jout = jengine.run_series(jspec, interop_jax_state(state0),
                                   jengine.SynthTrace(4, 300, **over), policy="memtierd")
    st, out = engine.run_series(spec, interop.state_from_numpy(state0, device="cpu"),
                                engine.SynthTrace(4, 300, partitionable=P, **over),
                                device="cpu", policy="memtierd", windows_per_step=2)
    assert_same_state(jax_state_to_numpy(jst), interop.state_to_numpy(st))
    assert_same_series(jout, out)


def test_synth_trace_validation_matches_reference(fleet, monkeypatch):
    jspec, spec, state0, _ = fleet
    st = interop.state_from_numpy(state0, device="cpu")
    for kw in (dict(n_windows=-1, accesses_per_window=4), dict(n_windows=2, accesses_per_window=0)):
        with pytest.raises(ValueError) as ref:
            jengine.SynthTrace(**kw)
        with pytest.raises(ValueError, match=str(ref.value)):
            engine.SynthTrace(**kw)
    for kw in (dict(workloads=("redis",)), dict(seeds=(1, 2)),
               dict(workloads=("nope",) * len(FLEET))):
        with pytest.raises(ValueError) as ref:
            jengine.run(jspec, interop_jax_state(state0), jengine.SynthTrace(2, 8, **kw))
        with pytest.raises(ValueError) as got:
            engine.run(spec, st, engine.SynthTrace(2, 8, **kw), device="cpu")
        assert str(got.value) == str(ref.value)
    host_only = traces.Workload("host_only", traces.masim)
    monkeypatch.setitem(traces._WORKLOADS, "host_only", host_only)
    with pytest.raises(ValueError, match="no on-device window function"):
        traces.SynthPlan(("host_only",), 8, 16, 100)
    with pytest.raises(TypeError, match="needs a trace source"):
        engine.run(spec, st, None, device="cpu")

