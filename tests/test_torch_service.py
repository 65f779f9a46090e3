"""The port's churn engine over ``SynthTrace`` and its serving front
(``BackoffConfig``, ``TenantQoS``, ``AdmissionQueue``, ``TieringService``)
against the JAX package, bit for bit, on the CPU.

A five-guest fleet of a few hundred pages, each guest with its own
workload, runs the same faulted ``run_churn`` in both packages; the service
runs the same tenant script. Carries, series and every ``stats()`` must be
identical. The port's streams take the threefry bit layout the installed
jax uses; the JAX runs are computed once per module.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.serve import engine as jserve  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine, faults  # noqa: E402
from repro_torch.serve import engine as serve  # noqa: E402
from repro_torch.serve import scheduler  # noqa: E402
from test_torch_churn import jax_churn_to_numpy, same_tree  # noqa: E402
from torch_jax_core import jitted_service  # noqa: E402  (the reference's eager parts, jitted)

P = bool(jax.config.jax_threefry_partitionable)
GUESTS = (  # (n_logical, cl, workload)
    (256, 4, "redis"), (320, 8, "ocean_ncp"), (200, None, "hash_drift"),
    (288, 6, "zipf"), (240, 5, "memcached"),
)
HOST = dict(hp_ratio=16, near_fraction=0.4, base_elems=2, cl=6)
N_WINDOWS, APW = 12, 300
RUN = dict(policy="memtierd", max_batches=3, budget=8, slack=1)


def build(mod, **kw):
    guests = [mod.GuestSpec(n, cl=cl, workload=w, seed=i + 2)
              for i, (n, cl, w) in enumerate(GUESTS)]
    spec, _ = mod.build(guests, mod.HostSpec(**HOST), **kw)
    return spec


def fault_schedule(mod, n_near: int):
    return (mod.FaultSchedule(len(GUESTS)).crash(3, 1).restart(7, 1).crash(5, 2)
            .restart(5, 2).shrink(4, int(0.6 * n_near)).shrink(8, n_near).dropout(6))


@pytest.fixture(scope="module")
def churn():
    jspec = build(jengine)
    cs, series = jengine.run_churn(jspec, jengine.init_churn(jspec),
                                   jengine.SynthTrace(N_WINDOWS, APW),
                                   faults=fault_schedule(jfaults, jspec.cfg.n_near), **RUN)
    return build(engine, device="cpu"), jax_churn_to_numpy(cs), series


def test_run_churn_over_synth_trace_matches_reference(churn):
    """Every fault kind, two chunkings, and the run split into two calls,
    the second continuing the streams from the carried window."""
    spec, ref_cs, ref_series = churn
    sched = fault_schedule(faults, spec.cfg.n_near)
    for wps in (0, 4):
        cs, series = engine.run_churn(
            spec, engine.init_churn(spec, device="cpu"), engine.SynthTrace(N_WINDOWS, APW,
                                                                           partitionable=P),
            faults=sched, windows_per_step=wps, device="cpu", **RUN)
        same_tree(ref_cs, interop.churn_to_numpy(cs))
        same_tree(ref_series, series)
    tables = sched.tables(N_WINDOWS, spec.cfg.n_near)
    cs, parts = engine.init_churn(spec, device="cpu"), []
    for lo, hi in ((0, 5), (5, N_WINDOWS)):
        part = faults.FaultTables(start=lo, crash=tables.crash[lo:hi],
                                  restart=tables.restart[lo:hi],
                                  near_cap=tables.near_cap[lo:hi], drop=tables.drop[lo:hi])
        cs, series = engine.run_churn(spec, cs, engine.SynthTrace(hi - lo, APW, partitionable=P),
                                      faults=part, device="cpu", **RUN)
        parts.append(series)
    same_tree(ref_cs, interop.churn_to_numpy(cs))
    same_tree(ref_series, {k: np.concatenate([p[k] for p in parts]) for k in ref_series})


def test_backoff_and_admission_queue_match_reference():
    """A scripted admission sequence: pressure pushes due tenants out on
    the exponential schedule, cleared pressure admits FIFO into free lanes."""
    for base, cap in ((1, 16), (2, 5)):
        jb, b = jsched.BackoffConfig(base, cap), scheduler.BackoffConfig(base, cap)
        assert [jb.delay(n) for n in range(40)] == [b.delay(n) for n in range(40)]
    script = [(0, 0, 1), (1, 2, 2), (2, 1, 0), (3, 1, 3), (5, 0, 1), (6, 0, 2),
              (9, 0, 4), (12, 3, 4), (20, 0, 4)]
    queues = (jsched.AdmissionQueue(jsched.BackoffConfig(1, 4)),
              scheduler.AdmissionQueue(scheduler.BackoffConfig(1, 4)))
    for q in queues:
        for t in range(6):
            q.submit(100 + t, now=0, tier_floor=t % 2)
    for now, pressure, free in script:
        assert queues[0].admit(now, pressure, free) == queues[1].admit(now, pressure, free)
        assert list(queues[0].waiting) == list(queues[1].waiting)
        assert ({t: dataclasses.asdict(v) for t, v in queues[0].qos.items()}
                == {t: dataclasses.asdict(v) for t, v in queues[1].qos.items()})
        for t, v in queues[0].qos.items():
            w = queues[1].qos[t]
            assert (v.admission_latency, v.hit_rate, v.floor_hit_rate) == (
                w.admission_latency, w.hit_rate, w.floor_hit_rate)
    for q in queues:
        with pytest.raises(ValueError, match="already submitted"):
            q.submit(100, now=1)
        with pytest.raises(ValueError, match="tier_floor must be >= 0"):
            q.submit(999, now=1, tier_floor=-1)


def service_script(svc, n_near: int) -> list:
    """Six tenants into five lanes at tick 0 (one with tier_floor 1), one
    departure at tick 4, the near tier cut to 0.7 x n_near at tick 5 and
    restored at tick 9; stats() after every tick."""
    hist = []
    for t in range(6):
        svc.submit(10 + t, tier_floor=1 if t == 2 else 0)
    for tick in range(12):
        if tick == 4:
            svc.depart(11)
        if tick == 5:
            svc.set_near_cap(int(0.7 * n_near))
        if tick == 9:
            svc.set_near_cap(None)
        out = svc.tick()
        hist.append((svc.stats(), {k: np.asarray(v) for k, v in out.items()}))
    return hist


def test_tiering_service_matches_reference():
    with jitted_service():  # tests/torch_jax_core.py
        jspec = build(jengine)
        ref = service_script(jserve.TieringService(jspec, accesses_per_window=APW),
                             jspec.cfg.n_near)
    spec = build(engine, device="cpu")
    svc = serve.TieringService(spec, accesses_per_window=APW, partitionable=P, device="cpu")
    got = service_script(svc, spec.cfg.n_near)
    for tick, ((ref_stats, ref_out), (stats, out)) in enumerate(zip(ref, got)):
        assert stats == ref_stats, tick
        same_tree(ref_out, out, f"tick {tick}: ")
    tenants = got[-1][0]["tenants"]
    assert tenants[15]["admission_latency"] == 4  # admitted once 11 left
    assert tenants[12]["tier_floor"] == 1 and tenants[12]["floor_hit_rate"] == 1.0
    assert svc.lane_of(11) == -1
    with pytest.raises(ValueError, match="not resident"):
        svc.depart(11)
    with pytest.raises(ValueError, match="unknown kernel backend"):
        serve.TieringService(spec, kernel_backend="xla", device="cpu")
