"""The port's sharded runs on a replicated host (``core.sharding``,
``engine.run_sharded(host_sharded=False)``, ``run_churn(mesh=)``,
``step(mesh=)``, ``run_series(mesh=)``) held to the JAX package.

Three ragged guests (so that 2 ranks pad one row and 4 ranks leave one rank
with no guest) run each scenario of ``torch_sharding_cases`` at 1 rank in
this process (a gloo group on an in-memory store), and at 2 and 4 ranks in
one 4-rank job started once for the test run by the port's own
``multihost.launch`` (its ranks 0 and 1 form the 2-rank mesh). Every
rank's final state and series must equal the JAX package's ``run`` /
``run_churn`` bit for bit, leaf by leaf and dtype included, with one
collective per window; where the reference is its own ``run_sharded`` on
a one-device mesh, the per-site bytes at one rank equal its too.
"""
import dataclasses
import fcntl
import json
import os
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import torch_sharding_cases as C  # noqa: E402
from repro_torch.core import sharding  # noqa: E402
from repro_torch.launch import multihost  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = str(ROOT / "tests" / "torch_sharding_cases.py")
RANKS = (2, 4)


@pytest.fixture(scope="module")
def j():
    import jax

    from repro.core import engine, faults, sharding as jsharding, tiers

    return types.SimpleNamespace(jax=jax, engine=engine, faults=faults,
                                 sharding=jsharding, tiers=tiers)


@pytest.fixture(scope="module")
def mesh1():
    mesh = sharding.guest_mesh(1, device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def partitionable(j) -> str:
    return "1" if j.jax.config.jax_threefry_partitionable else "0"


def ranked_results(tmp_path_factory, j) -> tuple[list[int], dict]:
    """Every rank's saved results, ``{group: {n_ranks: [per rank]}}``, and
    the job's process ids: one 4-rank job for every group, whose ranks 0
    and 1 also run the 2-rank mesh, each rank on one thread. The job runs
    once per test run: the files that need it share it through a lock in
    the run's temporary directory (common to every xdist worker)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = base / f"torch_sharding_ranks_p{partitionable(j)}"
    d.mkdir(exist_ok=True)
    launched = d / "launched.json"
    with open(d / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not launched.exists():
            results = multihost.launch_check(
                WORKER, marker="scenarios done", num_processes=max(RANKS),
                args=(d, partitionable(j)), cwd=str(ROOT), device="cpu",
                env=dict(os.environ, OMP_NUM_THREADS="1"), timeout=300)
            launched.write_text(json.dumps([r.process_id for r in results]))
    return json.loads(launched.read_text()), {
        group: {n: [dict(np.load(d / f"{group}_n{n}_rank{r}.npz")) for r in range(n)]
                for n in RANKS}
        for group in C.GROUPS}


@pytest.fixture(scope="module")
def ranked(tmp_path_factory, j):
    return ranked_results(tmp_path_factory, j)[1]["replicated"]


def jax_tree(x):
    """A JAX state or churn carry as nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: jax_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: jax_tree(v) for k, v in x.items()}
    return np.asarray(x)


def reference(j, name: str, driver: str = "run") -> tuple[dict, dict]:
    """The JAX package's run of scenario ``name`` (``driver`` "run" or
    "run_sharded" on a one-device mesh): the flat results as ``run_port``
    gives them, and the reference's collective bytes."""
    c = C.case(name)
    spec, state = C.build(j.engine, c, tiers_mod=j.tiers)
    src = C.source(j.engine, spec, c, None)
    kw = C.knobs(c)
    j.sharding.reset_collective_bytes()
    if c["host_sharded"] is None:
        if driver != "run":
            kw["mesh"] = j.sharding.guest_mesh(1)
        cs = j.engine.init_churn(spec, state)
        cs, series = j.engine.run_churn(
            spec, cs, src, faults=C.schedule(j.faults, spec.n_guests, spec.cfg.n_near), **kw)
        final = jax_tree(cs)
    else:
        if driver == "run":
            state, series = j.engine.run(spec, state, src, **kw)
        else:
            state, series = j.engine.run_sharded(
                spec, state, src, mesh=j.sharding.guest_mesh(1),
                host_sharded=c["host_sharded"], **kw)
        final = dict(state=jax_tree(state))
    return C.flatten(dict(final=final, series=series)), j.sharding.collective_bytes()


def assert_same(ref: dict, got: dict, what: str) -> None:
    keys = {k for k in got if k.startswith(("final/", "series/"))}
    assert keys == set(ref), (what, sorted(keys ^ set(ref)))
    for k, want in ref.items():
        have = got[k]
        assert have.dtype == want.dtype and have.shape == want.shape, (what, k)
        assert np.array_equal(have.reshape(-1).view(np.uint8),
                              want.reshape(-1).view(np.uint8)), (what, k)


def check_case(j, mesh1, ranked, name: str, site_calls: dict) -> None:
    """Scenario ``name`` at 1 rank here and at every rank of the 2- and
    4-rank jobs: equal to the reference, with ``site_calls`` collectives;
    for a ``BYTES_CASES`` scenario the reference is the JAX package's
    one-device sharded run, and the bytes per site at one rank equal its."""
    driver = "run_sharded" if name in C.BYTES_CASES else "run"
    ref, ref_bytes = reference(j, name, driver)
    results = [("1 rank", C.run_port(name, mesh1, partitionable(j) == "1"))]
    for n, per_rank in ranked.items():
        results += [(f"rank {r} of {n}",
                     {k[len(name) + 1:]: v for k, v in res.items() if k.startswith(name + "/")})
                    for r, res in enumerate(per_rank)]
    for what, got in results:
        assert_same(ref, got, f"{name} {what}")
        assert {k: int(got[f"calls/{k}"]) for k in site_calls} == site_calls, (name, what)
    if driver == "run_sharded":
        one = results[0][1]
        assert {k[len("bytes/"):]: int(v) for k, v in one.items()
                if k.startswith("bytes/")} == ref_bytes


@pytest.mark.parametrize("name", C.GROUPS["replicated"])
def test_sharded_run_matches_reference(j, mesh1, ranked, name):
    check_case(j, mesh1, ranked, name, {"merge_window": C.N_WINDOWS})


def test_guest_tables_match_reference(j):
    """The numpy helpers at every mesh size, no devices needed."""
    from repro_torch.core import engine, tiers

    for c in (C.case("rep_memtierd"), C.case("rep_compressed_synth_stride2")):
        spec, _ = C.build(engine, c, tiers_mod=tiers, device="cpu")
        jspec, _ = C.build(j.engine, c, tiers_mod=j.tiers)
        for n in (1, 2, 3, 4):
            assert sharding.padded_guest_count(3, n) == j.sharding.padded_guest_count(3, n)
            want = j.sharding.guest_tables(jspec, n)
            got = sharding.guest_tables(spec, n)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype
            rows = np.arange(12, dtype=np.int32).reshape(3, 4)
            np.testing.assert_array_equal(sharding.pad_guest_rows(rows, n),
                                          j.sharding.pad_guest_rows(rows, n))


def test_one_collective_per_window(mesh1, monkeypatch):
    """One ``all_reduce`` call per window, the pools included (coalesced on
    gloo's CPU path), whatever the chunking."""
    calls = []
    dist = torch.distributed
    for fn in ("all_reduce", "all_reduce_coalesced"):
        real = getattr(dist, fn)
        monkeypatch.setattr(dist, fn, lambda *a, _r=real, _n=fn, **k: (calls.append(_n), _r(*a, **k))[1])
    res = C.run_port("rep_compressed_synth_stride2", mesh1)
    assert len(calls) == C.N_WINDOWS == int(res["calls/merge_window"])
    assert set(calls) == {"all_reduce_coalesced"}


def test_step_run_series_and_degradation(j, mesh1):
    """``step(mesh=)`` over a ChurnState equals one ``run_churn``;
    ``run_series(mesh=)`` equals the unsharded series on both host paths; a
    one-rank job without a forced mesh runs ``run``; a TieredState step
    with a mesh, or a mesh wider than the job, raises."""
    from repro_torch.core import engine, tiers

    c = C.case("rep_memtierd")
    spec, state = C.build(engine, c, tiers_mod=tiers, device="cpu")
    traces = engine.guest_traces(spec, C.N_WINDOWS, C.K)
    want_cs, want = engine.run_churn(spec, engine.init_churn(spec, state, device="cpu"),
                                     traces, device="cpu")
    spec, state = C.build(engine, c, tiers_mod=tiers, device="cpu")
    cs = engine.init_churn(spec, state, device="cpu")
    for w in range(C.N_WINDOWS):
        cs, out = engine.step(spec, cs, torch.from_numpy(traces[:, w]), mesh=mesh1)
        for k in want:
            np.testing.assert_array_equal(out[k].cpu().numpy() if torch.is_tensor(out[k])
                                          else out[k], want[k][w])
    np.testing.assert_array_equal(cs.state.rmap.numpy(), want_cs.state.rmap.numpy())

    spec, state = C.build(engine, c, tiers_mod=tiers, device="cpu")
    _, ser = engine.run_series(spec, state, traces, device="cpu")
    for hs in (False, True):
        spec, state = C.build(engine, c, tiers_mod=tiers, device="cpu")
        _, got = engine.run_series(spec, state, traces, mesh=mesh1, host_sharded=hs,
                                   device="cpu")
        for k in ser:
            np.testing.assert_array_equal(got[k], ser[k])
            assert got[k].dtype == ser[k].dtype

    assert sharding.guest_mesh(device="cpu") is None  # a one-rank job
    spec, state = C.build(engine, c, tiers_mod=tiers, device="cpu")
    s1, r1 = engine.run_sharded(spec, state, traces, device="cpu")
    spec, state = C.build(engine, c, tiers_mod=tiers, device="cpu")
    s2, r2 = engine.run(spec, state, traces, device="cpu")
    for k in r2:
        np.testing.assert_array_equal(r1[k], r2[k])
    with pytest.raises(TypeError):
        engine.step(spec, s2, torch.from_numpy(traces[:, 0]), mesh=mesh1)
    with pytest.raises(ValueError):
        sharding.guest_mesh(2, device="cpu")
