"""The port's multi-rank runtime (``launch.multihost``, ``launch.mesh``),
live migration (``launch.migration``) and the two launch-path repairs of
the kernels (a launch goes to its tensors' device and stream; concurrent
first builds make one library), held to the JAX package where it has a
counterpart.

The migration runs in this process against ``repro.launch.migration``
phase by phase, and on the 2- and 4-rank meshes of the test run's one
4-rank job (started by ``multihost.launch``, see ``test_torch_sharding``),
whose sharded churn calls around the migration must equal the reference's
unsharded ones bit for bit.
"""
import ctypes
import os
import pathlib
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import torch_sharding_cases as C  # noqa: E402
from test_torch_sharding import assert_same, jax_tree, ranked_results  # noqa: E402

from repro_torch.kernels import build, registry, runtime  # noqa: E402
from repro_torch.launch import migration, multihost  # noqa: E402



@pytest.fixture(scope="module")
def j():
    import jax

    from repro.core import engine
    from repro.launch import migration as jmigration

    return types.SimpleNamespace(jax=jax, engine=engine, migration=jmigration)


@pytest.fixture(scope="module")
def reference_migration(j):
    cs, series, manifest = C.migrate(j.engine, j.migration)
    return C.flatten(dict(final=jax_tree(cs), series=series)), manifest


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_two_rank_job_migrates_and_churns_like_the_reference(
        tmp_path_factory, j, reference_migration):
    """``launch_check`` starts the run's 4 coordinated ranks (ranks 0 and 1
    also form a 2-rank mesh); on each mesh every rank runs sharded churn, a
    migration into another rank's lane and more sharded churn, and ends
    with the reference's unsharded result, one collective per window."""
    ref, manifest = reference_migration
    ids, ranked = ranked_results(tmp_path_factory, j)
    assert ids == [0, 1, 2, 3]
    for n, per_rank in ranked["migrate"].items():
        for r, res in enumerate(per_rank):
            got = {k[len("migrate/"):]: v for k, v in res.items()}
            assert_same(ref, got, f"rank {r} of {n}")
            assert {k[len("manifest/"):]: int(v) for k, v in got.items()
                    if k.startswith("manifest/")} == manifest
            assert int(got["calls/merge_window"]) == C.N_WINDOWS


def test_launch_times_out_and_kills_every_worker(tmp_path):
    hang = tmp_path / "hang.py"
    hang.write_text("import time\ntime.sleep(120)\n")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        multihost.launch(str(hang), num_processes=2, timeout=2.0, device="cpu")
    assert time.monotonic() - t0 < 30
    with pytest.raises(ValueError):
        multihost.launch(str(hang), num_processes=0)
    failing = tmp_path / "fail.py"
    failing.write_text("import sys\nprint('no marker')\nsys.exit(3)\n")
    with pytest.raises(AssertionError, match="rc=3"):
        multihost.launch_check(str(failing), marker="done", num_processes=1, timeout=60,
                               device="cpu")


def test_initialize_environment_and_mesh(monkeypatch):
    """One process: ``initialize`` joins nothing and ``guest_mesh()`` is the
    no-mesh degradation; the worker environment carries the rendezvous, the
    device (CUDA unless named: without a card a job is refused) and the
    backend (NCCL on CUDA, gloo on the CPU, gloo when named)."""
    for k in (multihost.ENV_NUM_PROCESSES, multihost.ENV_COORDINATOR,
              multihost.ENV_DEVICE, multihost.ENV_BACKEND):
        monkeypatch.delenv(k, raising=False)
    info = multihost.initialize()
    assert info == multihost.ProcessInfo(0, 1, None, 1, 1) and info.is_coordinator
    assert not torch.distributed.is_initialized()
    from repro_torch.core import sharding
    from repro_torch.launch import mesh

    assert mesh.guest_mesh(device="cpu") is None
    assert multihost.global_guest_mesh(device="cpu") is None
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize("127.0.0.1:1", num_processes=2, process_id=2)
    env = multihost.worker_env({"PYTHONPATH": "x"}, coordinator="127.0.0.1:5",
                               num_processes=4, process_id=3, device="cpu")
    assert env[multihost.ENV_COORDINATOR] == "127.0.0.1:5"
    assert (env[multihost.ENV_NUM_PROCESSES], env[multihost.ENV_PROCESS_ID]) == ("4", "3")
    assert (env[multihost.ENV_BACKEND], env[multihost.ENV_DEVICE]) == ("gloo", "cpu")
    assert env["PYTHONPATH"] == "src:x"
    assert 0 < multihost.free_port() < 65536
    assert sharding.default_backend(torch.device("cuda")) == "nccl"
    if not torch.cuda.is_available():
        kw = dict(coordinator="127.0.0.1:5", num_processes=2, process_id=0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.worker_env(**kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.launch("worker.py", num_processes=2)
        monkeypatch.setenv(multihost.ENV_NUM_PROCESSES, "2")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.initialize("127.0.0.1:1", process_id=0)


# --------------------------------------------------------------------------
# migration, phase by phase, against the reference
# --------------------------------------------------------------------------
def test_migration_phases_match_reference(j, reference_migration):
    import dataclasses

    from repro_torch.core import engine

    ref, manifest = reference_migration
    cs, series, got_manifest = C.migrate(engine, migration, device="cpu")
    from repro_torch import interop

    assert_same(ref, C.flatten(dict(final=interop.churn_to_numpy(cs), series=series)),
                "in-process migration")
    assert got_manifest == manifest

    # each phase alone, on a state with both lanes busy first
    def fresh(mod, **dev):
        guests = [mod.GuestSpec(n_logical=n, workload=w, seed=s, cl=cl)
                  for n, w, s, cl in C.MIGRATE_GUESTS]
        spec, state = mod.build(guests, mod.HostSpec(**C.HOST), **dev)
        traces = mod.guest_traces(spec, 3, C.K)
        run = dict(device="cpu") if dev else {}
        state, _ = mod.run(spec, state, traces, **run)
        return spec, state

    jspec, jstate = fresh(j.engine)
    spec, state = fresh(engine, device="cpu")
    jpkg = j.migration.extract_guest(jspec, jstate, 0)
    pkg = migration.extract_guest(spec, state, 0)
    for f in dataclasses.fields(jpkg):
        a, b = getattr(pkg, f.name), getattr(jpkg, f.name)
        if isinstance(b, np.ndarray) or hasattr(b, "dtype"):
            b = np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    jstate = j.migration.release_guest(jspec, jstate, 2)
    state = migration.release_guest(spec, state, 2)
    jstate = j.migration.inject_guest(jspec, jstate, 2, jpkg)
    state = migration.inject_guest(spec, state, 2, pkg)
    assert_same(C.flatten(dict(final=jax_tree(jstate))),
                C.flatten(dict(final=interop.state_to_numpy(state))), "release + inject")
    with pytest.raises(ValueError, match="still holds"):
        migration.inject_guest(spec, state, 2, pkg)
    with pytest.raises(ValueError, match="geometry"):
        migration.inject_guest(spec, state, 1, pkg)
    cs = engine.init_churn(spec, state, device="cpu")
    with pytest.raises(ValueError, match="active"):
        migration.migrate_guest(spec, cs, 0, 2)
    assert not bool(migration.quiesce(cs, 1).active[1])
    assert bool(migration.resume(migration.quiesce(cs, 1), 1).active[1])


# --------------------------------------------------------------------------
# the launch-path repairs
# --------------------------------------------------------------------------
class _FakeLib:
    """A kernel library whose entries launch nothing and report success."""

    def __getattr__(self, name):
        value = 2048 if name == "rt_topk_max_k" else 0

        def entry(*args):
            return value

        setattr(self, name, entry)
        return entry


def test_kernels_launch_on_their_tensors_device(monkeypatch):
    """Every registry wrapper makes its inputs' device current for the launch
    and takes that device's stream, never the process's current device.
    (On the CPU the launch path is driven with a library that launches
    nothing.)"""
    from repro_torch.kernels.paged_attention import ops as paged

    asked = []

    class Stream:
        cuda_stream = 0

    def current_stream(device=None):
        asked.append(("stream", device))
        return Stream()

    class DeviceGuard:
        def __init__(self, device):
            asked.append(("device", device))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(runtime, "on_cuda", lambda *t: True)
    monkeypatch.setattr(build, "library", lambda: _FakeLib())
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "device", DeviceGuard)
    monkeypatch.setattr(paged, "_n_sm", lambda index: 132)
    paged._WORKSPACE.clear()
    names = registry.kernel_names()
    assert len(names) == 9
    before = registry.launch_counts()
    for name in names:
        spec = registry.get_kernel(name)
        args, kw = spec.example("cpu")
        asked.clear()
        spec.kernel(*args, **kw)
        dev = args[0].device
        assert ("device", dev) in asked and ("stream", dev) in asked, (name, asked)
        assert all(d == dev for _, d in asked), (name, asked)
    assert all(registry.launch_counts()[n] > before[n] for n in names)
    paged._WORKSPACE.clear()


def test_concurrent_first_builds_make_one_library(tmp_path, monkeypatch):
    """Two builds started together compile each source once (under the
    lock, to objects of their own) and load the same library."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "a = sys.argv[1:]\n"
        "out = a[a.index('-o') + 1]\n"
        "if '-c' in a:\n"
        f"    open({str(log)!r}, 'a').write(a[a.index('-c') + 1] + '\\n')\n"
        "time.sleep(0.2)\n"
        "open(out, 'w').write('built')\n")
    nvcc.chmod(0o755)
    loaded = []

    class FakeCDLL(_FakeLib):
        def __init__(self, path):
            loaded.append(path)

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(ctypes, "CDLL", FakeCDLL)
    start = threading.Barrier(2)
    errors = []

    def first_build():
        try:
            start.wait()
            build.library()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    compiled = log.read_text().split()
    sources = [str(s) for s in build._sources()]
    assert sorted(compiled) == sorted(sources)  # each source once
    assert loaded and len(set(loaded)) == 1
    out_dir = pathlib.Path(loaded[0]).parent
    assert not list(out_dir.glob("*.o"))  # the per-process objects are gone
    assert (out_dir / ".lock").exists()
