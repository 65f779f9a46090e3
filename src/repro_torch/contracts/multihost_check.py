"""The 2-rank job of ``INV-MULTIHOST-EXACT`` (DESIGN.md §17): one rank of a
coordinated job, held bit for bit to its own single-process run.

Run as a script by ``launch.multihost.launch_check`` (which exports the
``REPRO_*`` environment ``multihost.initialize`` reads):

    python src/repro_torch/contracts/multihost_check.py

Each rank joins the job, builds six ragged guests on its device and checks
on the job's guest mesh, against ``engine.run`` / ``engine.run_churn`` in
the same process:

* ``run_sharded`` over an array and a synthesized source, on both host
  paths (replicated and host-partitioned);
* ``run_sharded`` with ``arbitration_stride=2`` (one exchange per two
  windows) against ``run`` with the same stride;
* ``run_churn(mesh=)`` under a crash and a restart, a live migration of
  lane 0 into the vacant lane 5 between two calls, and the continued run.

It prints ``MULTIHOST CHECK OK`` at the end; any difference raises.
"""
from __future__ import annotations

import pathlib
import sys

N_WINDOWS, APW = 4, 128


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.contracts.invariants import (
        MULTIHOST_MARKER, assert_series_equal, assert_states_equal)
    from repro_torch.core import engine, faults
    from repro_torch.launch import migration, multihost

    info = multihost.initialize()
    mesh = multihost.global_guest_mesh()
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    # lane 5 is the migration spare: same geometry and CL as lane 0
    guests = tuple(
        engine.GuestSpec(
            n_logical=64, cl=(None if g % 3 == 0 or g == 5 else 3 + g % 5),
            workload=["redis", "masim", "hash"][g % 3], seed=g)
        for g in range(6))
    spec, _ = engine.build(
        guests, engine.HostSpec(hp_ratio=16, near_fraction=0.4, base_elems=2, cl=6),
        device=dev)

    def fresh():
        return engine.init_engine_state(spec, device=dev)

    sources = dict(
        array=engine.ArrayTrace(engine.guest_traces(spec, N_WINDOWS, APW)),
        synth=engine.SynthTrace(n_windows=N_WINDOWS, accesses_per_window=APW),
    )
    for name, source in sources.items():
        ref_state, ref = engine.run(spec, fresh(), source, device=dev)
        for host_sharded in (False, True):
            what = f"{name}, host_sharded={host_sharded}"
            st, series = engine.run_sharded(spec, fresh(), source, mesh=mesh,
                                            host_sharded=host_sharded, device=dev)
            assert_states_equal(ref_state, st, what)
            assert_series_equal(ref, series, what)
            print(f"[{info.process_id}] OK {what}", flush=True)

    synth = sources["synth"]
    ref_state, ref = engine.run(spec, fresh(), synth, arbitration_stride=2, device=dev)
    st, series = engine.run_sharded(spec, fresh(), synth, mesh=mesh,
                                    arbitration_stride=2, device=dev)
    assert_states_equal(ref_state, st, "stride=2")
    assert_series_equal(ref, series, "stride=2")
    print(f"[{info.process_id}] OK stride=2", flush=True)

    fs = faults.no_faults(len(guests)).crash(2, 1).restart(3, 1)
    active = np.ones(len(guests), bool)
    active[5] = False  # the vacant spare lane, the migration's destination

    def protocol(mesh):
        cs = engine.init_churn(spec, fresh(), active=active, device=dev)
        cs, head = engine.run_churn(spec, cs, synth, faults=fs, mesh=mesh, device=dev)
        cs, manifest = migration.migrate_guest(spec, cs, src=0, dst=5)
        cs, tail = engine.run_churn(spec, cs, synth, faults=fs, mesh=mesh, device=dev)
        return cs, head, tail, manifest

    ref_cs, ref_head, ref_tail, ref_man = protocol(None)
    cs, head, tail, man = protocol(mesh)
    assert man == ref_man, (man, ref_man)
    assert_series_equal(ref_head, head, "churn before the migration")
    assert_series_equal(ref_tail, tail, "churn after the migration")
    assert_states_equal(ref_cs, cs, "churn carry after the migration")
    print(f"[{info.process_id}] OK churn + migration "
          f"({man['total_bytes']} bytes moved)", flush=True)
    print(f"[{info.process_id}] {MULTIHOST_MARKER}", flush=True)
    return 0


if __name__ == "__main__":
    # run as a script: the package root, not this directory, heads the path
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[2])
    sys.exit(main())
