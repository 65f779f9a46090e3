"""Scenarios of the port's sharded runs, and the rank worker that runs them.

The tests build each scenario twice from the same numpy inputs: in the JAX
package (the reference ``run`` / ``run_churn``) and in the port. The port's
side runs here, in one process at one rank, or as a rank of a job that
``repro_torch.launch.multihost.launch`` starts:

    python tests/torch_sharding_cases.py OUT_DIR PARTITIONABLE

In a job of N ranks every rank runs every scenario of every group of
``GROUPS`` on the CPU over gloo on an N-rank mesh, and ranks 0 and 1 run
them once more on a 2-rank mesh over a subgroup of the job (so one 4-rank
job gives both the 2- and the 4-rank results); each rank saves its results
(final state, series, collective bytes and calls) to
``OUT_DIR/<group>_n<size>_rank<r>.npz``. This module imports the port
only, never JAX.
"""
from __future__ import annotations

import os
import sys

import numpy as np

GUESTS = ((700, "redis", 0, 8), (500, "hash", 1, 4), (900, "masim", 2, 6))
# n_near 39 (not a power of two, not divisible by 2 or 4 ranks)
HOST = dict(hp_ratio=16, near_fraction=0.3, base_elems=3, cl=8, ipt_windows=3,
            ipt_min_hits=2, reconsolidate_cooldown=0)
N_WINDOWS, K = 6, 512
TIERS = (0.15, 0.25, 3.0)  # compressed_specs(near, mid, compression)
# (kind, window, guest or capacity): every fault kind of the churn engine
FAULTS = (("crash", 1, 0), ("shrink", 2, 30), ("restart", 3, 0), ("dropout", 4, None))

# name -> scenario; "host_sharded" None marks a churn run
CASES = {
    # replicated host, one collective per window
    "rep_memtierd": dict(host_sharded=False, policy="memtierd"),
    "rep_autonuma_nogpac": dict(host_sharded=False, policy="autonuma", use_gpac=False),
    "rep_tpp_snapshot": dict(host_sharded=False, policy="tpp", collect=("snapshot",)),
    "rep_compressed_synth_stride2": dict(host_sharded=False, policy="compressed",
                                         tiers=True, synth=True, stride=2, wps=2,
                                         collect=("hits", "tco")),
    "churn_faults": dict(host_sharded=None, policy="tpp", synth=True, wps=3),
    # host-partitioned near tier
    "host_memtierd": dict(host_sharded=True, policy="memtierd", wps=2),
    "host_autonuma_nogpac": dict(host_sharded=True, policy="autonuma", use_gpac=False),
    "host_tpp_snapshot": dict(host_sharded=True, policy="tpp", collect=("snapshot",)),
    "host_compressed_synth_stride2": dict(host_sharded=True, policy="compressed",
                                          tiers=True, synth=True, stride=2, wps=2,
                                          collect=("hits", "near_blocks", "tco")),
}
# scenarios whose reference is the JAX package's one-device sharded run, so
# that the per-site collective bytes are compared too
BYTES_CASES = ("rep_memtierd", "host_memtierd")
GROUPS = {
    "replicated": tuple(k for k in CASES if not k.startswith("host_")),
    "host": tuple(k for k in CASES if k.startswith("host_")),
    "migrate": ("migrate",),
}
# the migration scenario: lane 2 starts vacant and takes lane 0's guest
# (same size and CL) between two churn calls
MIGRATE_GUESTS = ((600, "redis", 0, 8), (500, "hash", 1, 4), (600, "masim", 2, 8))
MIGRATE_ACTIVE = (True, True, False)


def case(name: str) -> dict:
    c = dict(use_gpac=True, collect=("hits", "near_blocks"), synth=False, stride=1,
             wps=0, tiers=False)
    c.update(CASES[name])
    return c


def build(mod, c: dict, **kw):
    """``(spec, state)`` of the scenario in ``mod`` (either package's
    ``core.engine``); ``tiers_mod`` its ``core.tiers``."""
    guests = [mod.GuestSpec(n_logical=n, workload=w, seed=s, cl=cl)
              for n, w, s, cl in GUESTS]
    host = dict(HOST)
    tiers_mod = kw.pop("tiers_mod")
    if c["tiers"]:
        host.pop("near_fraction")
        host["tiers"] = tiers_mod.compressed_specs(*TIERS)
    return mod.build(guests, mod.HostSpec(**host), **kw)


def source(mod, spec, c: dict, partitionable: bool = True):
    if c["synth"]:
        extra = {} if partitionable is None else dict(partitionable=partitionable)
        return mod.SynthTrace(N_WINDOWS, K, **extra)
    return mod.ArrayTrace(mod.guest_traces(spec, N_WINDOWS, K))


def schedule(faults_mod, n_guests: int, n_near: int):
    s = faults_mod.FaultSchedule(n_guests)
    for kind, w, x in FAULTS:
        if kind == "dropout":
            s = s.dropout(w)
        else:
            s = getattr(s, kind)(w, x)
    return s


def knobs(c: dict) -> dict:
    return dict(policy=c["policy"], use_gpac=c["use_gpac"], collect=c["collect"],
                windows_per_step=c["wps"], arbitration_stride=c["stride"])


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def migrate(engine_mod, migration_mod, mesh=None, **dev) -> tuple:
    """Churn 3 windows, migrate lane 0 into vacant lane 2, churn 3 more
    (``mesh`` shards both churn calls); returns ``(cs, series of both
    calls, manifest)``."""
    guests = [engine_mod.GuestSpec(n_logical=n, workload=w, seed=s, cl=cl)
              for n, w, s, cl in MIGRATE_GUESTS]
    spec, state = engine_mod.build(guests, engine_mod.HostSpec(**HOST), **dev)
    traces = engine_mod.guest_traces(spec, N_WINDOWS, K)
    kw = {} if mesh is None else dict(mesh=mesh)
    cs = engine_mod.init_churn(spec, state, active=np.asarray(MIGRATE_ACTIVE), **dev)
    cs, first = engine_mod.run_churn(spec, cs, traces[:, :3], policy="tpp", **kw, **dev)
    cs, manifest = migration_mod.migrate_guest(spec, cs, 0, 2)
    cs, second = engine_mod.run_churn(spec, cs, traces[:, 3:], policy="tpp", **kw, **dev)
    return cs, dict(first=first, second=second), manifest


def run_port(name: str, mesh, partitionable: bool = True) -> dict:
    """The port's sharded run of scenario ``name`` on ``mesh`` (CPU), as a
    flat dict of numpy arrays: ``state/...``, ``series/...``,
    ``bytes/<site>`` and ``calls/<site>``."""
    from repro_torch import interop
    from repro_torch.core import engine, faults, sharding, tiers

    sharding.reset_collective_bytes()
    if name == "migrate":
        from repro_torch.launch import migration

        cs, series, manifest = migrate(engine, migration, mesh, device="cpu")
        return flatten(dict(final=interop.churn_to_numpy(cs), series=series,
                            manifest=manifest, calls=sharding.collective_calls()))
    c = case(name)
    spec, state = build(engine, c, tiers_mod=tiers, device="cpu")
    src = source(engine, spec, c, partitionable)
    if c["host_sharded"] is None:
        cs = engine.init_churn(spec, state, device="cpu")
        cs, series = engine.run_churn(
            spec, cs, src, faults=schedule(faults, spec.n_guests, spec.cfg.n_near),
            mesh=mesh, device="cpu", **knobs(c))
        final = interop.churn_to_numpy(cs)
    else:
        state, series = engine.run_sharded(
            spec, state, src, mesh=mesh, host_sharded=c["host_sharded"],
            device="cpu", **knobs(c))
        final = dict(state=interop.state_to_numpy(state))
    return flatten(dict(final=final, series=series, bytes=sharding.collective_bytes(),
                        calls=sharding.collective_calls()))


def main(out_dir: str, partitionable: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.core import sharding
    from repro_torch.launch import multihost

    torch.set_num_threads(1)  # several ranks share this machine's cores
    info = multihost.initialize()
    mesh = multihost.global_guest_mesh()
    meshes = [mesh]
    if mesh.size > 2:  # every rank creates the subgroup; ranks 0 and 1 use it
        pair = dist.new_group([0, 1])
        if mesh.rank < 2:
            meshes.insert(0, sharding.GuestMesh(pair, mesh.rank, 2, mesh.device, mesh.backend))
    for group, names in GROUPS.items():
        for m in meshes:
            results = {f"{name}/{k}": v for name in names
                       for k, v in run_port(name, m, partitionable == "1").items()}
            np.savez(os.path.join(out_dir, f"{group}_n{m.size}_rank{m.rank}.npz"), **results)
    dist.destroy_process_group()
    print(f"rank {info.process_id} of {info.num_processes}: {len(CASES) + 1} "
          f"scenarios done on {[m.size for m in meshes]} ranks")


if __name__ == "__main__":
    main(*sys.argv[1:3])
