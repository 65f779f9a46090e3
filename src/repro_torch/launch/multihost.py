"""Multi-rank runtime: process-group init, the global guest mesh and a
process launcher (port of ``repro.launch.multihost``).

* :func:`initialize` joins the ``torch.distributed`` default process group
  from the ``REPRO_*`` environment the launcher exports: the rendezvous
  address (``tcp://``), the world size, this process's rank, the device
  (CUDA unless it names another) and the backend (NCCL on CUDA, gloo on the
  CPU; gloo too for several ranks on one card), and leaves it at exit. A
  no-op for one process, so a worker runs unchanged on its own.
* :func:`global_guest_mesh` is the engine's guest mesh over every rank of
  the job: ``engine.run_sharded`` / ``run_churn`` on it are one SPMD
  program whose only collectives are the engine's own, bit-identical to the
  single-process run.
* :func:`launch` spawns N coordinated workers (``python worker *args``) on
  this machine, waits for all of them within a time limit and collects
  their output; :func:`launch_check` is its assertion form.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import socket
import subprocess
import sys
import time

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
ENV_BACKEND = "REPRO_BACKEND"
ENV_DEVICE = "REPRO_DEVICE"


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    """What :func:`initialize` resolved: this process's slot in the job.
    A rank drives one device, so ``global_devices`` is the number of
    ranks."""

    process_id: int
    num_processes: int
    coordinator_address: str | None
    local_devices: int
    global_devices: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> ProcessInfo:
    """Join (or skip) the job; returns the resolved slot. Arguments default
    to ``REPRO_COORDINATOR`` (``host:port``), ``REPRO_NUM_PROCESSES`` and
    ``REPRO_PROCESS_ID``; the device comes from ``REPRO_DEVICE`` (CUDA when
    unset: raises without a card) and the backend from ``REPRO_BACKEND``
    (when unset, NCCL on CUDA and gloo on the CPU). With NCCL the rank's
    card (``cuda:<rank mod cards>``) becomes its current device."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import sharding
    from repro_torch.kernels import runtime

    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = int(env.get(ENV_NUM_PROCESSES, "1"))
    if process_id is None:
        process_id = int(env.get(ENV_PROCESS_ID, "0"))
    if num_processes <= 1:
        return ProcessInfo(0, 1, None, 1, 1)
    if coordinator_address is None:
        raise ValueError(
            f"multihost.initialize: num_processes={num_processes} needs a "
            f"coordinator address (argument or ${ENV_COORDINATOR})")
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"multihost.initialize: process_id={process_id} outside "
            f"[0, {num_processes})")
    device = runtime.resolve_device(env.get(ENV_DEVICE))
    backend = env.get(ENV_BACKEND) or sharding.default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", rank=process_id,
        world_size=num_processes, timeout=sharding.TIMEOUT)
    atexit.register(_leave)
    return ProcessInfo(process_id, num_processes, coordinator_address, 1,
                       num_processes)


def _leave() -> None:
    """Leave the job at exit: a rank that exits with its group still up
    aborts (gloo's threads outlive the interpreter)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def global_guest_mesh(n_devices: int | None = None, *, device=None):
    """The engine's guest mesh over every rank of the job (after
    :func:`initialize`); ``device`` defaults to ``REPRO_DEVICE``, else
    CUDA."""
    from repro_torch.core import sharding

    device = device or os.environ.get(ENV_DEVICE)
    return sharding.guest_mesh(n_devices, device=device)


# --------------------------------------------------------------------------
# process launcher (N coordinated workers on one machine)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LaunchResult:
    process_id: int
    returncode: int
    stdout: str


def free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def worker_env(base: dict | None = None, *, coordinator: str, num_processes: int,
               process_id: int, device=None, backend: str | None = None,
               pythonpath: str = "src") -> dict:
    """Environment of one worker: the rendezvous variables
    :func:`initialize` reads, and ``src`` on ``PYTHONPATH``. ``device`` is
    CUDA unless named (raises without a card); ``backend`` defaults to NCCL
    on CUDA and gloo on the CPU (name gloo for several ranks on one
    card)."""
    from repro_torch.core import sharding
    from repro_torch.kernels import runtime

    dev = runtime.resolve_device(device)
    env = dict(os.environ if base is None else base)
    env[ENV_COORDINATOR] = coordinator
    env[ENV_NUM_PROCESSES] = str(num_processes)
    env[ENV_PROCESS_ID] = str(process_id)
    env[ENV_BACKEND] = backend or sharding.default_backend(dev)
    env[ENV_DEVICE] = str(dev)
    prev = env.get("PYTHONPATH")
    env["PYTHONPATH"] = f"{pythonpath}:{prev}" if prev else pythonpath
    return env


def launch(worker: str, *, num_processes: int = 2, args: tuple = (),
           timeout: float = 600.0, cwd: str | None = None, env: dict | None = None,
           device=None, backend: str | None = None) -> list[LaunchResult]:
    """Spawn ``num_processes`` coordinated workers running ``python worker
    *args`` and wait for all of them. Every worker gets the same argv; its
    slot, device and backend arrive through the ``REPRO_*`` environment
    (:func:`worker_env`: CUDA and NCCL unless named), read by
    :func:`initialize` at the top of the worker. Output (stdout and stderr)
    is captured per process. Past ``timeout`` seconds every worker is
    killed and ``TimeoutError`` raised: a hung collective in one rank would
    otherwise hang the launch."""
    if num_processes < 1:
        raise ValueError(f"launch: num_processes must be >= 1, got {num_processes}")
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    for i in range(num_processes):
        wenv = worker_env(env, coordinator=coordinator, num_processes=num_processes,
                          process_id=i, device=device, backend=backend)
        procs.append(subprocess.Popen(
            [sys.executable, worker, *map(str, args)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=wenv, cwd=cwd))
    deadline = time.monotonic() + timeout
    results = []
    try:
        for i, p in enumerate(procs):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise subprocess.TimeoutExpired(p.args, timeout)
            out, _ = p.communicate(timeout=remaining)
            results.append(LaunchResult(i, p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise TimeoutError(
            f"multihost.launch: {num_processes}-process job exceeded {timeout}s") from None
    return results


def launch_check(worker: str, *, marker: str, **kw) -> list[LaunchResult]:
    """:func:`launch`, then assert that every worker exited 0 with
    ``marker`` in its output; a failure raises with that worker's output."""
    results = launch(worker, **kw)
    for r in results:
        if r.returncode != 0 or marker not in r.stdout:
            raise AssertionError(
                f"multihost worker {r.process_id} "
                f"{'failed' if r.returncode else 'missing marker'} "
                f"(rc={r.returncode}, marker={marker!r}):\n{r.stdout}")
    return results
