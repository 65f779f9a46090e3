"""Mesh construction for the port's entry points (port of
``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group. Two families:

* :func:`guest_mesh` -- the engine's 1-D guest mesh
  (``core.sharding.GuestMesh``): in a single process ``None`` (the no-mesh
  degradation) unless a count is forced; after
  ``launch.multihost.initialize`` it spans every rank of the job, making
  ``engine.run_sharded`` / ``run_churn`` one SPMD program over the ranks.
* :func:`train_mesh` / :func:`make_production_mesh` -- the training
  geometry, ``(data, model)`` or ``(pod, data, model)``, over the job's
  ranks in the reference's axis order (rank = row-major index of its
  coordinates). A :class:`TrainMesh` holds a process group per axis and
  one over the data-parallel axes together; :func:`make_dist` wraps it in
  the ``models.dist.Dist`` that the trainer threads through the model.
  ``make_production_mesh`` asks for ``DEFAULT_DATA x DEFAULT_MODEL`` (x
  ``DEFAULT_PODS``) ranks, read when it is called: 256 or 512, a pod's
  worth, and a job of another size is refused.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os

DEFAULT_DATA = 16
DEFAULT_MODEL = 16
DEFAULT_PODS = 2


def guest_mesh(n_devices: int | None = None, *, device=None):
    """The guest mesh over ``n_devices`` ranks (every rank of the job when
    ``None``; ``None`` result in a one-rank job); see
    ``repro_torch.core.sharding.guest_mesh``, which this delegates to."""
    from repro_torch.core import sharding

    return sharding.guest_mesh(n_devices, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class TrainMesh:
    """One rank's view of a training mesh: the axis names and sizes, its
    coordinates, its index among the mesh's ranks (``rank``, of ``size``),
    its device and backend, and its process groups (:meth:`group`): one per
    axis, one over ``("pod", "data")`` when the mesh has pods, and one over
    the whole mesh (None: the default group)."""

    axis_names: tuple
    shape: dict
    coords: dict
    rank: int
    size: int
    device: object
    backend: str
    groups: dict

    def group(self, axes):
        """The process group of this rank's peers along ``axes`` (an axis
        name or a tuple of them)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self.groups[tuple(a for a in self.axis_names if a in axes)]


def train_mesh(data: int = DEFAULT_DATA, model: int = DEFAULT_MODEL,
               pods: int | None = None, *, device=None):
    """Train-style mesh of ``data x model`` ranks per pod, with an optional
    leading ``pod`` axis when ``pods`` is given (``pods=1`` still carries the
    axis -- callers that want the flat 2-D geometry pass ``pods=None``).

    It spans every rank of the job. A single process that joined no job
    gets a one-rank group of its own (NCCL on CUDA, gloo on the CPU). The
    mesh needs as many ranks as the job has, else ValueError naming both
    counts. ``device`` is the rank's (``REPRO_DEVICE``, else CUDA)."""
    if data < 1 or model < 1 or (pods is not None and pods < 1):
        raise ValueError(
            f"train_mesh: axis sizes must be >= 1, got "
            f"data={data}, model={model}, pods={pods}")
    import torch.distributed as dist

    from repro_torch.core import sharding
    from repro_torch.kernels import runtime
    from repro_torch.launch import multihost

    names = ("data", "model") if pods is None else ("pod", "data", "model")
    sizes = (data, model) if pods is None else (pods, data, model)
    n = math.prod(sizes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(
            f"train_mesh: a {' x '.join(f'{a}={s}' for a, s in zip(names, sizes))} mesh "
            f"needs {n} ranks; this job has {world} (start {n} ranks with "
            f"launch.multihost, or pick axis sizes whose product is {world})")
    device = runtime.resolve_device(device or os.environ.get(multihost.ENV_DEVICE))
    if not dist.is_initialized():
        dist.init_process_group(sharding.default_backend(device), store=dist.HashStore(),
                                rank=0, world_size=1, timeout=sharding.TIMEOUT)
    me, backend = dist.get_rank(), dist.get_backend()
    coords = [dict(zip(names, _coords(r, sizes))) for r in range(n)]
    # a group per axis and one over the data-parallel axes together; every
    # rank creates every group, in one order (torch.distributed's rule)
    groups = {names: None}  # the whole mesh: the default group
    for axes in [(a,) for a in names] + [names[:-1]] * (pods is not None):
        others = [a for a in names if a not in axes]
        for fixed in itertools.product(*(range(sizes[names.index(a)]) for a in others)):
            members = [r for r in range(n)
                       if all(coords[r][a] == v for a, v in zip(others, fixed))]
            g = dist.new_group(members, backend=backend, timeout=sharding.TIMEOUT)
            if me in members:
                groups[axes] = g
    return TrainMesh(axis_names=names, shape=dict(zip(names, sizes)), coords=coords[me],
                     rank=me, size=n, device=sharding._rank_device(device, backend, me),
                     backend=backend, groups=groups)


def _coords(i: int, sizes: tuple) -> tuple:
    """The row-major coordinates of index ``i`` in a grid of ``sizes``."""
    out = []
    for s in reversed(sizes):
        i, c = divmod(i, s)
        out.append(c)
    return tuple(reversed(out))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production geometry as a thin :func:`train_mesh` special case."""
    return train_mesh(DEFAULT_DATA, DEFAULT_MODEL,
                      pods=DEFAULT_PODS if multi_pod else None, device=device)


def dp_axes(mesh) -> tuple:
    """Batch/token axes of a mesh made by make_production_mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_dist(mesh):
    from repro_torch.models.dist import Dist

    return Dist(mesh=mesh, dp=dp_axes(mesh), tp="model")
