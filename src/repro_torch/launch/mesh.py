"""Mesh construction for the port's entry points (port of
``repro.launch.mesh``'s engine half).

A function, not a module-level constant: importing this module touches no
process group. :func:`guest_mesh` is the engine's 1-D guest mesh
(``core.sharding.GuestMesh``): in a single process ``None`` (the no-mesh
degradation) unless a count is forced; after
``launch.multihost.initialize`` it spans every rank of the job, making
``engine.run_sharded`` / ``run_churn`` one SPMD program over the ranks.

The train-style meshes of the model-layer recipes (``train_mesh``,
``make_production_mesh``, ``dp_axes``, ``make_dist``) come with the rest of
the model-layer stack.
"""
from __future__ import annotations


def guest_mesh(n_devices: int | None = None, *, device=None):
    """The guest mesh over ``n_devices`` ranks (every rank of the job when
    ``None``; ``None`` result in a one-rank job); see
    ``repro_torch.core.sharding.guest_mesh``, which this delegates to."""
    from repro_torch.core import sharding

    return sharding.guest_mesh(n_devices, device=device)
