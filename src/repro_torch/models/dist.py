"""Distribution context threaded through the model's training functions
(port of ``repro.models.dist``).

``Dist`` carries the mesh (``launch.mesh.TrainMesh``: axis names and sizes,
a process group per axis and one over the data-parallel axes together) and
the names of the data-parallel (``dp``) and tensor-parallel (``tp``) axes.
Without a mesh (``NO_DIST``) every helper is the identity.

The reference's ``constrain`` is a ``with_sharding_constraint``: it places
work and changes no value. Here it returns its input and stays at the
reference's call sites, so that a later layout has them.

What the port adds are the data-parallel collectives, over the DP group
only: :meth:`Dist.psum` and :meth:`Dist.all_gather` (counted per site in
``core.sharding``'s collective record). With ``NO_DIST`` they return their
input; on a one-rank mesh they run and change nothing.

A spec is a :class:`P`, a tuple with one entry per dim: None, an axis name,
or a tuple of names (JAX's ``PartitionSpec``, entry for entry).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: P


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class Dist:
    mesh: Any = None
    dp: tuple = ("data",)  # batch/token axes ("pod","data") multi-pod
    tp: str = "model"  # heads / d_ff / vocab / experts axis

    def axis_size(self, axes) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for a in _axes(axes):
            n *= self.mesh.shape[a]
        return n

    def fit_spec(self, shape, spec) -> P:
        """Drop spec axes that don't divide the dim (divisibility fallback)."""
        fixed = []
        for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
            if ax is None:
                fixed.append(None)
            elif dim % self.axis_size(ax) == 0:
                fixed.append(ax)
            else:
                fixed.append(None)
        return P(*fixed)

    def constrain(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """The reference's sharding constraint: the value unchanged."""
        return x

    def sharding(self, shape, spec) -> P | None:
        """The fitted spec (None without a mesh)."""
        if self.mesh is None:
            return None
        return self.fit_spec(shape, spec)

    # ------------------------------------------------------------------
    # the data-parallel axes
    # ------------------------------------------------------------------
    def dp_size(self) -> int:
        return self.axis_size(self.dp)

    def dp_rank(self) -> int:
        """This rank's index along the DP axes (row-major in ``dp``'s order)."""
        if self.mesh is None:
            return 0
        r = 0
        for a in _axes(self.dp):
            r = r * self.mesh.shape[a] + self.mesh.coords[a]
        return r

    def psum(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """Sum of ``x`` over the DP ranks (a new tensor; ``x`` without a
        mesh). ``x`` carries no gradient."""
        if self.mesh is None:
            return x
        out = x.detach().clone()
        self.all_reduce_([out], site)
        return out

    def all_reduce_(self, tensors: list, site: str) -> None:
        """SUM over the DP ranks in place, one call a tensor."""
        if self.mesh is None:
            return
        import torch.distributed as tdist

        from repro_torch.core import sharding

        group = self.mesh.group(self.dp)
        for t in tensors:
            tdist.all_reduce(t, group=group)
        sharding.count_collective(site, sum(t.numel() * t.element_size() for t in tensors),
                                  len(tensors))

    def all_gather(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """Every DP rank's ``x``, stacked in rank order: (dp_size, *x.shape)."""
        if self.mesh is None:
            return x[None]
        import torch.distributed as tdist

        from repro_torch.core import sharding

        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.dp_size())]
        tdist.all_gather(parts, x, group=self.mesh.group(self.dp))
        sharding.count_collective(site, x.numel() * x.element_size() * len(parts), 1)
        return torch.stack(parts)

    def barrier(self) -> None:
        """Every rank of the mesh waits for the others."""
        if self.mesh is not None:
            import torch.distributed as tdist

            tdist.barrier(group=self.mesh.group(self.mesh.axis_names))

    @property
    def is_coordinator(self) -> bool:
        """Rank 0 of the mesh (true without a mesh)."""
        return self.mesh is None or self.mesh.rank == 0


NO_DIST = Dist()
