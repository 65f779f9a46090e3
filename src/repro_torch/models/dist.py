"""Distribution context threaded through the model's training functions
(port of ``repro.models.dist``).

``Dist`` carries the mesh (``launch.mesh.TrainMesh``: axis names and sizes,
a process group per axis and one over the data-parallel axes together) and
the names of the data-parallel (``dp``) and tensor-parallel (``tp``) axes.
Without a mesh (``NO_DIST``) every helper is the identity.

Two kinds of mesh. A ``TrainMesh`` is the live data-parallel step's: each
rank holds its rows of the batch, and the model sums over the DP group by
hand (:attr:`Dist.dp_split`): :meth:`Dist.psum` and :meth:`Dist.all_gather`
(counted per site in ``core.sharding``'s collective record). With
``NO_DIST`` they return their input; on a one-rank mesh they run and
change nothing. A mesh with a ``device_mesh`` (``launch.mesh.SpmdMesh``,
the dry run's) is the reference's global view: the tensors are DTensors
over that ``DeviceMesh``, every value is the global one, and the
collectives are the ones DTensor issues; the hand-made ones are then the
identity, as without a mesh.

The reference's ``constrain`` is a ``with_sharding_constraint``: it places
work and changes no value. Under a global-view mesh :meth:`Dist.constrain`
lays the tensor out by the fitted spec's placements (:func:`placements`),
and its gradient likewise; elsewhere it returns the tensor as it is.

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
        """The reference's sharding constraint. Under a global-view mesh the
        tensor laid out by the fitted spec over the mesh's ``DeviceMesh``: a
        DTensor redistributed, a plain tensor (a value every rank holds
        whole, as DTensor's implicit replication takes it) made a DTensor
        and sliced; its gradient is laid out the same way. Elsewhere the
        tensor as it is. The value is unchanged."""
        if not self.spmd:
            return x
        from torch.distributed.tensor import DTensor, Replicate

        dm = self.mesh.device_mesh
        want = placements(self.mesh, self.fit_spec(x.shape, P(*spec)))
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)
        if tuple(x.placements) != want:
            x = x.redistribute(dm, want)
        return _CotangentLayout.apply(x, want) if x.requires_grad else x

    def sharding(self, shape, spec) -> P | None:
        """The fitted spec (None without a mesh)."""
        if self.mesh is None:
            return None
        return self.fit_spec(shape, spec)

    def local(self, fn, args: tuple, specs: tuple, out: tuple | None = None,
              inplace: tuple = ()):
        """``fn(*args)`` on each rank's shards, as JAX's ``shard_map``: under
        a global-view mesh each tensor arg laid out by its spec (None: passed
        as it is), ``fn`` run on the local shards and its output laid out as
        the first arg, or as ``out`` = (its global shape, its spec). ``fn``
        must be parallel along every sharded dim. DTensor cannot shard a
        batched product whose batch merges two sharded dims (batch and
        heads), nor every in-place scatter or pad; inside ``fn`` each rank's
        op is a plain one, and the gradients it hands back are made
        contiguous (DTensor takes a shard's layout to be the global one's).
        The args at ``inplace``, which ``fn`` writes, must already have their
        spec's layout (a reshard would write a copy). Elsewhere
        ``fn(*args)``."""
        if not self.spmd:
            return fn(*args)
        from torch.distributed.tensor.experimental import local_map

        for i in inplace:
            want = placements(self.mesh, self.fit_spec(args[i].shape, P(*specs[i])))
            if tuple(args[i].placements) != want:
                raise ValueError(f"an in-place arg laid out {args[i].placements}, not {want}")
        args = tuple(a if s is None else self.constrain(a, *s) for a, s in zip(args, specs))
        in_pl = tuple(None if s is None else a.placements for a, s in zip(args, specs))
        out_pl = args[0].placements if out is None else placements(
            self.mesh, self.fit_spec(out[0], P(*out[1])))

        def run(*local):
            return fn(*(_ContiguousGrad.apply(t) if isinstance(t, torch.Tensor)
                        and t.requires_grad else t for t in local))

        return local_map(run, out_placements=(out_pl,), in_placements=in_pl,
                         device_mesh=self.mesh.device_mesh)(*args)

    @property
    def spmd(self) -> bool:
        """A global-view mesh whose tensors are DTensors (the dry run's)."""
        return getattr(self.mesh, "device_mesh", None) is not None

    @property
    def dp_split(self) -> bool:
        """Each rank holds its rows and the DP sums are taken by hand (a
        ``TrainMesh``)."""
        return self.mesh is not None and not self.spmd

    # ------------------------------------------------------------------
    # the data-parallel axes, split by hand
    # ------------------------------------------------------------------
    def dp_size(self) -> int:
        """The DP ranks the batch is split over by hand (1 without a mesh
        and on a global-view mesh)."""
        return self.axis_size(self.dp) if self.dp_split else 1

    def dp_rank(self) -> int:
        """This rank's index along the DP axes (row-major in ``dp``'s order)."""
        if not self.dp_split:
            return 0
        r = 0
        for a in _axes(self.dp):
            r = r * self.mesh.shape[a] + self.mesh.coords[a]
        return r

    def psum(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """Sum of ``x`` over the DP ranks (a new tensor; ``x`` without a
        mesh). ``x`` carries no gradient."""
        if not self.dp_split:
            return x
        out = x.detach().clone()
        self.all_reduce_([out], site)
        return out

    def all_reduce_(self, tensors: list, site: str) -> None:
        """SUM over the DP ranks in place, one call a tensor."""
        if not self.dp_split:
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
        if not self.dp_split:
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


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _CotangentLayout(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the value: a
    sharding constraint holds the cotangent too (JAX transposes
    ``with_sharding_constraint`` into one on the cotangent)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.mesh, ctx.want = x.device_mesh, want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g, None


def placements(mesh, spec) -> tuple:
    """A fitted spec as DTensor placements over ``mesh.device_mesh``: the
    tensor dim of each spec entry sharded over its mesh axes. An entry that
    is a tuple of axes shards its dim over them in the reference's order
    (the first the outermost), which must be the mesh's order; an axis no
    entry names replicates."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = _axes(ax)
        at = [mesh.axis_names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"spec entry {ax} is not in the mesh's axis order "
                             f"{mesh.axis_names}")
        for i in at:
            out[i] = Shard(dim)
    return tuple(out)
