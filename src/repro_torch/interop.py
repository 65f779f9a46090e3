"""Carry a state across packages as numpy arrays.

A state travels as a dict of numpy arrays under ``TieredState``'s field
names (those of the JAX package too), with ``stats`` a nested dict of 0-d
arrays. The tests turn a JAX state into such a dict and hand it to
:func:`state_from_numpy`, so both packages start from the same state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import TieredState
from repro_torch.kernels import runtime

FIELDS = tuple(f.name for f in dataclasses.fields(TieredState))


def state_from_numpy(d: dict, device=None) -> TieredState:
    """A TieredState on ``device`` (CUDA unless named) holding copies of the
    arrays in ``d``."""
    dev = runtime.resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    kw = {k: t(d[k]) for k in FIELDS if k != "stats"}
    kw["stats"] = {k: t(v) for k, v in d["stats"].items()}
    return TieredState(**kw)


def state_to_numpy(state: TieredState) -> dict:
    """Every leaf of ``state`` as a numpy array (copied to the host)."""
    out = {k: getattr(state, k).cpu().numpy() for k in FIELDS if k != "stats"}
    out["stats"] = {k: v.cpu().numpy() for k, v in state.stats.items()}
    return out
