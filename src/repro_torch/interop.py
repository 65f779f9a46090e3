"""Carry a state, a churn carry, a model's params or a decode cache across
packages as numpy arrays.

A state travels as a dict of numpy arrays under ``TieredState``'s field
names (those of the JAX package too), with ``stats`` a nested dict of 0-d
arrays; a churn carry as a dict under ``ChurnState``'s field names, its
``state`` such a dict. Params and caches travel as the nested dicts the JAX package uses
(``groups/layer0/attn/wq``, ``layers/layer0/k_pages``, ``btab``, ``lens``),
with numpy leaves; a bfloat16 leaf may be an ``ml_dtypes`` bfloat16 array.
The tests hand such trees to :func:`state_from_numpy`,
:func:`params_from_numpy` and :func:`cache_from_numpy`, so that both
packages compute from the same data.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import TieredState
from repro_torch.kernels import runtime

FIELDS = tuple(f.name for f in dataclasses.fields(TieredState))


def _to_torch(tree, dev: torch.device):
    """A copy of a numpy leaf, or of every leaf of a nested dict, on dev."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev) for k, v in tree.items()}
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def state_from_numpy(d: dict, device=None) -> TieredState:
    """A TieredState on ``device`` (CUDA unless named) holding copies of the
    arrays in ``d``."""
    dev = runtime.resolve_device(device)
    kw = {k: _to_torch(d[k], dev) for k in FIELDS if k != "stats"}
    kw["stats"] = _to_torch(d["stats"], dev)
    return TieredState(**kw)


def state_to_numpy(state: TieredState) -> dict:
    """Every leaf of ``state`` as a numpy array (copied to the host)."""
    out = {k: getattr(state, k).cpu().numpy() for k in FIELDS if k != "stats"}
    out["stats"] = {k: v.cpu().numpy() for k, v in state.stats.items()}
    return out


CHURN_FIELDS = ("active", "window", "near_cap", "pressure", "engaged")


def churn_from_numpy(d: dict, device=None):
    """A ``ChurnState`` on ``device`` (CUDA unless named) holding copies of
    the arrays in ``d``."""
    from repro_torch.core.engine import ChurnState

    dev = runtime.resolve_device(device)
    return ChurnState(state=state_from_numpy(d["state"], dev),
                      **{k: _to_torch(d[k], dev) for k in CHURN_FIELDS})


def churn_to_numpy(cs) -> dict:
    """Every leaf of a ``ChurnState`` as a numpy array (copied to the
    host)."""
    out = {k: getattr(cs, k).cpu().numpy() for k in CHURN_FIELDS}
    out["state"] = state_to_numpy(cs.state)
    return out


def params_from_numpy(tree: dict, device=None) -> dict:
    """A model's params, or a decode cache (:func:`cache_from_numpy`), on
    ``device`` (CUDA unless named), copied from a nested dict of numpy
    arrays."""
    return _to_torch(tree, runtime.resolve_device(device))


cache_from_numpy = params_from_numpy


def cache_to_numpy(cache: dict) -> dict:
    """Every leaf of a decode cache as a numpy copy on the host (the port
    writes its cache in place); bfloat16 leaves come back as float32
    (exact)."""
    if isinstance(cache, dict):
        return {k: cache_to_numpy(v) for k, v in cache.items()}
    t = cache.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
