"""Model registry: ``build(config)`` -> a :class:`Model` handle with init /
loss / prefill / decode / init_cache for every arch, and the shape-and-dtype
records of every input of a shape cell (port of ``repro.models.registry``).

Building a model pins the matmul numerics (``layers.matmul_numerics``:
no TF32, float32 reductions of bf16 products).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import configs as config_lib
from repro_torch.configs.base import SHAPE_SPECS, ArchConfig
from repro_torch.kernels import runtime
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.dist import NO_DIST


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable  # (seed=0, device=None) -> params
    loss_fn: Callable  # (params, batch, dist=NO_DIST) -> (loss, {"ce", "aux"})
    prefill: Callable  # (params, batch, max_seq=None, n_pool=None) -> (logits, cache)
    decode: Callable  # (params, cache, tokens, kernel_backend="auto") -> (logits, cache)
    init_cache: Callable  # (batch, max_seq, n_pool=None, device=None) -> cache


def _init(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random params from ``torch.Generator(device).manual_seed(seed)`` on
    ``device`` (CUDA unless named)."""
    dev = runtime.resolve_device(device)
    return T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))


class _MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the ``meta`` device: the init's
    tree of shapes and dtypes, nothing allocated or drawn."""

    device = torch.device("meta")


def param_shapes(cfg: ArchConfig) -> dict:
    """The params' tree as ``model.init`` builds it, on the ``meta`` device
    (the reference's ``jax.eval_shape`` of its init)."""
    return T.init_params(cfg, _MetaGenerator())


def build(cfg: ArchConfig | str) -> Model:
    if isinstance(cfg, str):
        cfg = config_lib.get(cfg)
    L.matmul_numerics()
    return Model(
        cfg=cfg,
        init=lambda seed=0, device=None: _init(cfg, seed, device),
        loss_fn=lambda params, batch, dist=NO_DIST: T.loss_fn(cfg, params, batch, dist),
        prefill=lambda params, batch, max_seq=None, n_pool=None:
            T.prefill(cfg, params, batch, max_seq, n_pool),
        decode=lambda params, cache, tokens, kernel_backend="auto":
            T.decode_step(cfg, params, cache, tokens, kernel_backend),
        init_cache=lambda batch, max_seq, n_pool=None, device=None:
            T.init_cache(cfg, batch, max_seq, n_pool, device),
    )


# ---------------------------------------------------------------------------
# input specs: shapes and dtypes only, nothing allocated
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Spec:
    """A tensor's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def batch_specs(cfg: ArchConfig, B: int, S: int) -> dict:
    """The training / prefill batch: tokens, labels, M-RoPE positions and
    an encoder-decoder's frames where the config has them."""
    batch = {"tokens": Spec((B, S), torch.int32), "labels": Spec((B, S), torch.int32)}
    if cfg.mrope:
        batch["positions"] = Spec((3, B, S), torch.int32)
    if cfg.encdec:
        batch["frames"] = Spec((B, cfg.n_frames, cfg.d_model), cfg.dtype)
    return batch


def _specs(tree: dict) -> dict:
    return {k: _specs(v) if isinstance(v, dict) else Spec(tuple(v.shape), v.dtype)
            for k, v in tree.items()}


def cache_specs(cfg: ArchConfig, B: int, max_seq: int) -> dict:
    """The decode cache's tree, as ``transformer.init_cache`` builds it
    (on the ``meta`` device: no memory)."""
    return _specs(T.init_cache(cfg, B, max_seq, device="meta"))


def input_specs(cfg: ArchConfig, shape_name: str) -> dict:
    """Every input of the cell's step function: train -> the loss's batch;
    prefill -> prefill's batch; decode -> the cache and one token a
    sequence."""
    spec = SHAPE_SPECS[shape_name]
    B, S = spec["global_batch"], spec["seq_len"]
    if spec["kind"] == "train":
        return {"batch": batch_specs(cfg, B, S)}
    if spec["kind"] == "prefill":
        batch = batch_specs(cfg, B, S)
        batch.pop("labels")
        return {"batch": batch}
    return {"cache": cache_specs(cfg, B, S), "tokens": Spec((B, 1), torch.int32)}
