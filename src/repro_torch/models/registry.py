"""Model registry: ``build(config)`` -> a :class:`Model` handle with init /
prefill / decode / init_cache (port of ``repro.models.registry``; the
dry-run input specs and the training loss are not ported).

Building a model pins the matmul numerics (``layers.matmul_numerics``:
no TF32, float32 reductions of bf16 products).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import configs as config_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import runtime
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable  # (seed=0, device=None) -> params
    prefill: Callable  # (params, batch, max_seq=None, n_pool=None) -> (logits, cache)
    decode: Callable  # (params, cache, tokens, kernel_backend="auto") -> (logits, cache)
    init_cache: Callable  # (batch, max_seq, n_pool=None, device=None) -> cache


def _init(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random params from ``torch.Generator(device).manual_seed(seed)`` on
    ``device`` (CUDA unless named)."""
    dev = runtime.resolve_device(device)
    return T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))


def build(cfg: ArchConfig | str) -> Model:
    if isinstance(cfg, str):
        cfg = config_lib.get(cfg)
    L.matmul_numerics()
    return Model(
        cfg=cfg,
        init=lambda seed=0, device=None: _init(cfg, seed, device),
        prefill=lambda params, batch, max_seq=None, n_pool=None:
            T.prefill(cfg, params, batch, max_seq, n_pool),
        decode=lambda params, cache, tokens, kernel_backend="auto":
            T.decode_step(cfg, params, cache, tokens, kernel_backend),
        init_cache=lambda batch, max_seq, n_pool=None, device=None:
            T.init_cache(cfg, batch, max_seq, n_pool, device),
    )
