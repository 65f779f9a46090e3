"""K2, the per-huge-page hot count: CUDA kernel wrapper, plain version and
registry entry (``csrc/hotness_scan.cu``; port of
``repro/kernels/hotness_scan``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, registry, runtime


def _check(hot: torch.Tensor, hp_ratio: int) -> None:
    runtime.require(hot.dtype in (torch.bool, torch.uint8), "hot_count",
                    f"hot bits must be bool or uint8, got {hot.dtype}")
    runtime.require(hot.dim() == 1 and hp_ratio >= 1
                    and hot.numel() % hp_ratio == 0, "hot_count",
                    f"need a 1-D input of n_hp * hp_ratio={hp_ratio}, got "
                    f"{tuple(hot.shape)}")


def hot_count_plain(hot: torch.Tensor, hp_ratio: int) -> torch.Tensor:
    _check(hot, hp_ratio)
    return hot.reshape(-1, hp_ratio).sum(dim=1, dtype=torch.int32)


def hot_count(hot: torch.Tensor, hp_ratio: int) -> torch.Tensor:
    """int32[n_hp]: the hot bits (bool/uint8[n_hp * hp_ratio]) summed per
    huge page."""
    _check(hot, hp_ratio)
    if not runtime.on_cuda(hot):
        return hot_count_plain(hot, hp_ratio)
    hot = hot.contiguous()
    n_hp = hot.numel() // hp_ratio
    out = torch.empty(n_hp, dtype=torch.int32, device=hot.device)
    if n_hp == 0:
        return out
    lib = build.library()
    registry.count_launch("hot_count")
    build.check(lib.rt_hot_count(
        hot.data_ptr(), n_hp, hp_ratio, out.data_ptr(), runtime.stream()),
        "hot_count")
    return out


def _oracle(hot_gpa, hp_ratio):
    x = np.asarray(hot_gpa).astype(np.int32)
    return x.reshape(-1, hp_ratio).sum(axis=1).astype(np.int32)


def _example(device):
    rng = np.random.default_rng(0)
    hot = rng.random(4096 * 32) < 0.1
    return (torch.from_numpy(hot).to(device), 32), {}


registry.register_kernel(
    "hot_count", kernel=hot_count, plain=hot_count_plain, oracle=_oracle, example=_example,
    description="per-huge-page hot-subpage count (scattered page filter)")
