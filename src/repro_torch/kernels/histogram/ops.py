"""K1, the weighted int32 bincount: CUDA kernel wrapper, plain version and
registry entry (``csrc/histogram.cu``; port of
``repro/kernels/histogram``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, registry, runtime


def _check(ids: torch.Tensor, weights: torch.Tensor, n_bins: int) -> None:
    runtime.require(ids.dtype == torch.int32 and weights.dtype == torch.int32,
                    "bincount", f"ids and weights must be int32, got "
                    f"{ids.dtype}/{weights.dtype}")
    runtime.require(ids.shape == weights.shape, "bincount",
                    f"shape mismatch {tuple(ids.shape)} vs {tuple(weights.shape)}")
    runtime.require(0 < n_bins < 2**31, "bincount", f"bad n_bins {n_bins}")


def bincount_plain(ids: torch.Tensor, weights: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int32[n_bins]: negative ids wrap once (``.at[].add`` semantics), ids
    still out of range land in a dropped extra bin."""
    _check(ids, weights, n_bins)
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + n_bins, flat)
    flat = torch.where((flat >= 0) & (flat < n_bins), flat, n_bins)
    out = torch.zeros(n_bins + 1, dtype=torch.int32, device=ids.device)
    out.index_add_(0, flat, weights.reshape(-1))
    return out[:n_bins]


def bincount(ids: torch.Tensor, weights: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int32[n_bins] weighted histogram of ``ids`` (any shape, int32)."""
    _check(ids, weights, n_bins)
    if not runtime.on_cuda(ids, weights):
        return bincount_plain(ids, weights, n_bins)
    ids = ids.reshape(-1).contiguous()
    weights = weights.reshape(-1).contiguous()
    out = torch.zeros(n_bins, dtype=torch.int32, device=ids.device)
    if ids.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(ids.device):
        registry.count_launch("bincount")
        build.check(lib.rt_bincount(
            ids.data_ptr(), weights.data_ptr(), ids.numel(), n_bins,
            out.data_ptr(), runtime.stream(ids.device)), "bincount")
    return out


def _oracle(ids, weights, n_bins):
    out = np.zeros(n_bins, np.int64)
    for i, w in zip(np.asarray(ids).reshape(-1), np.asarray(weights).reshape(-1)):
        i = i + n_bins if i < 0 else i
        if 0 <= i < n_bins:
            out[i] += int(w)
    return out.astype(np.int32)


def _example(device):
    rng = np.random.default_rng(0)
    n_bins = 4096
    ids = rng.integers(0, n_bins, size=16384).astype(np.int32)
    w = rng.integers(0, 8, size=16384).astype(np.int32)
    return (torch.from_numpy(ids).to(device), torch.from_numpy(w).to(device), n_bins), {}


registry.register_kernel(
    "bincount", kernel=bincount, plain=bincount_plain, oracle=_oracle, example=_example,
    description="weighted bincount (per-window access/host histograms)")
