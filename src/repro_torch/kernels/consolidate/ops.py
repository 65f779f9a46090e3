"""K5a/K5b, Algorithm 1's region copies: CUDA kernel wrappers, plain
versions, numpy oracles and registry entries (``csrc/consolidate.cu``; port
of ``repro/kernels/consolidate``).

* ``consolidate_region(src_rows, ids)`` -> dtype[hp_ratio, base_elems]: row
  ``src_rows[ids[j]]`` in slot j, zeros where ``ids < 0``; ids past the end
  clamp to the last row, as jnp's gather does.
* ``scatter_region(dst_rows, region, ids)`` writes ``region[j]`` to row
  ``ids[j]`` of ``dst_rows`` **in place** and returns ``dst_rows`` (what
  ``input_output_aliases`` gives on the TPU); ids ``< 0`` or ``>= n_rows``
  are dropped, and of several slots with one destination the last wins
  (the Pallas grid's order, and the oracle's).

The kernels do the masking themselves; the TPU wrapper's padded-first sort
(a Pallas workaround so that a real write to row 0 wins) is not carried
over, only its result.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, registry, runtime


def _check_ids(name: str, n_rows: int, ids: torch.Tensor) -> None:
    runtime.require(ids.dtype == torch.int32 and ids.dim() == 1, name,
                    f"ids must be int32 (hp_ratio,), got {ids.dtype} {tuple(ids.shape)}")
    runtime.require(n_rows >= 1, name, "need at least one row")


def _check_region(src_rows: torch.Tensor, ids: torch.Tensor) -> None:
    runtime.require(src_rows.dim() == 2, "consolidate_region",
                    f"need rows of shape (n_rows, base_elems), got {tuple(src_rows.shape)}")
    _check_ids("consolidate_region", src_rows.shape[0], ids)


def _check_scatter(dst_rows: torch.Tensor, region: torch.Tensor, ids: torch.Tensor) -> None:
    name = "scatter_region"
    runtime.require(dst_rows.dim() == 2 and region.dim() == 2
                    and region.shape[1] == dst_rows.shape[1]
                    and region.shape[0] == ids.shape[0], name,
                    f"need dst (n_rows, e), region (hp_ratio, e) and ids (hp_ratio,), got "
                    f"{tuple(dst_rows.shape)}, {tuple(region.shape)}, {tuple(ids.shape)}")
    runtime.require(region.dtype == dst_rows.dtype, name,
                    f"region {region.dtype} and dst {dst_rows.dtype} differ")
    _check_ids(name, dst_rows.shape[0], ids)


def consolidate_region_plain(src_rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    _check_region(src_rows, ids)
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long().clamp(max=src_rows.shape[0] - 1)
    return torch.where(valid[:, None], src_rows[safe], 0)


def _winners(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """bool[hp_ratio]: the slots that write, in range and not overridden by
    a later slot with the same destination."""
    later = torch.ones((ids.shape[0],) * 2, dtype=torch.bool, device=ids.device).triu(1)
    overridden = ((ids[:, None] == ids[None, :]) & later).any(dim=1)
    return (ids >= 0) & (ids < n_rows) & ~overridden


def scatter_region_plain(dst_rows: torch.Tensor, region: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
    _check_scatter(dst_rows, region, ids)
    keep = _winners(ids, dst_rows.shape[0])
    dst_rows[ids[keep].long()] = region[keep]  # distinct destinations
    return dst_rows


def consolidate_gather(src_rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The K5a wrapper: launches ``consolidate_gather`` on CUDA tensors."""
    _check_region(src_rows, ids)
    if not runtime.on_cuda(src_rows, ids):
        return consolidate_region_plain(src_rows, ids)
    name = "consolidate_region"
    runtime.require(src_rows.is_contiguous(), name, "rows must be contiguous")
    out = torch.empty((ids.shape[0], src_rows.shape[1]), dtype=src_rows.dtype,
                      device=src_rows.device)
    if out.numel() == 0:
        return out
    ids = ids.contiguous()
    lib = build.library()
    registry.count_launch(name)
    build.check(lib.rt_consolidate_gather(
        src_rows.data_ptr(), src_rows.shape[0], src_rows.shape[1] * src_rows.element_size(),
        ids.data_ptr(), ids.shape[0], out.data_ptr(), runtime.stream()), name)
    return out


def consolidate_scatter(dst_rows: torch.Tensor, region: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """The K5b wrapper: launches ``consolidate_scatter`` on CUDA tensors,
    writing ``dst_rows`` in place."""
    _check_scatter(dst_rows, region, ids)
    if not runtime.on_cuda(dst_rows, region, ids):
        return scatter_region_plain(dst_rows, region, ids)
    name = "scatter_region"
    runtime.require(dst_rows.is_contiguous(), name, "dst rows must be contiguous")
    if ids.shape[0] == 0 or dst_rows.shape[1] == 0:
        return dst_rows
    region, ids = region.contiguous(), ids.contiguous()
    lib = build.library()
    registry.count_launch(name)
    build.check(lib.rt_consolidate_scatter(
        dst_rows.data_ptr(), dst_rows.shape[0], dst_rows.shape[1] * dst_rows.element_size(),
        region.data_ptr(), ids.data_ptr(), ids.shape[0], runtime.stream()), name)
    return dst_rows


def _region_oracle(src_rows, ids):
    src, ids = np.asarray(src_rows), np.asarray(ids)
    out = np.zeros((ids.shape[0], src.shape[1]), src.dtype)
    for slot, i in enumerate(ids):
        if i >= 0:
            out[slot] = src[i]
    return out


def _scatter_oracle(dst_rows, region, ids):
    out = np.asarray(dst_rows).copy()
    for slot, i in enumerate(np.asarray(ids)):
        if 0 <= i < out.shape[0]:
            out[i] = np.asarray(region)[slot]
    return out


def _region_example(device):
    rng = np.random.default_rng(0)
    src = rng.standard_normal((8192, 8)).astype(np.float32)
    ids = rng.integers(-1, 8192, size=512).astype(np.int32)
    return (torch.from_numpy(src).to(device), torch.from_numpy(ids).to(device)), {}


def _scatter_example(device):
    rng = np.random.default_rng(0)
    dst = rng.standard_normal((8192, 8)).astype(np.float32)
    region = rng.standard_normal((512, 8)).astype(np.float32)
    ids = rng.permutation(8192)[:512].astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (dst, region, ids)), {}


registry.register_kernel(
    "consolidate_region", kernel=consolidate_gather, plain=consolidate_region_plain,
    oracle=_region_oracle, example=_region_example,
    description="dense region gather for Algorithm-1 consolidation")
registry.register_kernel(
    "scatter_region", kernel=consolidate_scatter, plain=scatter_region_plain,
    oracle=_scatter_oracle, example=_scatter_example,
    description="region write-back scatter in place (padded ids dropped, last slot wins)")


def consolidate_region(src_rows: torch.Tensor, ids: torch.Tensor, *,
                       kernel_backend: str = "auto") -> torch.Tensor:
    """dtype[hp_ratio, base_elems]: the dense region payload, zeros at
    padded (``-1``) slots."""
    return registry.dispatch("consolidate_region", kernel_backend, src_rows, ids)


def scatter_region(dst_rows: torch.Tensor, region: torch.Tensor, ids: torch.Tensor, *,
                   kernel_backend: str = "auto") -> torch.Tensor:
    """Write the region's rows to ``dst_rows[ids]`` in place (ids ``< 0`` or
    past the end dropped, the last of duplicate slots winning); returns
    ``dst_rows``."""
    return registry.dispatch("scatter_region", kernel_backend, dst_rows, region, ids)
