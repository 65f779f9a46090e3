"""K4, the row gather ``rows[ids]``: CUDA kernel wrapper, plain version and
registry entry (``csrc/gather_rows.cu``; port of ``gather_rows`` in
``repro/kernels/tiered_lookup``). The ``tiered_lookup`` wrapper over it
belongs to the model layer and is not ported yet."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, registry, runtime


def _check(rows: torch.Tensor, ids: torch.Tensor) -> None:
    runtime.require(rows.dim() == 2 and rows.shape[0] >= 1, "gather_rows",
                    f"need rows of shape (n_rows >= 1, d), got {tuple(rows.shape)}")
    runtime.require(ids.dtype == torch.int32, "gather_rows",
                    f"ids must be int32, got {ids.dtype}")


def gather_rows_plain(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """jnp's ``rows[ids]``: negative ids wrap once, then clamp into range."""
    _check(rows, ids)
    n = rows.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return rows[idx]


def gather_rows(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """dtype[*ids.shape, d] = rows[ids] (any dtype, any id shape)."""
    _check(rows, ids)
    if not runtime.on_cuda(rows, ids):
        return gather_rows_plain(rows, ids)
    runtime.require(rows.is_contiguous(), "gather_rows", "rows must be contiguous")
    runtime.require(ids.numel() < 2**31, "gather_rows", "too many ids")
    out = torch.empty((*ids.shape, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    if ids.numel() == 0 or rows.shape[1] == 0:
        return out
    flat = ids.reshape(-1).contiguous()
    lib = build.library()
    registry.count_launch("gather_rows")
    build.check(lib.rt_gather_rows(
        rows.data_ptr(), rows.shape[0], rows.shape[1] * rows.element_size(),
        flat.data_ptr(), flat.numel(), out.data_ptr(), runtime.stream()),
        "gather_rows")
    return out


registry.register_kernel(
    "gather_rows", kernel=gather_rows, plain=gather_rows_plain,
    description="row gather (consolidation payload copy)")
