"""K3, the row-wise top-k with ``lax.top_k``'s tie order: CUDA kernel
wrapper, plain version and registry entry (``csrc/topk.cu``; port of
``repro/kernels/topk``)."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, registry, runtime


def _check(mat: torch.Tensor, k: int) -> None:
    runtime.require(mat.dtype == torch.int32 and mat.dim() == 2, "topk_rows",
                    f"need an int32[rows, width] matrix, got {mat.dtype} "
                    f"{tuple(mat.shape)}")
    runtime.require(0 < k <= mat.shape[1], "topk_rows",
                    f"need 0 < k <= width, got k={k}, width={mat.shape[1]}")


def topk_rows_plain(mat: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A stable descending sort: ties keep column order, lowest first."""
    _check(mat, k)
    vals, order = torch.sort(mat, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), order[:, :k].to(torch.int32)


def topk_rows(mat: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(int32[rows, k] values descending, int32[rows, k] columns, ties to
    the lowest column)."""
    _check(mat, k)
    if not runtime.on_cuda(mat):
        return topk_rows_plain(mat, k)
    rows, width = mat.shape
    vals = torch.empty((rows, k), dtype=torch.int32, device=mat.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=mat.device)
    if rows == 0:
        return vals, idx
    lib = build.library()
    max_k = lib.rt_topk_max_k()
    runtime.require(k <= max_k, "topk_rows", f"kernel takes k <= {max_k}, got {k}")
    runtime.require(width < 2**31, "topk_rows", f"width {width} >= 2^31")
    mat = mat.contiguous()
    # the kernels' scratch: the wide-row plan's histograms, row states and
    # survivors, and its zeroed counters (both empty for narrow rows)
    sizes = (ctypes.c_longlong * 2)()
    build.check(lib.rt_topk_scratch(rows, width, k, ctypes.addressof(sizes)), "topk_rows")
    scratch = torch.empty(sizes[0], dtype=torch.uint8, device=mat.device)
    zeroed = torch.zeros(sizes[1], dtype=torch.uint8, device=mat.device)
    with torch.cuda.device(mat.device):
        registry.count_launch("topk_rows")
        build.check(lib.rt_topk_rows(
            mat.data_ptr(), rows, width, k, vals.data_ptr(), idx.data_ptr(),
            scratch.data_ptr(), zeroed.data_ptr(), runtime.stream(mat.device)), "topk_rows")
    return vals, idx


def _oracle(mat, k):
    m = np.asarray(mat)
    # stable descending sort == lax.top_k tie-break (lowest index first)
    order = np.argsort(-m, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(m, order, axis=1), order.astype(np.int32)


def _example(device):
    rng = np.random.default_rng(0)
    mat = rng.integers(-1, 64, size=(64, 1024)).astype(np.int32)
    return (torch.from_numpy(mat).to(device), 128), {}


registry.register_kernel(
    "topk_rows", kernel=topk_rows, plain=topk_rows_plain, oracle=_oracle, example=_example,
    description="row-wise top-k, lax.top_k tie-break (ragged batch filter)")
