"""K4, the row gather ``rows[ids]``, and ``tiered_lookup`` over it: CUDA
kernel wrapper, plain versions, numpy oracles and registry entries
(``csrc/gather_rows.cu``; port of ``gather_rows`` and ``tiered_lookup`` in
``repro/kernels/tiered_lookup``).

``tiered_lookup(rows, fused, token_ids)`` is ``rows[fused[token_ids]]``
with ``-1`` and out-of-range ids giving zero rows: ``fused`` is the
precomposed gpt∘block_table translation
(``repro_torch.core.address_space.fused_translation``). Its data movement
is K4's kernel; the translation and the masking stay in PyTorch, as in the
reference's wrapper. Its launch count counts the K4 launches it makes.
"""
from __future__ import annotations

import numpy as np
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


def _translate(fused: torch.Tensor, token_ids: torch.Tensor):
    """(valid mask, int32 physical row) of each flattened token id."""
    flat = token_ids.reshape(-1)
    valid = (flat >= 0) & (flat < fused.shape[0])
    return valid, fused[torch.where(valid, flat, 0).long()].to(torch.int32)


def _check_lookup(rows: torch.Tensor, fused: torch.Tensor, token_ids: torch.Tensor) -> None:
    runtime.require(fused.dim() == 1 and fused.shape[0] >= 1
                    and fused.dtype == torch.int32 and token_ids.dtype == torch.int32,
                    "tiered_lookup", f"need int32 fused (n_logical >= 1,) and token ids, "
                    f"got {fused.dtype} {tuple(fused.shape)} and {token_ids.dtype}")


def tiered_lookup_plain(rows: torch.Tensor, fused: torch.Tensor,
                        token_ids: torch.Tensor) -> torch.Tensor:
    _check_lookup(rows, fused, token_ids)
    valid, phys = _translate(fused, token_ids)
    out = torch.where(valid[:, None], gather_rows_plain(rows, phys), 0)
    return out.reshape(*token_ids.shape, rows.shape[1])


def tiered_lookup_kernel(rows: torch.Tensor, fused: torch.Tensor,
                         token_ids: torch.Tensor) -> torch.Tensor:
    """The wrapper: on CUDA tensors the gather is K4's kernel."""
    _check_lookup(rows, fused, token_ids)
    if not runtime.on_cuda(rows, fused, token_ids):
        return tiered_lookup_plain(rows, fused, token_ids)
    valid, phys = _translate(fused, token_ids)
    if phys.numel() and rows.shape[1]:
        registry.count_launch("tiered_lookup")
    out = torch.where(valid[:, None], gather_rows(rows, phys), 0)
    return out.reshape(*token_ids.shape, rows.shape[1])


def _gather_oracle(rows, ids):
    return np.asarray(rows)[np.asarray(ids)]


def _gather_example(device):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((16384, 8)).astype(np.float32)
    ids = rng.integers(0, 16384, size=4096).astype(np.int32)
    return (torch.from_numpy(rows).to(device), torch.from_numpy(ids).to(device)), {}


def _lookup_oracle(rows, fused, token_ids):
    rows, fused = np.asarray(rows), np.asarray(fused)
    flat = np.asarray(token_ids).reshape(-1)
    out = np.zeros((flat.shape[0], rows.shape[1]), rows.dtype)
    for i, t in enumerate(flat):
        if 0 <= t < fused.shape[0]:
            out[i] = rows[fused[t]]
    return out.reshape(*np.asarray(token_ids).shape, rows.shape[1])


def _lookup_example(device):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((8192, 8)).astype(np.float32)
    fused = rng.permutation(8192).astype(np.int32)
    tokens = rng.integers(-1, 8192, size=2048).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (rows, fused, tokens)), {}


registry.register_kernel(
    "gather_rows", kernel=gather_rows, plain=gather_rows_plain,
    oracle=_gather_oracle, example=_gather_example,
    description="row gather (consolidation payload copy)")
registry.register_kernel(
    "tiered_lookup", kernel=tiered_lookup_kernel, plain=tiered_lookup_plain,
    oracle=_lookup_oracle, example=_lookup_example,
    description="two-level translation + payload gather (fused TLB)")


def tiered_lookup(rows: torch.Tensor, fused: torch.Tensor, token_ids: torch.Tensor, *,
                  kernel_backend: str = "auto") -> torch.Tensor:
    """``rows[fused[token_ids]]`` (shape ``(*token_ids.shape, d)``) with
    ``-1`` and out-of-range ids giving zero rows."""
    return registry.dispatch("tiered_lookup", kernel_backend, rows, fused, token_ids)
