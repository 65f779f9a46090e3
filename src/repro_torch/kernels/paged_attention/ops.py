"""K6, GQA decode attention through a block table: CUDA kernel wrapper,
plain version and registry entry (``csrc/paged_attention.cu``; port of
``repro/kernels/paged_attention``).

Layout: the port's own per-sequence page pools, read where they lie.

    q:        (B, KVH, G, hd)             G = n_heads // n_kv_heads
    k_pages:  (B, KVH, n_pool, page, hd)  sequence b's pool
    v_pages:  (B, KVH, n_pool, page, hd)
    btab:     int32 (B, pages_per_seq)    logical slot -> page of b's pool,
                                          clamped to [0, n_pool)
    lens:     int32 (B,)                  tokens to attend (positions >= len
                                          are masked; len 0 gives zeros)

The reference's TPU path transposes every layer's pools into one global
pool per decode step; the kernel reads page ``btab[b, p]`` of sequence b's
pool directly instead.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import build, registry, runtime

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64  # positions per kernel chunk (csrc/paged_attention.cu: 8 warps x kTpw)
MAX_G, MAX_HD = 16, 256  # the kernel's register and shared-memory sizing


def _check(q, k_pages, v_pages, btab, lens) -> None:
    name = "paged_attention"
    runtime.require(q.dim() == 4 and k_pages.dim() == 5, name,
                    f"need q (B, KVH, G, hd) and pages (B, KVH, n_pool, page, hd), "
                    f"got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, KVH, _, hd = q.shape
    runtime.require(k_pages.shape == v_pages.shape and k_pages.shape[:2] == (B, KVH)
                    and k_pages.shape[4] == hd and k_pages.shape[2] >= 1, name,
                    f"pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} do not "
                    f"match q {tuple(q.shape)}")
    runtime.require(k_pages.dtype == v_pages.dtype == q.dtype, name,
                    f"q, k and v must share a dtype, got {q.dtype}, {k_pages.dtype}, "
                    f"{v_pages.dtype}")
    runtime.require(btab.dtype == torch.int32 and btab.dim() == 2 and btab.shape[0] == B,
                    name, f"btab must be int32 (B, pages_per_seq), got {btab.dtype} "
                    f"{tuple(btab.shape)}")
    runtime.require(lens.dtype == torch.int32 and lens.shape == (B,), name,
                    f"lens must be int32 (B,), got {lens.dtype} {tuple(lens.shape)}")


def paged_attention_plain(q, k_pages, v_pages, btab, lens):
    """The reference's jnp path (``layers.attention_decode_paged``'s gather
    through the block table, mask, float32 softmax), on this layout."""
    _check(q, k_pages, v_pages, btab, lens)
    B, KVH, G, hd = q.shape
    n_pool, page = k_pages.shape[2], k_pages.shape[3]
    pps = btab.shape[1]
    safe = btab.clamp(0, n_pool - 1).long()
    bidx = torch.arange(B, device=q.device)[:, None]
    # advanced indices around a slice go first: (B, pps, KVH, page, hd)
    k = k_pages[bidx, :, safe].transpose(1, 2).float()
    v = v_pages[bidx, :, safe].transpose(1, 2).float()
    s = torch.einsum("bkgd,bkpsd->bkgps", q.float(), k) * hd ** -0.5
    pos = torch.arange(pps * page, device=q.device).view(pps, page)
    mask = pos < lens.view(B, 1, 1, 1, 1)
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=(3, 4), keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)  # a len-0 row: nan -> 0
    num = torch.einsum("bkgps,bkpsd->bkgd", e, v)
    den = e.sum(dim=(3, 4))
    return (num / den.clamp(min=1e-30)[..., None]).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


CTAS_PER_SM = 1  # the split plan's target (``sweep.py`` on the card)
# block-table entries one CTA's chunks may span: the kernel stages them in
# shared memory beside its three-stage ring
MAX_TAB = 1024


def _n_splits(device: torch.device, n_rows: int, capacity: int, page: int) -> int:
    """KV splits per (sequence, kv head): about CTAS_PER_SM CTAs per SM, no
    more splits than chunks of the table's capacity, and enough that one
    CTA's chunks span at most MAX_TAB table entries. The split depends on
    the card and the shapes only, never on where the pages lie."""
    n_chunks = -(-capacity // CHUNK)
    want = -(-CTAS_PER_SM * _n_sm(device.index or 0) // max(n_rows, 1))
    least = -(-n_chunks // max(1, MAX_TAB // ((CHUNK - 1) // page + 2)))
    return max(1, least, min(want, n_chunks))


_WORKSPACE: dict = {}  # (device, stream) -> (part_acc, part_ml, tickets)


def _workspace(device: torch.device, n_acc: int, n_ml: int, n_rows: int):
    """The split partials and the per-(b, kvh) tickets of one stream, grown
    when a larger call arrives. The tickets are zeroed once, here: the
    kernel leaves them at 0."""
    key = (device.index, runtime.stream())
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < n_acc or ws[1].numel() < n_ml or ws[2].numel() < n_rows:
        old = ws or (torch.empty(0), torch.empty(0), torch.empty(0))
        ws = (torch.empty(max(n_acc, old[0].numel()), dtype=torch.float32, device=device),
              torch.empty(max(n_ml, old[1].numel()), dtype=torch.float32, device=device),
              torch.zeros(max(n_rows, old[2].numel()), dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
    return ws


def paged_attention(q, k_pages, v_pages, btab, lens):
    """(B, KVH, G, hd) attention output in q's dtype; float32 inside."""
    _check(q, k_pages, v_pages, btab, lens)
    if not runtime.on_cuda(q, k_pages, v_pages, btab, lens):
        return paged_attention_plain(q, k_pages, v_pages, btab, lens)
    return _launch(q, k_pages, v_pages, btab, lens)


def _launch(q, k_pages, v_pages, btab, lens, splits: int | None = None):
    """The kernel on CUDA tensors: ``splits`` ranges per (sequence, kv head)
    (default: the plan of ``_n_splits``)."""
    B, KVH, G, hd = q.shape
    n_pool, page = k_pages.shape[2], k_pages.shape[3]
    pps = btab.shape[1]
    name = "paged_attention"
    runtime.require(q.dtype in _DTYPES, name, f"kernel takes float32 or bfloat16, got {q.dtype}")
    runtime.require(G <= MAX_G and hd <= MAX_HD and (hd * q.element_size()) % 16 == 0,
                    name, f"kernel takes G <= {MAX_G} and hd <= {MAX_HD} with 16-byte "
                    f"rows, got G={G}, hd={hd}")
    runtime.require(all(t.is_contiguous() for t in (k_pages, v_pages)), name,
                    "pages must be contiguous")
    runtime.require(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
                    name, "pages must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    q, btab, lens = q.contiguous(), btab.contiguous(), lens.contiguous()
    if q.data_ptr() % 16:  # the kernel reads q in 16-byte vectors
        q = q.clone()
    if splits is None:
        splits = _n_splits(q.device, B * KVH, pps * page, page)
    runtime.require(splits >= 1, name, f"need at least one split, got {splits}")
    part_acc, part_ml, tickets = _workspace(
        q.device, B * KVH * splits * G * hd, B * KVH * splits * G * 2, B * KVH)
    lib = build.library()
    registry.count_launch(name)
    build.check(lib.rt_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), btab.data_ptr(),
        lens.data_ptr(), out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        tickets.data_ptr(), B, KVH, G, hd, n_pool, page, pps, splits, hd ** -0.5,
        _DTYPES[q.dtype], runtime.stream()), name)
    return out


def _example(device):
    """The reference entry's example draws, with its one global pool
    (KVH, n_pages, page, hd) given to every sequence as its own pool, so
    that the block table selects the same pages in both layouts."""
    rng = np.random.default_rng(0)
    B, KVH, G, n_pages, page, hd, pages_per_seq = 4, 2, 4, 64, 16, 64, 8
    q = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    kp = rng.standard_normal((KVH, n_pages, page, hd)).astype(np.float32)
    vp = rng.standard_normal((KVH, n_pages, page, hd)).astype(np.float32)
    btab = rng.integers(0, n_pages, size=(B, pages_per_seq)).astype(np.int32)
    lens = rng.integers(1, pages_per_seq * page, size=(B,)).astype(np.int32)
    pools = [np.ascontiguousarray(np.broadcast_to(a, (B, *a.shape))) for a in (kp, vp)]
    return tuple(torch.from_numpy(a).to(device) for a in (q, *pools, btab, lens)), {}


registry.register_kernel(
    "paged_attention", kernel=paged_attention, plain=paged_attention_plain, example=_example,
    description="GQA decode attention through the block table (paged KV cache)")
