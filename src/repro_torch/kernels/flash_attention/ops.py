"""K7, GQA attention (causal or not): CUDA kernel wrapper, plain version and
registry entry (``csrc/flash_attention.cu``; port of
``repro/kernels/flash_attention``, as its ``gqa_attention`` calls it).

    q: (B, H, S, hd)   k, v: (B, KVH, Sk, hd)   H = KVH * G

Query head ``kvh * G + g`` at position ``s`` attends to keys ``k_pos <= s``
(causal) or to all of them, with scale ``hd ** -0.5``, the softmax in
float32 and the output in q's dtype: what the reference's
``flash_attention_ref`` computes after its fold. The kernel reads q, k and v
in this layout and maps each query head to its kv head; there is no copy of
the fold. ``block_q`` and ``block_k`` are accepted for the reference's
signature and change nothing, as in its ``_gqa_ref``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, registry, runtime

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 256  # csrc/flash_attention.cu: the largest head the kernels hold
CHUNK_SCORES = 1 << 26  # float32 scores per chunk of the plain version (256 MB)


def _check(q, k, v) -> None:
    name = "gqa_attention"
    runtime.require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape, name,
                    f"need q (B, H, S, hd) and k, v (B, KVH, Sk, hd), got "
                    f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    runtime.require(k.shape[0] == B and k.shape[3] == hd and k.shape[1] >= 1
                    and H % k.shape[1] == 0, name,
                    f"k {tuple(k.shape)} does not match q {tuple(q.shape)} "
                    "(H must be a multiple of KVH)")
    runtime.require(q.dtype == k.dtype == v.dtype and q.dtype.is_floating_point, name,
                    f"q, k and v must share a float dtype, got {q.dtype}, {k.dtype}, "
                    f"{v.dtype}")


def gqa_attention_plain(q, k, v, causal=True, block_q=128, block_k=128):
    """The reference's math in float32, a chunk of query positions at a
    time so that the scores of a 2,048-token batch fit."""
    _check(q, k, v)
    B, H, S, hd = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = H // KVH
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    step = max(1, CHUNK_SCORES // max(1, B * H * Sk))
    k_pos = torch.arange(Sk, device=q.device)
    for s0 in range(0, S, step):
        s1 = min(S, s0 + step)
        qc = q[:, :, s0:s1].float().reshape(B, KVH, G, s1 - s0, hd)
        s = torch.einsum("bkgqd,bksd->bkgqs", qc, kf) * scale
        if causal:
            q_pos = torch.arange(s0, s1, device=q.device)
            s = s.masked_fill(k_pos[None, :] > q_pos[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
        out[:, :, s0:s1] = o.reshape(B, H, s1 - s0, hd).to(q.dtype)
    return out


def flash_attention(q, k, v, causal=True, block_q=128, block_k=128):
    """The K7 wrapper: (B, H, S, hd) in q's dtype; on CUDA tensors launches
    ``flash_attn_bf16`` (tensor cores) for bf16 and ``flash_attn_fwd``
    (float32 FMAs) for float32."""
    _check(q, k, v)
    if not runtime.on_cuda(q, k, v):
        return gqa_attention_plain(q, k, v, causal, block_q, block_k)
    name = "gqa_attention"
    B, H, S, hd = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    runtime.require(q.dtype in _DTYPES, name,
                    f"kernel takes float32 or bfloat16, got {q.dtype}")
    runtime.require(hd % 8 == 0 and 8 <= hd <= MAX_HD, name,
                    f"kernel takes hd a multiple of 8 up to {MAX_HD}, got {hd}")
    runtime.require(B < 65536 and KVH < 65536, name, f"B={B} or KVH={KVH} >= 65,536")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    runtime.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), name,
                    "q, k and v must be 16-byte aligned")
    lib = build.library()
    with torch.cuda.device(q.device):
        registry.count_launch(name)
        build.check(lib.rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KVH, S, Sk, hd,
            int(causal), hd ** -0.5, _DTYPES[q.dtype], runtime.stream(q.device)), name)
    return out


def _example(device):
    rng = np.random.default_rng(0)
    B, H, KVH, S, hd = 2, 8, 2, 256, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
               for shape in ((B, H, S, hd), (B, KVH, S, hd), (B, KVH, S, hd)))
    return (q, k, v), dict(causal=True)


registry.register_kernel(
    "gqa_attention", kernel=flash_attention, plain=gqa_attention_plain, example=_example,
    description="GQA flash attention (one K/V copy per kv head, no fold copy)")


def gqa_attention(q, k, v, causal=True, block_q=128, block_k=128, *,
                  kernel_backend="auto"):
    """(B, H, S, hd) attention of q (B, H, S, hd) over k, v (B, KVH, Sk, hd)."""
    return registry.dispatch("gqa_attention", kernel_backend, q, k, v,
                             causal=causal, block_q=block_q, block_k=block_k)
