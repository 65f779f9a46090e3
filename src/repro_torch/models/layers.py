"""Model layers of the dense family: rmsnorm, RoPE, GQA attention (prefill
and paged decode), the swiglu MLP, tied embeddings (port of the parts of
``repro.models.layers`` that qwen2-0.5b runs; ``transformer`` refuses
configs that need the others).

Params are nested dicts of tensors under the reference's key names. Numerics
follow the reference: params in ``cfg.dtype``, norms and softmax in float32,
and every projection accumulates in float32 before it rounds once to the
activation dtype (:func:`_proj`). :func:`matmul_numerics` pins the
backend flags that this needs on the card.

:func:`attention_decode_paged` writes the new token's K/V into the page pools
it is handed, in place, where the reference rebuilds the arrays.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import registry as kernels


def matmul_numerics() -> None:
    """Pin the matmul numerics the reference has: float32 products in full
    float32 (no TF32 in cuBLAS or cuDNN), and bf16 products reduced in
    float32 (no reduced-precision split-K reductions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# ---------------------------------------------------------------------------
# init helpers (random init from a torch.Generator; the device is its device)
# ---------------------------------------------------------------------------
def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype) -> torch.Tensor:
    return (_randn(gen, (in_dim, out_dim)) * in_dim ** -0.5).to(dtype)


def _zeros(gen: torch.Generator, n: int, dtype) -> torch.Tensor:
    return torch.zeros((n,), dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(cfg: ArchConfig, gen: torch.Generator) -> dict:
    return {"scale": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=gen.device)}


def apply_norm(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """rmsnorm in float32."""
    xf = x.float()
    var = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def _rope_angles(positions: torch.Tensor, hd: int, theta: float) -> tuple:
    """positions (..., S) -> cos/sin (..., S, hd/2) in float32."""
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S). Rotate-half convention."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)  # (B, S, hd/2)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rotate(cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.mrope:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported to PyTorch yet (ROADMAP queue 1, item 15)")
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def init_attention(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, hd, H, KVH = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, d, H * hd, cfg.dtype),
        "wk": dense_init(gen, d, KVH * hd, cfg.dtype),
        "wv": dense_init(gen, d, KVH * hd, cfg.dtype),
        "wo": dense_init(gen, H * hd, d, cfg.dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, H * hd, cfg.dtype)
        p["bk"] = _zeros(gen, KVH * hd, cfg.dtype)
        p["bv"] = _zeros(gen, KVH * hd, cfg.dtype)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w, accumulated in float32 and rounded once to x's dtype (the
    reference's ``preferred_element_type=f32`` then ``astype``): cuBLAS
    accumulates a bf16 product in float32 when :func:`matmul_numerics` is
    set; a float32 product is float32 throughout."""
    out = torch.matmul(x, w)
    if b is not None:
        out = out + b
    return out


def qkv(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, rope=True):
    """x (B, S, d) -> q (B,S,H,hd), k/v (B,S,KVH,hd), rotated."""
    B, S, _ = x.shape
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, cfg.n_heads, cfg.hd)
    k = _proj(x, p["wk"], p.get("bk")).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = _proj(x, p["wv"], p.get("bv")).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if rope:
        q = rotate(cfg, q, positions)
        k = rotate(cfg, k, positions)
    return q, k, v


def chunked_gqa_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, Sk, KVH, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Attention over query chunks, so that the score memory is
    (B, H, q_chunk, Sk) float32 at most. Plain PyTorch, as in the reference,
    where it is jnp outside any Pallas kernel (its scanned path: float32
    scores and softmax, output in q's dtype)."""
    B, S, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = hd ** -0.5
    q_chunk = min(q_chunk, S)
    n_chunks = -(-S // q_chunk)
    kq = k.transpose(1, 2).float()  # (B, KVH, Sk, hd)
    vq = v.transpose(1, 2).float()
    k_pos = kv_offset + torch.arange(Sk, device=q.device)
    outs = []
    for ci in range(n_chunks):
        qb = q[:, ci * q_chunk:(ci + 1) * q_chunk]
        n = qb.shape[1]
        if n < q_chunk:  # the reference pads the last chunk
            qb = F.pad(qb, (0, 0, 0, 0, 0, q_chunk - n))
        qb = qb.reshape(B, q_chunk, KVH, G, hd).permute(0, 2, 3, 1, 4)
        s = torch.einsum("bkgqd,bksd->bkgqs", qb.float(), kq) * scale
        if causal:
            q_pos = ci * q_chunk + torch.arange(q_chunk, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask, s, float("-inf"))
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bksd->bkgqd", pr, vq)
        o = o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, hd).to(q.dtype)
        outs.append(o[:, :n])
    return torch.cat(outs, dim=1)


def attention_decode_paged(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    k_pages: torch.Tensor,  # (B, KVH, n_pool, page, hd) per-sequence page pool
    v_pages: torch.Tensor,
    btab: torch.Tensor,  # int32 (B, pages_per_seq) logical slot -> pool page
    lens: torch.Tensor,  # int32 (B,)
    kernel_backend: str = "auto",
):
    """One decode step through the paged KV cache: the new token's K/V go,
    in place, into the page that the block table assigns to slot
    ``lens // page``; attention reads K/V through the block table (the
    paged_attention kernel, on the per-sequence pools as they are)."""
    B = x.shape[0]
    page = cfg.page_size
    pps = btab.shape[1]
    q, k_new, v_new = qkv(cfg, p, x, lens[:, None], rope=not cfg.encdec)
    slot = (lens // page).long()
    # a slot past the table drops the write, as the reference's filled
    # gather and dropping scatter do: rewrite the row it already holds
    fits = (slot < pps)[:, None, None]
    phys = torch.gather(btab, 1, slot.clamp(max=pps - 1)[:, None])[:, 0].long()
    off = (lens % page).long()
    bidx = torch.arange(B, device=x.device)
    # advanced indices around a slice go first: (B, KVH, hd), as k_new[:, 0]
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        pages[bidx, :, phys, off] = torch.where(fits, new[:, 0], pages[bidx, :, phys, off])
    KVH, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(B, KVH, G, cfg.hd)
    o = kernels.dispatch("paged_attention", kernel_backend,
                         qh, k_pages, v_pages, btab, lens + 1)
    o = o.reshape(B, 1, cfg.n_heads * cfg.hd).to(x.dtype)
    return _proj(o, p["wo"]), k_pages, v_pages


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": dense_init(gen, d, ff, cfg.dtype),
        "wi_up": dense_init(gen, d, ff, cfg.dtype),
        "wo": dense_init(gen, ff, d, cfg.dtype),
    }


def apply_mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """swiglu, the gate and the product in float32."""
    h = F.silu(_proj(x, p["wi_gate"]).float()) * _proj(x, p["wi_up"]).float()
    return _proj(h.to(x.dtype), p["wo"])


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------
def init_embedding(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """The token table, tied to the unembedding."""
    return {"tok": (_randn(gen, (cfg.vocab, cfg.d_model)) * 0.02).to(cfg.dtype)}


def embed(cfg: ArchConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """float32 logits (the reference's ``preferred_element_type=f32``: bf16
    products summed in float32, never rounded to bf16). The port upcasts h
    and the (tied) table to float32 and multiplies in float32, without TF32.
    For qwen2-0.5b's 151,936 x 896 table that is a float32 copy of 545 MB
    per call: 272 MB read and 545 MB written, then read again by the
    product, about 0.4 ms of HBM time at 3.35 TB/s. A bf16 product would
    round the logits to bf16 first, where argmax ties become likely."""
    return torch.matmul(h.float(), p["tok"].t().float())
