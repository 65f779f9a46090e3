"""Shared model layers (port of ``repro.models.layers``): rmsnorm and
LayerNorm, RoPE and M-RoPE, GQA attention (training and prefill, dense and
paged decode), cross-attention against an encoder's K/V, the swiglu /
geglu / gelu MLPs, tied or untied embeddings and learned positions.

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
    p = {"scale": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=gen.device)}
    if cfg.norm == "layernorm":
        p["bias"] = _zeros(gen, cfg.d_model, cfg.dtype)
    return p


def apply_norm(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """rmsnorm or LayerNorm in float32, by the reference's formulas (the
    mean of squared deviations, ``rsqrt(var + 1e-6)``)."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-6)
        return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)
    var = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def _freqs(hd: int, theta: float, device) -> torch.Tensor:
    """theta ** (-i / (hd/2)) for i < hd/2, in float32."""
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def _rotate_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope_angles(positions: torch.Tensor, hd: int, theta: float) -> tuple:
    """positions (..., S) -> cos/sin (..., S, hd/2) in float32."""
    ang = positions.float()[..., None] * _freqs(hd, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S). Rotate-half convention."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)  # (B, S, hd/2)
    return _rotate_half(x, cos[:, :, None, :], sin[:, :, None, :])


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions3 (3, B, S); head_dim/2 is split into
    (t, h, w) sections, each rotated by its own position stream."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = _freqs(x.shape[-1], theta, x.device)
    cos_parts, sin_parts = [], []
    start = 0
    for sec, pos in zip(sections, positions3):
        ang = pos.float()[..., None] * freqs[start:start + sec]  # (B, S, sec)
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        start += sec
    cos = torch.cat(cos_parts, -1)[:, :, None, :]  # (B, S, 1, half)
    sin = torch.cat(sin_parts, -1)[:, :, None, :]
    return _rotate_half(x, cos, sin)


def rotate(cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """RoPE, or M-RoPE where the config has it; ``positions`` is (B, S), or
    (3, B, S) for M-RoPE (a (B, S) tensor there gives three equal streams,
    the text-only case)."""
    if cfg.mrope:
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
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


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as float32, never rounded to a's dtype (the reference's
    ``preferred_element_type=f32`` without the ``astype`` after it). bf16
    operands on the card go to cuBLAS with a float32 output (the
    ``out_dtype`` overloads; it sums in float32); elsewhere the float32
    product of the upcast operands, whose products of bf16 values are
    exact. ``a`` is (..., k) against ``b`` (k, n), or (E, m, k) against
    (E, k, n)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        if b.dim() == 3:
            return _MatmulF32.apply(a, b)
        out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[1])
    return torch.matmul(a.float(), b.float())


class _MatmulF32(torch.autograd.Function):
    """bf16 (m, k) @ (k, n), or batched (E, m, k) @ (E, k, n), as float32
    through cuBLAS's ``out_dtype`` overloads, with the backward of the
    reference's ``dot_general`` transpose: each cotangent is the float32
    product of the float32 output cotangent and the other operand, upcast,
    rounded once to bf16 (so the backward does not depend on whether, and
    how, a torch build differentiates the overloads)."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        mm = torch.bmm if b.dim() == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple:
        a, b = ctx.saved_tensors
        g = g.float()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return ga, gb


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


def attention_train(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (training and prefill): (B, S, d)."""
    B, S = x.shape[:2]
    q, k, v = qkv(cfg, p, x, positions)
    o = chunked_gqa_attention(q, k, v, causal=causal)
    return _proj(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"])


def attention_decode_dense(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    k_cache: torch.Tensor,  # (B, S_max, KVH, hd)
    v_cache: torch.Tensor,
    lens: torch.Tensor,  # int32 (B,) tokens already cached
):
    """One decode step against a dense contiguous KV cache, written in
    place (a position past S_max drops the write, as the reference's
    scatter does)."""
    B, S_max = x.shape[0], k_cache.shape[1]
    q, k_new, v_new = qkv(cfg, p, x, lens[:, None], rope=not cfg.encdec)
    fits = lens < S_max
    bidx = torch.arange(B, device=x.device)[fits]
    at = lens[fits].long()
    k_cache[bidx, at] = k_new[fits, 0]
    v_cache[bidx, at] = v_new[fits, 0]
    KVH, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(B, KVH, G, cfg.hd)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), k_cache.float()) * cfg.hd ** -0.5
    mask = torch.arange(S_max, device=x.device)[None] <= lens[:, None]  # the new token too
    s = torch.where(mask[:, None, None], s, float("-inf"))
    o = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), v_cache.float())
    o = o.reshape(B, 1, cfg.n_heads * cfg.hd).to(x.dtype)
    return _proj(o, p["wo"]), k_cache, v_cache


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


def init_cross_attention(cfg: ArchConfig, gen: torch.Generator) -> dict:
    return init_attention(cfg, gen)


def cross_attention(cfg: ArchConfig, p: dict, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V
    (enc_k/v: (B, F, KVH, hd))."""
    B, S, _ = x.shape
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, cfg.n_heads, cfg.hd)
    o = chunked_gqa_attention(q, enc_k, enc_v, causal=False)
    return _proj(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"])


def encoder_kv(cfg: ArchConfig, p: dict, enc_out: torch.Tensor) -> tuple:
    """Cross-attention K/V of the encoder output (B, F, d)."""
    B, F_, _ = enc_out.shape
    k = _proj(enc_out, p["wk"], p.get("bk")).reshape(B, F_, cfg.n_kv_heads, cfg.hd)
    v = _proj(enc_out, p["wv"], p.get("bv")).reshape(B, F_, cfg.n_kv_heads, cfg.hd)
    return k, v


def cross_attention_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, enc_k: torch.Tensor,
                           enc_v: torch.Tensor) -> torch.Tensor:
    """Single-token cross-attention (decode): the same math at S = 1."""
    return cross_attention(cfg, p, x, enc_k, enc_v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(cfg: ArchConfig, gen: torch.Generator, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "wi_gate": dense_init(gen, d, ff, cfg.dtype),
            "wi_up": dense_init(gen, d, ff, cfg.dtype),
            "wo": dense_init(gen, ff, d, cfg.dtype),
        }
    return {"wi": dense_init(gen, d, ff, cfg.dtype),  # plain gelu (whisper)
            "wo": dense_init(gen, ff, d, cfg.dtype)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """swiglu, geglu or gelu; the activation and the gate product in
    float32 on the projections rounded to x's dtype."""
    if cfg.activation in ("swiglu", "geglu"):
        act = F.silu if cfg.activation == "swiglu" else gelu
        h = act(_proj(x, p["wi_gate"]).float()) * _proj(x, p["wi_up"]).float()
    else:
        h = gelu(_proj(x, p["wi"]).float())
    return _proj(h.to(x.dtype), p["wo"])


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------
def _table(gen: torch.Generator, rows: int, cfg: ArchConfig) -> torch.Tensor:
    return (_randn(gen, (rows, cfg.d_model)) * 0.02).to(cfg.dtype)


def init_embedding(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """The token table; the unembedding where it is not tied; the learned
    positions of an encoder-decoder (``pos_dec``, ``pos_enc``)."""
    p = {"tok": _table(gen, cfg.vocab, cfg)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab, cfg.dtype)
    if cfg.encdec:
        p["pos_dec"] = _table(gen, cfg.max_seq, cfg)
        p["pos_enc"] = _table(gen, cfg.n_frames, cfg)
    return p


def embed(cfg: ArchConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """float32 logits through the tied table or the untied ``unembed`` (d,
    vocab): the reference's ``preferred_element_type=f32``, bf16 products
    summed in float32 and never rounded to bf16 (:func:`matmul_f32`). A
    bf16 product would round the logits to bf16 first, where argmax ties
    become likely."""
    w = p["tok"].t() if cfg.tie_embeddings else p["unembed"]
    return matmul_f32(h, w)
