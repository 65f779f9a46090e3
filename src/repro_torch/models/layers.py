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
from repro_torch.models.dist import NO_DIST, Dist


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
    exact. ``a`` is (..., k) against ``b`` (k, n), or (*batch, m, k)
    against (*batch, k, n) with the same batch dims."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        if b.dim() >= 3:
            batch = b.shape[:-2]
            out = _MatmulF32.apply(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]))
            return out.reshape(*batch, *out.shape[-2:])
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


def kv_axis(cfg: ArchConfig, dist: Dist):
    """The mesh axis that splits the KV heads (the model axis where their
    count divides by it, else None: replicated)."""
    return dist.tp if cfg.n_kv_heads % dist.axis_size(dist.tp) == 0 else None


def _heads(cfg: ArchConfig, p: dict, x: torch.Tensor, which: str, n: int,
           dist: Dist = NO_DIST) -> torch.Tensor:
    """x (B, S, d) projected by ``w{which}`` (+ ``b{which}``) and split into
    n heads (B, S, n, hd). Under a global-view mesh the projection is laid
    out before the split with whole heads to a shard, or its heads
    replicated where n does not divide by the model axis (DTensor refuses
    the uneven split that XLA reshards by itself)."""
    B, S, _ = x.shape
    y = _proj(x, p["w" + which], p.get("b" + which))
    y = dist.constrain(y, dist.dp, None, dist.tp if n % dist.axis_size(dist.tp) == 0 else None)
    return y.reshape(B, S, n, cfg.hd)


def qkv(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, rope=True,
        dist: Dist = NO_DIST):
    """x (B, S, d) -> q (B,S,H,hd), k/v (B,S,KVH,hd), rotated (heads split
    by :func:`_heads`)."""
    q = _heads(cfg, p, x, "q", cfg.n_heads, dist)
    k = _heads(cfg, p, x, "k", cfg.n_kv_heads, dist)
    v = _heads(cfg, p, x, "v", cfg.n_kv_heads, dist)
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
    unroll: bool = False,
    causal_skip: bool = False,
) -> torch.Tensor:
    """Attention over query chunks, so that the score memory is
    (B, H, q_chunk, Sk) float32 at most. Plain PyTorch, as in the reference,
    where it is jnp outside any Pallas kernel.

    The default is the reference's scanned path: float32 scores and
    softmax, output in q's dtype. ``unroll`` is its unrolled path, whose
    numerics differ (:func:`_unrolled_chunk`); ``causal_skip`` there (causal,
    ``kv_offset == 0``) lets query chunk i read K/V up to (i+1) * q_chunk
    only. The chunks are a Python loop either way."""
    B, S, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    q_chunk = min(q_chunk, S)
    n_chunks = -(-S // q_chunk)
    kq, vq = k.transpose(1, 2), v.transpose(1, 2)  # (B, KVH, Sk, hd)
    if not unroll:
        kq, vq = kq.float(), vq.float()
    k_pos = kv_offset + torch.arange(Sk, device=q.device)
    outs = []
    for ci in range(n_chunks):
        qb = q[:, ci * q_chunk:(ci + 1) * q_chunk]
        n = qb.shape[1]
        if n < q_chunk:  # the reference pads the last chunk
            qb = F.pad(qb, (0, 0, 0, 0, 0, q_chunk - n))
        qb = qb.reshape(B, q_chunk, KVH, G, hd).permute(0, 2, 3, 1, 4)
        q_pos = ci * q_chunk + torch.arange(q_chunk, device=q.device)
        if unroll:
            hi = min((ci + 1) * q_chunk, Sk) if causal and causal_skip and kv_offset == 0 else Sk
            o = _unrolled_chunk(qb, kq[:, :, :hi], vq[:, :, :hi], k_pos[:hi], q_pos, causal)
        else:
            s = torch.einsum("bkgqd,bksd->bkgqs", qb.float(), kq) * hd ** -0.5
            if causal:
                s = torch.where(k_pos[None, :] <= q_pos[:, None], s, float("-inf"))
            o = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, dim=-1), vq)
        o = o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, hd).to(q.dtype)
        outs.append(o[:, :n])
    return torch.cat(outs, dim=1)


def _unrolled_chunk(qb: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                    k_pos: torch.Tensor, q_pos: torch.Tensor, causal: bool) -> torch.Tensor:
    """One query chunk of the reference's unrolled path, rounding for
    rounding: the scores summed in float32 from the model-dtype operands,
    stored in the model dtype and scaled there; the mask's -inf in that
    dtype; the softmax in float32, its weights stored in the model dtype;
    the PV product summed in float32. ``qb`` (B, KVH, G, q, hd), ``kq`` /
    ``vq`` (B, KVH, s, hd) -> float32 (B, KVH, G, q, hd)."""
    B, KVH, G, q, hd = qb.shape
    dt = qb.dtype
    s = matmul_f32(qb.reshape(B, KVH, G * q, hd), kq.transpose(-1, -2)).to(dt)
    s = s.reshape(B, KVH, G, q, -1) * torch.tensor(hd ** -0.5, dtype=dt, device=s.device)
    if causal:
        s = torch.where(k_pos[None, :] <= q_pos[:, None], s,
                        torch.tensor(float("-inf"), dtype=dt, device=s.device))
    p = torch.softmax(s.float(), dim=-1).to(dt)
    return matmul_f32(p.reshape(B, KVH, G * q, -1), vq).reshape(B, KVH, G, q, hd)


def attention_train(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (training and prefill): (B, S, d)."""
    B, S = x.shape[:2]
    q, k, v = qkv(cfg, p, x, positions)
    o = chunked_gqa_attention(q, k, v, causal=causal, unroll=cfg.unroll)
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
    dist: Dist = NO_DIST,
):
    """One decode step through the paged KV cache: the new token's K/V go,
    in place, into the page that the block table assigns to slot
    ``lens // page``; attention reads K/V through the block table (the
    paged_attention kernel, on the per-sequence pools as they are). Under a
    global-view mesh the write runs on each rank's shard of the pools and
    the attention on each rank's sequences and KV heads, with whole pages
    (``Dist.local``)."""
    B = x.shape[0]
    page = cfg.page_size
    pps = btab.shape[1]
    q, k_new, v_new = qkv(cfg, p, x, lens[:, None], rope=not cfg.encdec, dist=dist)
    KVH, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    slot = (lens // page).long()
    phys = torch.gather(btab, 1, slot.clamp(max=pps - 1)[:, None])[:, 0].long()
    # a slot past the table drops the write (row -1 matches none), as the
    # reference's filled gather and dropping scatter do
    off = torch.where(slot < pps, (lens % page).long(), -1)
    dp, kv = dist.dp, kv_axis(cfg, dist)
    rows_ax = None if kv else dist.tp  # launch.sharding.cache_specs's page rows
    pages_spec = (dp, kv, None, rows_ax, None)
    rows = torch.arange(page, device=x.device)
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        dist.local(_write_token, (pages, new.reshape(B, KVH, hd), phys, off, rows),
                   (pages_spec, (dp, kv, None), (dp,), (dp,), (rows_ax,)), inplace=(0,))
    qh = dist.constrain(q, dp, None, kv, None).reshape(B, KVH, G, cfg.hd)  # whole KV groups
    o = dist.local(lambda *a: kernels.dispatch("paged_attention", kernel_backend, *a),
                   (qh, k_pages, v_pages, btab, lens + 1),
                   ((dp, kv, None, None), (dp, kv, None, None, None),
                    (dp, kv, None, None, None), (dp, None), (dp,)))
    o = o.reshape(B, 1, cfg.n_heads * cfg.hd).to(x.dtype)
    return _proj(o, p["wo"]), k_pages, v_pages


def _write_token(pages: torch.Tensor, new: torch.Tensor, phys: torch.Tensor,
                 off: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """pages (B, KVH, n_pool, page, hd), in place: the row of page
    ``phys[b]`` whose index in ``rows`` is ``off[b]`` takes ``new[b]`` (B,
    KVH, hd). The page is read, the row replaced and the page written back,
    a scatter along the pool axis; ``rows`` holds the page rows' indices
    (all of them, or a shard's under a global-view mesh)."""
    B, KVH, _, P, hd = pages.shape
    at = (rows[None] == off[:, None]).reshape(B, 1, 1, P, 1)
    idx = phys.reshape(B, 1, 1, 1, 1).expand(B, KVH, 1, P, hd)
    pages.scatter_(2, idx, torch.where(at, new.reshape(B, KVH, 1, 1, hd), pages.gather(2, idx)))
    return pages


def init_cross_attention(cfg: ArchConfig, gen: torch.Generator) -> dict:
    return init_attention(cfg, gen)


def cross_attention(cfg: ArchConfig, p: dict, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor, dist: Dist = NO_DIST) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V
    (enc_k/v: (B, F, KVH, hd)). Under a global-view mesh the attention runs
    on each rank's rows and heads (``Dist.local``), as ``transformer``'s
    self-attention does: the decode cache may hold the encoder K/V split
    along hd."""
    B, S, _ = x.shape
    q = _heads(cfg, p, x, "q", cfg.n_heads, dist)
    spec = (dist.dp, None, kv_axis(cfg, dist), None)
    o = dist.local(lambda q, k, v: chunked_gqa_attention(q, k, v, causal=False,
                                                         unroll=cfg.unroll),
                   (q, enc_k, enc_v), (spec, spec, spec))
    out = _proj(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"])
    return dist.constrain(out, dist.dp, None, None)


def encoder_kv(cfg: ArchConfig, p: dict, enc_out: torch.Tensor, dist: Dist = NO_DIST) -> tuple:
    """Cross-attention K/V of the encoder output (B, F, d)."""
    return (_heads(cfg, p, enc_out, "k", cfg.n_kv_heads, dist),
            _heads(cfg, p, enc_out, "v", cfg.n_kv_heads, dist))


def cross_attention_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, enc_k: torch.Tensor,
                           enc_v: torch.Tensor, dist: Dist = NO_DIST) -> torch.Tensor:
    """Single-token cross-attention (decode): the same math at S = 1."""
    return cross_attention(cfg, p, x, enc_k, enc_v, dist)


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


def apply_mlp(cfg: ArchConfig, p: dict, x: torch.Tensor, dist: Dist = NO_DIST) -> torch.Tensor:
    """swiglu, geglu or gelu; the activation and the gate product in
    float32 on the projections rounded to x's dtype. Under a global-view
    mesh the output is summed over the model axis where it comes out (the
    row-parallel product's partial sums), as XLA lays it out: left to
    itself, DTensor may reduce-scatter it along the sequence, a layout
    whose backward it cannot shard."""
    if cfg.activation in ("swiglu", "geglu"):
        act = F.silu if cfg.activation == "swiglu" else gelu
        h = act(_proj(x, p["wi_gate"]).float()) * _proj(x, p["wi_up"]).float()
    else:
        h = gelu(_proj(x, p["wi"]).float())
    return dist.constrain(_proj(h.to(x.dtype), p["wo"]), dist.dp, None, None)


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


def embed(cfg: ArchConfig, p: dict, tokens: torch.Tensor, dist: Dist = NO_DIST) -> torch.Tensor:
    """The token rows; a negative id counts from the end, as indexing (the
    reference's too) takes it. Under a global-view mesh through
    ``F.embedding``, whose lookup and backward on a vocab-sharded table
    have DTensor sharding rules (row indexing's backward, an accumulating
    ``index_put``, has none in every torch release); elsewhere by row
    indexing, whose backward rounds as it always has."""
    ids = tokens.long()
    if dist.spmd:
        return F.embedding(torch.where(ids < 0, ids + p["tok"].shape[0], ids), p["tok"])
    return p["tok"][ids]


def unembed(cfg: ArchConfig, p: dict, h: torch.Tensor, dist: Dist = NO_DIST) -> torch.Tensor:
    """float32 logits through the tied table or the untied ``unembed`` (d,
    vocab): the reference's ``preferred_element_type=f32``, bf16 products
    summed in float32 and never rounded to bf16 (:func:`matmul_f32`). A
    bf16 product would round the logits to bf16 first, where argmax ties
    become likely. Under a global-view mesh the table is gathered whole
    along d and kept split along the vocab, so that each rank makes its
    vocab shard of the logits (DTensor's cheapest product otherwise makes
    every rank compute all of them), and the logits are held to that
    layout, which their gradient then takes too."""
    w = p["tok"].t() if cfg.tie_embeddings else p["unembed"]
    logits = matmul_f32(h, dist.constrain(w, None, dist.tp))
    return dist.constrain(logits, dist.dp, *([None] * (h.dim() - 2)), dist.tp)
