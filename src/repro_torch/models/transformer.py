"""Transformer assembly for every family (port of the serving half of
``repro.models.transformer``): dense, MoE, hybrid (attention + Mamba), ssm
(xLSTM), encoder-decoder (Whisper) and vlm (M-RoPE), by ``ArchConfig``'s
flags.

The public layouts are the reference's: params hold the layer stack under
``groups/layer{j}/...`` with a leading ``n_groups`` axis (a super-block of
``cfg.group_size`` layers: jamba's 1 attention + 7 Mamba, xLSTM's 7 mLSTM +
1 sLSTM), the encoder under ``encoder/layers/layer0/...`` with a leading
``n_enc_layers`` axis; the decode cache is ``{"layers": {"layer{j}":
{"k_pages", "v_pages"} or the mixer's state}, "btab", "lens"}`` (plus
``enc_k`` / ``enc_v`` for an encoder-decoder), every leaf with a leading
``n_groups`` axis and the batch on axis 1. Where the reference scans the
stack, the port loops over the groups.

Modes: ``train`` (:func:`loss_fn`, differentiated by autograd), ``prefill``
(last-position logits and a decode cache) and ``decode`` (one token through
the paged cache). :func:`decode_step` writes the cache's tensors in place
and returns the same cache dict with ``lens`` advanced. ``cfg.remat ==
"block"`` recomputes each decoder group in the backward
(``torch.utils.checkpoint``), and the cross-entropy recomputes each
sequence chunk's logits, so that neither the activations of every layer
nor the (B, S, vocab) logits are held for the backward.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import runtime
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X
from repro_torch.models.dist import NO_DIST, Dist


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP queue 1, {item})")


def _check(cfg: ArchConfig) -> None:
    """The unrolled lowering is the dry-run's; the port has none yet."""
    if cfg.unroll or cfg.causal_skip:
        raise _not_ported("the unrolled attention path (cfg.unroll / causal_skip)",
                          "item 17: the dry-run tooling")


# ===========================================================================
# init
# ===========================================================================
def _init_layer(cfg: ArchConfig, gen: torch.Generator, j: int, cross: bool) -> dict:
    """One layer's params; ``j`` is its position within the super-block."""
    kind = cfg.layer_kind(j)
    p = {"norm1": L.init_norm(cfg, gen)}
    if kind == "attn":
        p["attn"] = L.init_attention(cfg, gen)
    elif kind == "mamba":
        p["mamba"] = M.init_mamba(cfg, gen)
    elif kind == "mlstm":
        p["mlstm"] = X.init_mlstm(cfg, gen)
    else:
        p["slstm"] = X.init_slstm(cfg, gen)
    if cross:
        p["norm_x"] = L.init_norm(cfg, gen)
        p["xattn"] = L.init_cross_attention(cfg, gen)
    if cfg.d_ff or cfg.layer_is_moe(j):
        p["norm2"] = L.init_norm(cfg, gen)
        p["ffn"] = MOE.init_moe(cfg, gen) if cfg.layer_is_moe(j) else L.init_mlp(cfg, gen)
    return p


def _init_group(cfg: ArchConfig, gen: torch.Generator, cross: bool) -> dict:
    return {f"layer{j}": _init_layer(cfg, gen, j, cross) for j in range(cfg.group_size)}


def _stacked(make, n: int) -> dict:
    """A tree with a leading axis of n, filled one ``make()`` at a time: the
    stack is allocated once and never held twice (internlm2-20b's 40 GB)."""
    first = make()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        out[0] = t
        return out

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    out = alloc(first)
    del first
    for i in range(1, n):
        put(out, make(), i)
    return out


def _enc_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder: plain attention and a gelu MLP (whisper)."""
    return cfg.replace(activation="gelu", n_experts=0, attn_period=0, slstm_period=0,
                       encdec=False, family="dense", n_layers=cfg.n_enc_layers)


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random params on the generator's device, drawn from it in order
    (embedding, each group's layers, the encoder)."""
    _check(cfg)
    params = {
        "embed": L.init_embedding(cfg, generator),
        "final_norm": L.init_norm(cfg, generator),
    }
    params["groups"] = _stacked(lambda: _init_group(cfg, generator, cfg.encdec), cfg.n_groups)
    if cfg.encdec:
        ecfg = _enc_cfg(cfg)
        params["encoder"] = {
            "layers": _stacked(lambda: _init_group(ecfg, generator, False), ecfg.n_layers),
            "final_norm": L.init_norm(cfg, generator),
        }
    return params


def _group(tree: dict, g: int) -> dict:
    """Group g's slice of a stacked tree (views, no copies)."""
    return {k: _group(v, g) if isinstance(v, dict) else v[g] for k, v in tree.items()}


# ===========================================================================
# layer pieces
# ===========================================================================
def _embed_tokens(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                  lens: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings, plus the decoder's learned positions where the
    config has them: positions 0..S-1 in prefill, ``lens`` (clamped to the
    table, as the reference's gather clamps) at decode."""
    h = L.embed(cfg, params["embed"], tokens)
    if cfg.encdec:
        pos = params["embed"]["pos_dec"]
        if lens is None:
            h = h + pos[None, :tokens.shape[1]]
        else:
            h = h + pos[lens.long().clamp(max=pos.shape[0] - 1)][:, None]
    return h


def _apply_ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor, j: int, aux: bool = False,
               dist: Dist = NO_DIST):
    """The FFN sub-block, dense or MoE: h, or with ``aux`` (training) the
    pair (h, float32 load-balance loss; 0 for a dense layer)."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device) if aux else None
    if "ffn" not in lp:
        return (h, zero) if aux else h
    x = L.apply_norm(cfg, lp["norm2"], h)
    if cfg.layer_is_moe(j):
        out = h + MOE.apply_moe(cfg, lp["ffn"], x, dist)
        return (out, MOE.aux_loss(cfg, lp["ffn"], x, dist)) if aux else out
    out = h + L.apply_mlp(cfg, lp["ffn"], x)
    return (out, zero) if aux else out


def _attend(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
            causal: bool) -> tuple:
    """Full-sequence attention: (output, k, v)."""
    B, S = x.shape[:2]
    q, k, v = L.qkv(cfg, p, x, positions, rope=not cfg.encdec)
    o = L.chunked_gqa_attention(q, k, v, causal=causal)
    return L._proj(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"]), k, v


def _encode(cfg: ArchConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """The Whisper encoder over stub frame embeddings (B, F, d)."""
    ecfg = _enc_cfg(cfg)
    B, F_ = frames.shape[:2]
    h = frames + params["embed"]["pos_enc"][None, :F_]
    pos = torch.arange(F_, device=frames.device)[None].expand(B, F_)
    enc = params["encoder"]["layers"]
    for g in range(ecfg.n_groups):
        gp = _group(enc, g)
        for j in range(ecfg.group_size):
            lp = gp[f"layer{j}"]
            x = L.apply_norm(ecfg, lp["norm1"], h)
            h = h + _attend(ecfg, lp["attn"], x, pos, causal=False)[0]
            h = _apply_ffn(ecfg, lp, h, j)
    return L.apply_norm(cfg, params["encoder"]["final_norm"], h)


# ===========================================================================
# training
# ===========================================================================
AUX_WEIGHT = 0.01  # MoE load-balance loss weight
TRAIN_MIXERS = {"mamba": M.mamba_train, "mlstm": X.mlstm_train, "slstm": X.slstm_train}


def _apply_group_train(cfg: ArchConfig, gp: dict, h: torch.Tensor, positions: torch.Tensor,
                       enc_out: torch.Tensor | None, dist: Dist = NO_DIST) -> tuple:
    """One decoder group over the whole sequence: (h, the group's summed
    auxiliary loss, float32)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(cfg.group_size):
        lp, kind = gp[f"layer{j}"], cfg.layer_kind(j)
        x = L.apply_norm(cfg, lp["norm1"], h)
        if kind == "attn":
            mix = _attend(cfg, lp["attn"], x, positions, causal=True)[0]
        else:
            mix = TRAIN_MIXERS[kind](cfg, lp[kind], x)
        h = h + mix
        if "xattn" in lp:
            xh = L.apply_norm(cfg, lp["norm_x"], h)
            h = h + L.cross_attention(cfg, lp["xattn"], xh,
                                      *L.encoder_kv(cfg, lp["xattn"], enc_out))
        h, aux = _apply_ffn(cfg, lp, h, j, aux=True, dist=dist)
        aux_total = aux_total + aux
        h = dist.constrain(h, dist.dp, None, None)
    return h, aux_total


def _unstack(tree: dict, n: int) -> list:
    """A stacked tree as n per-group trees of views (``unbind``: the
    backward stacks the n groups' gradients once)."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for g in range(n):
            out[g][k] = parts[g]
    return out


def forward_train(cfg: ArchConfig, params: dict, batch: dict, dist: Dist = NO_DIST) -> tuple:
    """-> (final-normed hidden (B, S, d), summed auxiliary loss). ``batch``:
    ``tokens`` (B, S), and M-RoPE ``positions`` (3, B, S) or an
    encoder-decoder's ``frames`` (B, F, d) where the config has them; under
    a mesh, this DP rank's rows of the global batch (``dist``)."""
    _check(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    h = dist.constrain(_embed_tokens(cfg, params, tokens), dist.dp, None, None)
    enc_out = _encode(cfg, params, batch["frames"]) if cfg.encdec else None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for gp in _unstack(params["groups"], cfg.n_groups):
        if remat:
            h, a = checkpoint(_apply_group_train, cfg, gp, h, positions, enc_out, dist,
                              use_reentrant=False)
        else:
            h, a = _apply_group_train(cfg, gp, h, positions, enc_out, dist)
        aux = aux + a
    return L.apply_norm(cfg, params["final_norm"], h), aux


def _ce_chunk(cfg: ArchConfig, embed: dict, hb: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one chunk (B, chunk, d) against its labels
    (B, chunk); labels < 0 add nothing."""
    logits = L.unembed(cfg, embed, hb)  # float32 (B, chunk, V)
    logz = torch.logsumexp(logits, dim=-1)
    mask = lb >= 0
    tgt = torch.gather(logits, -1, lb.clamp(min=0).long()[..., None])[..., 0]
    return torch.where(mask, logz - tgt, torch.zeros((), device=logits.device)).sum()


def chunked_ce_loss(cfg: ArchConfig, params: dict, h: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 512, dist: Dist = NO_DIST) -> torch.Tensor:
    """Mean cross-entropy over the labels >= 0, by sequence chunks: each
    chunk's float32 logits (B, chunk, vocab) are made, summed and, under
    autograd, recomputed in the backward rather than held. Under a mesh the
    rank's sum over the count of every DP rank's labels: the ranks' values
    sum to the global mean."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):  # the reference pads the last chunk with masked labels
        hb, lb = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_ce_chunk, cfg, params["embed"], hb, lb,
                                       use_reentrant=False)
        else:
            total = total + _ce_chunk(cfg, params["embed"], hb, lb)
    count = dist.psum((labels >= 0).sum(), "ce_count")
    return total / torch.clamp(count, min=1)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, dist: Dist = NO_DIST) -> tuple:
    """(ce + AUX_WEIGHT * aux, {"ce", "aux"}), float32 scalars; ``batch``
    as :func:`forward_train`'s plus ``labels`` (B, S). Under a mesh with
    several DP ranks each rank's values are its share: their sums over the
    ranks are the global batch's loss, metrics and gradients."""
    h, aux = forward_train(cfg, params, batch, dist)
    ce = chunked_ce_loss(cfg, params, h, batch["labels"], dist=dist)
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


# ===========================================================================
# caches
# ===========================================================================
def n_pool_pages(cfg: ArchConfig, seq_len: int, slack: int = 8) -> int:
    return -(-seq_len // cfg.page_size) + slack


def _state_cache(cfg: ArchConfig, kind: str, batch: int, device) -> dict:
    """An empty mixer state for ``batch`` sequences (no group axis)."""
    if kind == "mamba":
        return M.init_mamba_cache(cfg, batch, device)
    if kind == "mlstm":
        return X.init_mlstm_cache(cfg, batch, device)
    return X.init_slstm_cache(cfg, batch, device)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, n_pool: int | None = None,
               device=None) -> dict:
    """Empty decode cache for ``max_seq`` tokens on ``device`` (CUDA unless
    named): paged K/V for attention layers, the mixers' states for the
    others; ``n_pool`` overrides the physical pages per sequence."""
    _check(cfg)
    dev = runtime.resolve_device(device)
    n_pool = n_pool or n_pool_pages(cfg, max_seq)
    G, KVH, hd = cfg.n_groups, cfg.n_kv_heads, cfg.hd

    def per_layer(j):
        kind = cfg.layer_kind(j)
        if kind == "attn":
            shape = (G, batch, KVH, n_pool, cfg.page_size, hd)
            return {"k_pages": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                    "v_pages": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
        return {k: v[None].repeat(G, *([1] * v.dim()))
                for k, v in _state_cache(cfg, kind, batch, dev).items()}

    cache = {
        "layers": {f"layer{j}": per_layer(j) for j in range(cfg.group_size)},
        "btab": torch.arange(n_pool, dtype=torch.int32, device=dev).repeat(batch, 1),
        "lens": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }
    if cfg.encdec:
        shape = (G, batch, cfg.n_frames, KVH, hd)
        cache["enc_k"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        cache["enc_v"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    return cache


def _pack_pages(cfg: ArchConfig, kv: torch.Tensor, n_pool: int) -> torch.Tensor:
    """(B, S, KVH, hd) -> (B, KVH, n_pool, page, hd) identity-paged."""
    B, S, KVH, hd = kv.shape
    page = cfg.page_size
    kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, n_pool * page - S))
    return kv.reshape(B, n_pool, page, KVH, hd).permute(0, 3, 1, 2, 4).contiguous()


# ===========================================================================
# decode
# ===========================================================================
def _apply_layer_decode(cfg, lp, lc, h, lens, btab, enc_kv, j, kernel_backend="auto"):
    """One layer, one token. ``lc``: this layer's cache slice (no group
    dim), written in place: pages by the attention step, states copied
    over."""
    kind = cfg.layer_kind(j)
    x = L.apply_norm(cfg, lp["norm1"], h)
    if kind == "attn":
        mix, _, _ = L.attention_decode_paged(
            cfg, lp["attn"], x, lc["k_pages"], lc["v_pages"], btab, lens, kernel_backend)
    else:
        step = {"mamba": M.mamba_decode, "mlstm": X.mlstm_decode,
                "slstm": X.slstm_decode}[kind]
        mix, st = step(cfg, lp[kind], x, lc)
        for k, v in st.items():
            lc[k].copy_(v)
    h = h + mix
    if "xattn" in lp:
        xh = L.apply_norm(cfg, lp["norm_x"], h)
        h = h + L.cross_attention_decode(cfg, lp["xattn"], xh, *enc_kv)
    return _apply_ffn(cfg, lp, h, j)


def decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens: torch.Tensor,
                kernel_backend: str = "auto"):
    """tokens (B, 1) -> (float32 logits (B, vocab), cache). Position = lens.
    The cache's tensors are updated in place; the returned dict is the same
    one, with ``lens`` advanced by one."""
    _check(cfg)
    lens, btab = cache["lens"], cache["btab"]
    h = _embed_tokens(cfg, params, tokens, lens=lens)
    for g in range(cfg.n_groups):
        gp, gc = _group(params["groups"], g), _group(cache["layers"], g)
        enc_kv = (cache["enc_k"][g], cache["enc_v"][g]) if cfg.encdec else None
        for j in range(cfg.group_size):
            h = _apply_layer_decode(cfg, gp[f"layer{j}"], gc[f"layer{j}"], h, lens, btab,
                                    enc_kv, j, kernel_backend)
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = L.unembed(cfg, params["embed"], h[:, 0:1])[:, 0]
    cache["lens"] = lens + 1
    return logits, cache


# ===========================================================================
# prefill
# ===========================================================================
def prefill(cfg: ArchConfig, params: dict, batch: dict, max_seq: int | None = None,
            n_pool: int | None = None):
    """Full-sequence forward: (last-token float32 logits, decode cache), on
    the device of ``batch["tokens"]``. ``batch`` may hold M-RoPE
    ``positions`` (3, B, S) and an encoder-decoder's ``frames`` (B, F, d)."""
    _check(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    max_seq = max_seq or S
    n_pool = n_pool or n_pool_pages(cfg, max_seq)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    h = _embed_tokens(cfg, params, tokens)
    enc_out = _encode(cfg, params, batch["frames"]) if cfg.encdec else None
    layers = {f"layer{j}": {} for j in range(cfg.group_size)}
    enc_kv = []
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        for j in range(cfg.group_size):
            lp, kind = gp[f"layer{j}"], cfg.layer_kind(j)
            x = L.apply_norm(cfg, lp["norm1"], h)
            if kind == "attn":
                mix, k, v = _attend(cfg, lp["attn"], x, positions, causal=True)
                st = {"k_pages": _pack_pages(cfg, k, n_pool),
                      "v_pages": _pack_pages(cfg, v, n_pool)}
            else:
                run = {"mamba": M.mamba_prefill, "mlstm": X.mlstm_prefill,
                       "slstm": X.slstm_prefill}[kind]
                mix, st = run(cfg, lp[kind], x)
            for key, t in st.items():
                layers[f"layer{j}"].setdefault(key, []).append(t)
            h = h + mix
            if "xattn" in lp:
                xh = L.apply_norm(cfg, lp["norm_x"], h)
                ek, ev = L.encoder_kv(cfg, lp["xattn"], enc_out)
                h = h + L.cross_attention(cfg, lp["xattn"], xh, ek, ev)
                if j == 0:  # the cache keeps each group's first layer's, as the reference
                    enc_kv.append((ek, ev))
            h = _apply_ffn(cfg, lp, h, j)
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = L.unembed(cfg, params["embed"], h[:, -1:])[:, 0]
    cache = {
        "layers": {name: {k: torch.stack(v) for k, v in lc.items()}
                   for name, lc in layers.items()},
        "btab": torch.arange(n_pool, dtype=torch.int32, device=dev).repeat(B, 1),
        "lens": torch.full((B,), S, dtype=torch.int32, device=dev),
    }
    if cfg.encdec:
        cache["enc_k"] = torch.stack([k for k, _ in enc_kv])
        cache["enc_v"] = torch.stack([v for _, v in enc_kv])
    return logits, cache
