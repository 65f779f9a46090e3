"""Transformer assembly for the dense family (port of the dense parts of
``repro.models.transformer``).

The public layouts are the reference's: params hold the layer stack under
``groups/layer0/...`` with a leading ``n_groups`` axis, and the decode cache
is ``{"layers": {"layer0": {"k_pages", "v_pages"}}, "btab", "lens"}`` with
pages ``(n_groups, B, KVH, n_pool, page, hd)``. Where the reference scans
the stack, the port loops over the groups.

Modes: ``prefill`` (last-position logits and a decode cache) and ``decode``
(one token through the paged cache). :func:`decode_step` writes the cache's
pages in place and returns the same cache dict with ``lens`` advanced.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import runtime
from repro_torch.models import layers as L


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP queue 1, item 15: the "
        "model-layer stack; the dense family runs)")


def _check_dense(cfg: ArchConfig) -> None:
    """The port runs what qwen2-0.5b needs; other configs raise."""
    if cfg.family != "dense" or cfg.is_moe or cfg.encdec:
        raise _not_ported(f"the {cfg.family!r} family ({cfg.name})")
    if cfg.norm != "rmsnorm" or cfg.activation != "swiglu" or not cfg.tie_embeddings:
        raise _not_ported(f"{cfg.norm} / {cfg.activation} / untied embeddings ({cfg.name})")
    if cfg.unroll or cfg.causal_skip:
        raise _not_ported("the unrolled attention path (cfg.unroll / causal_skip)")


# ===========================================================================
# init
# ===========================================================================
def _init_layer(cfg: ArchConfig, gen: torch.Generator) -> dict:
    return {
        "norm1": L.init_norm(cfg, gen),
        "attn": L.init_attention(cfg, gen),
        "norm2": L.init_norm(cfg, gen),
        "ffn": L.init_mlp(cfg, gen),
    }


def _stack(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random params on the generator's device, drawn from it in order
    (embedding, then each group's layers)."""
    _check_dense(cfg)
    params = {
        "embed": L.init_embedding(cfg, generator),
        "final_norm": L.init_norm(cfg, generator),
    }
    params["groups"] = _stack([
        {f"layer{j}": _init_layer(cfg, generator) for j in range(cfg.group_size)}
        for _ in range(cfg.n_groups)])
    return params


def _group(tree: dict, g: int) -> dict:
    """Group g's slice of a stacked tree (views, no copies)."""
    return {k: _group(v, g) if isinstance(v, dict) else v[g] for k, v in tree.items()}


# ===========================================================================
# layer pieces
# ===========================================================================
def _embed_tokens(cfg: ArchConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return L.embed(cfg, params["embed"], tokens)


def _apply_ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    """The dense FFN sub-block (the reference's MoE auxiliary loss is 0 here
    and is not returned)."""
    x = L.apply_norm(cfg, lp["norm2"], h)
    return h + L.apply_mlp(cfg, lp["ffn"], x)


# ===========================================================================
# caches
# ===========================================================================
def n_pool_pages(cfg: ArchConfig, seq_len: int, slack: int = 8) -> int:
    return -(-seq_len // cfg.page_size) + slack


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, n_pool: int | None = None,
               device=None) -> dict:
    """Empty decode cache for ``max_seq`` tokens on ``device`` (CUDA unless
    named); ``n_pool`` overrides the physical pages per sequence."""
    _check_dense(cfg)
    dev = runtime.resolve_device(device)
    n_pool = n_pool or n_pool_pages(cfg, max_seq)
    shape = (cfg.n_groups, batch, cfg.n_kv_heads, n_pool, cfg.page_size, cfg.hd)
    return {
        "layers": {f"layer{j}": {
            "k_pages": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v_pages": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        } for j in range(cfg.group_size)},
        "btab": torch.arange(n_pool, dtype=torch.int32, device=dev).repeat(batch, 1),
        "lens": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def _pack_pages(cfg: ArchConfig, kv: torch.Tensor, n_pool: int) -> torch.Tensor:
    """(B, S, KVH, hd) -> (B, KVH, n_pool, page, hd) identity-paged."""
    B, S, KVH, hd = kv.shape
    page = cfg.page_size
    kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, n_pool * page - S))
    return kv.reshape(B, n_pool, page, KVH, hd).permute(0, 3, 1, 2, 4).contiguous()


# ===========================================================================
# decode
# ===========================================================================
def _apply_layer_decode(cfg, lp, lc, h, lens, btab, kernel_backend="auto"):
    """One layer, one token. ``lc``: this layer's cache slice (no group
    dim), whose pages are written in place."""
    x = L.apply_norm(cfg, lp["norm1"], h)
    mix, _, _ = L.attention_decode_paged(
        cfg, lp["attn"], x, lc["k_pages"], lc["v_pages"], btab, lens, kernel_backend)
    return _apply_ffn(cfg, lp, h + mix)


def decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens: torch.Tensor,
                kernel_backend: str = "auto"):
    """tokens (B, 1) -> (float32 logits (B, vocab), cache). Position = lens.
    The cache's pages are updated in place; the returned dict is the same
    one, with ``lens`` advanced by one."""
    _check_dense(cfg)
    lens = cache["lens"]
    btab = cache["btab"]
    h = _embed_tokens(cfg, params, tokens)
    for g in range(cfg.n_groups):
        gp, gc = _group(params["groups"], g), _group(cache["layers"], g)
        for j in range(cfg.group_size):
            h = _apply_layer_decode(cfg, gp[f"layer{j}"], gc[f"layer{j}"], h, lens,
                                    btab, kernel_backend)
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
    the device of ``batch["tokens"]``."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    max_seq = max_seq or S
    n_pool = n_pool or n_pool_pages(cfg, max_seq)
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    h = _embed_tokens(cfg, params, tokens)
    pages = {f"layer{j}": {"k_pages": [], "v_pages": []} for j in range(cfg.group_size)}
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        for j in range(cfg.group_size):
            lp = gp[f"layer{j}"]
            x = L.apply_norm(cfg, lp["norm1"], h)
            q, k, v = L.qkv(cfg, lp["attn"], x, positions)
            o = L.chunked_gqa_attention(q, k, v, causal=True)
            h = h + L._proj(o.reshape(B, S, cfg.n_heads * cfg.hd), lp["attn"]["wo"])
            pages[f"layer{j}"]["k_pages"].append(_pack_pages(cfg, k, n_pool))
            pages[f"layer{j}"]["v_pages"].append(_pack_pages(cfg, v, n_pool))
            h = _apply_ffn(cfg, lp, h)
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = L.unembed(cfg, params["embed"], h[:, -1:])[:, 0]
    cache = {
        "layers": {name: {k: torch.stack(v) for k, v in lc.items()}
                   for name, lc in pages.items()},
        "btab": torch.arange(n_pool, dtype=torch.int32, device=dev).repeat(B, 1),
        "lens": torch.full((B,), S, dtype=torch.int32, device=dev),
    }
    return logits, cache
