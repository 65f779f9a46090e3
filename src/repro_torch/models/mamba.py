"""Mamba (S6 selective-scan) mixer of the Jamba hybrid (port of
``repro.models.mamba``).

The reference runs the recurrence h_t = dA_t * h_{t-1} + dBx_t as a scan
over chunks of 16 steps with a parallel ``associative_scan`` inside each
chunk. The port keeps the chunks (so that the (B, chunk, d_inner, d_state)
expansion bounds the memory, as there) and runs each chunk's recurrence
step by step: the same values in another order of float32 operations. The
last chunk is cut to the sequence's end instead of padded with identity
steps (dA = 1, dBx = 0), which leave the state exactly as it is; so the
state handed to decode is the state after the last real token.

Decode carries (ssm state h, conv tail): constant-size state. Training
(:func:`mamba_train`) runs the same forward under autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


def dt_rank(cfg: ArchConfig) -> int:
    return -(-cfg.d_model // 16)


def init_mamba(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d = cfg.d_model
    di, ds, dr = cfg.ssm_expand * d, cfg.ssm_state, dt_rank(cfg)
    dev = gen.device
    conv_w = L._randn(gen, (cfg.ssm_conv, di)) * cfg.ssm_conv ** -0.5
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": L.dense_init(gen, d, 2 * di, cfg.dtype),
        "conv_w": conv_w.to(cfg.dtype),
        "conv_b": L._zeros(gen, di, cfg.dtype),
        "x_proj": L.dense_init(gen, di, dr + 2 * ds, cfg.dtype),
        "dt_proj": L.dense_init(gen, dr, di, cfg.dtype),
        "dt_bias": L._zeros(gen, di, torch.float32),
        "A_log": torch.log(a).expand(di, ds).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": L.dense_init(gen, di, d, cfg.dtype),
    }


def _causal_conv(p: dict, x: torch.Tensor, tail: torch.Tensor | None = None) -> tuple:
    """Depthwise causal conv over the sequence. x (B, S, di); tail (B,
    dc-1, di) from the previous segment (decode) or zeros. Returns (y,
    new_tail), in x's dtype."""
    dc = p["conv_w"].shape[0]
    B, S, di = x.shape
    if tail is None:
        tail = torch.zeros((B, dc - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)  # (B, S+dc-1, di)
    y = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(dc)) + p["conv_b"]
    return y, xp[:, xp.shape[1] - (dc - 1):]


def _ssm_params(cfg: ArchConfig, p: dict, xc: torch.Tensor) -> tuple:
    """xc (..., di) -> dA (..., di, ds), dBx (..., di, ds), Cs (..., ds).
    ``cfg.ssm_bf16`` keeps dA and dBx in bf16, as the reference does."""
    dr, ds = dt_rank(cfg), cfg.ssm_state
    dbc = L._proj(xc, p["x_proj"]).float()
    dt, Bs, Cs = torch.split(dbc, [dr, ds, ds], dim=-1)
    dt = F.softplus(torch.matmul(dt, p["dt_proj"].float()) + p["dt_bias"])
    A = -torch.exp(p["A_log"])  # (di, ds)
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xc.float())[..., None] * Bs[..., None, :]
    if cfg.ssm_bf16:
        dA, dBx = dA.to(torch.bfloat16), dBx.to(torch.bfloat16)
    return dA, dBx, Cs


def _mamba_forward(cfg: ArchConfig, p: dict, x: torch.Tensor, h0, tail0,
                   chunk: int = 16) -> tuple:
    B, S, d = x.shape
    di, ds = cfg.ssm_expand * d, cfg.ssm_state
    x_in, z = L._proj(x, p["in_proj"]).chunk(2, dim=-1)
    xc, tail = _causal_conv(p, x_in, tail0)
    xc = F.silu(xc.float()).to(x.dtype)
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device) if h0 is None else h0
    ys = []
    for c0 in range(0, S, chunk):
        dA, dBx, Cs = _ssm_params(cfg, p, xc[:, c0:c0 + chunk])  # (B, c, di, ds) x2, (B, c, ds)
        hc = h.to(dBx.dtype)  # the carry enters the chunk in the scan's dtype
        hs = []
        for t in range(dA.shape[1]):
            hc = dA[:, t] * hc + dBx[:, t]
            hs.append(hc)
        hs = torch.stack(hs, dim=1).float()
        ys.append((hs * Cs[:, :, None, :]).sum(-1))  # (B, c, di)
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) + p["D"] * xc.float()
    y = y * F.silu(z.float())
    return L._proj(y.to(x.dtype), p["out_proj"]), (h, tail)


def mamba_train(cfg: ArchConfig, p: dict, x: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): the whole sequence, no state kept."""
    return _mamba_forward(cfg, p, x, None, None, chunk=chunk)[0]


def init_mamba_cache(cfg: ArchConfig, batch: int, device) -> dict:
    di = cfg.ssm_expand * cfg.d_model
    return {
        "h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32, device=device),
        "conv_tail": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=cfg.dtype, device=device),
    }


def mamba_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, cache: dict) -> tuple:
    """x (B, 1, d): one step of the recurrence from the cached state."""
    out, (h, tail) = _mamba_forward(cfg, p, x, cache["h"], cache["conv_tail"], chunk=1)
    return out, {"h": h, "conv_tail": tail}


def mamba_prefill(cfg: ArchConfig, p: dict, x: torch.Tensor, chunk: int = 16) -> tuple:
    """The whole sequence, and the decode cache after its last token."""
    out, (h, tail) = _mamba_forward(cfg, p, x, None, None, chunk=chunk)
    return out, {"h": h, "conv_tail": tail}
