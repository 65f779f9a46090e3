"""xLSTM mixers (port of ``repro.models.xlstm``): mLSTM (matrix memory, 7
of 8 blocks) and sLSTM (scalar memory, every 8th block), with exponential
gating and the max-stabiliser.

Both carry constant-size decode state and no KV cache. As in the
reference, training, prefill and decode run the recurrence one time step
after another (a loop here where the reference scans).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


# the floor of the normalisers, as ``jnp.maximum(x, 1.0)``: where x is
# exactly 1 (sLSTM's n after its first step) the gradient splits in half
# between the two, as JAX's does; ``clamp`` would pass all of it to x
_ONE = torch.tensor(1.0)


def _di(cfg: ArchConfig) -> int:
    return 2 * cfg.d_model


def _block_diag(gen: torch.Generator, n: int, hd: int, dtype) -> torch.Tensor:
    """n per-head (hd, hd) ``dense_init`` blocks."""
    return torch.stack([L.dense_init(gen, hd, hd, dtype) for _ in range(n)])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, di, H = cfg.d_model, _di(cfg), cfg.n_heads
    hd = di // H
    return {
        "up_proj": L.dense_init(gen, d, 2 * di, cfg.dtype),  # x, z-gate
        "wq": _block_diag(gen, H, hd, cfg.dtype),  # (H, hd, hd)
        "wk": _block_diag(gen, H, hd, cfg.dtype),
        "wv": _block_diag(gen, H, hd, cfg.dtype),
        "w_if": L.dense_init(gen, di, 2 * H, torch.float32),  # i/f gate logits
        "b_if": L._zeros(gen, 2 * H, torch.float32),
        "down_proj": L.dense_init(gen, di, d, cfg.dtype),
    }


def init_mlstm_cache(cfg: ArchConfig, batch: int, device) -> dict:
    H = cfg.n_heads
    hd = _di(cfg) // H
    return {
        "C": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, H, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, H), -1e30, dtype=torch.float32, device=device),
    }


def _mlstm_step(q, k, v, i_log, f_log, state: dict) -> tuple:
    """One time step. q/k/v (B, H, hd); i_log/f_log (B, H) log-space gates."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(f_log + m, i_log)
    i_g = torch.exp(i_log - m_new)
    f_g = torch.exp(f_log + m - m_new)
    kv = k[..., :, None] * v[..., None, :]  # outer product (B, H, hd, hd)
    C = f_g[..., None, None] * C + i_g[..., None, None] * kv
    n = f_g[..., None] * n + i_g[..., None] * k
    num = torch.einsum("bhde,bhd->bhe", C, q)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q)), _ONE)
    return num / den[..., None], {"C": C, "n": n, "m": m_new}


def _mlstm_qkvif(cfg: ArchConfig, p: dict, x_in: torch.Tensor) -> tuple:
    """x_in (..., di) -> q, k, v (..., H, hd) (block-diagonal per head) and
    the i/f gate logits (..., H), in float32."""
    H = cfg.n_heads
    hd = x_in.shape[-1] // H
    xh = x_in.reshape(*x_in.shape[:-1], H, hd).float()

    def bdproj(w):  # (..., H, hd) @ (H, hd, hd) -> (..., H, hd)
        return torch.einsum("...hd,hde->...he", xh, w.float())

    q = bdproj(p["wq"])
    k = bdproj(p["wk"]) * hd ** -0.5
    v = bdproj(p["wv"])
    gates = torch.matmul(x_in.float(), p["w_if"]) + p["b_if"]
    i_log, f_log = gates.chunk(2, dim=-1)
    return q, k, v, i_log, F.logsigmoid(f_log)


def _mlstm_forward(cfg: ArchConfig, p: dict, x: torch.Tensor, state: dict) -> tuple:
    B, S, _ = x.shape
    x_in, z = L._proj(x, p["up_proj"]).chunk(2, dim=-1)  # (B, S, di)
    q, k, v, i_log, f_log = _mlstm_qkvif(cfg, p, x_in)
    hs = []
    for t in range(S):
        h, state = _mlstm_step(q[:, t], k[:, t], v[:, t], i_log[:, t], f_log[:, t], state)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, -1) * F.silu(z.float())
    return L._proj(y.to(x.dtype), p["down_proj"]), state


def mlstm_train(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return _mlstm_forward(cfg, p, x, init_mlstm_cache(cfg, x.shape[0], x.device))[0]


def mlstm_prefill(cfg: ArchConfig, p: dict, x: torch.Tensor) -> tuple:
    return _mlstm_forward(cfg, p, x, init_mlstm_cache(cfg, x.shape[0], x.device))


def mlstm_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, cache: dict) -> tuple:
    return _mlstm_forward(cfg, p, x, cache)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, di, H = cfg.d_model, _di(cfg), cfg.n_heads
    hd = di // H
    up = L.dense_init(gen, d, 2 * di, cfg.dtype)
    # the gates are block-diagonal per head (sLSTM's head-wise recurrence)
    w_gates = _block_diag(gen, 4 * H, hd, torch.float32).reshape(4, H, hd, hd)  # i, f, z, o
    return {
        "up_proj": up,
        "w_gates": w_gates,
        "r_gates": L._randn(gen, (4, di)) * 0.1,
        "b_gates": L._zeros(gen, 4 * di, torch.float32),
        "down_proj": L.dense_init(gen, di, d, cfg.dtype),
    }


def init_slstm_cache(cfg: ArchConfig, batch: int, device) -> dict:
    di = _di(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, di), **f32),
        "n": torch.ones((batch, di), **f32),
        "h": torch.zeros((batch, di), **f32),
        "m": torch.full((batch, di), -1e30, **f32),
    }


def _slstm_step(gx: torch.Tensor, state: dict, r: torch.Tensor) -> dict:
    """gx (B, 4*di) input-gate preactivations; diagonal recurrence via r."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    gi, gf, gz, go = gx.chunk(4, dim=-1)
    gi = gi + r[0] * h
    gf = gf + r[1] * h
    gz = gz + r[2] * h
    go = go + r[3] * h
    f_log = F.logsigmoid(gf)
    m_new = torch.maximum(f_log + m, gi)
    i_g = torch.exp(gi - m_new)
    f_g = torch.exp(f_log + m - m_new)
    c = f_g * c + i_g * torch.tanh(gz)
    n = f_g * n + i_g
    h = torch.sigmoid(go) * c / torch.maximum(n, _ONE)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_forward(cfg: ArchConfig, p: dict, x: torch.Tensor, state: dict) -> tuple:
    B, S, _ = x.shape
    H = cfg.n_heads
    x_in, z = L._proj(x, p["up_proj"]).chunk(2, dim=-1)
    di = x_in.shape[-1]
    xh = x_in.reshape(B, S, H, di // H).float()
    gx = torch.einsum("bshd,ghde->gbshe", xh, p["w_gates"])  # (4, B, S, H, hd)
    gx = gx.reshape(4, B, S, di).permute(1, 2, 0, 3).reshape(B, S, 4 * di) + p["b_gates"]
    hs = []
    for t in range(S):
        state = _slstm_step(gx[:, t], state, p["r_gates"])
        hs.append(state["h"])
    y = torch.stack(hs, dim=1) * F.silu(z.float())
    return L._proj(y.to(x.dtype), p["down_proj"]), state


def slstm_train(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return _slstm_forward(cfg, p, x, init_slstm_cache(cfg, x.shape[0], x.device))[0]


def slstm_prefill(cfg: ArchConfig, p: dict, x: torch.Tensor) -> tuple:
    return _slstm_forward(cfg, p, x, init_slstm_cache(cfg, x.shape[0], x.device))


def slstm_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, cache: dict) -> tuple:
    return _slstm_forward(cfg, p, x, cache)
