"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch (port
of ``repro.models.moe``).

Dispatch is the scatter/gather formulation: each (token, choice) pair is
written into an (E, C + 1, d) expert buffer at its position among the
pairs routed to its expert, in token-major order; pairs at positions >= C
are dropped into the spare row C, which is sliced away. Shared experts are
always-on experts computed densely and added. :func:`aux_loss` is
training's load-balance loss.

The capacity, the padded experts' -inf logits, the token-major positions,
the clamped gather that is zeroed where dropped and the float32 combine are
the reference's, step for step. ``jax.lax.top_k`` breaks ties towards the
lowest expert index; :func:`route` selects with a stable descending sort,
which does the same (``torch.topk`` promises no order among ties). At
decode T is the engine's ``max_seqs`` (idle slots included), so the
capacity is often 1 and drops are the normal case.

Data-parallel training (``dist`` with a mesh) computes what the reference
computes over the global batch: each DP rank holds its rows, the capacity
comes from the global token count, each rank's (token, choice) pairs take
their slots behind every earlier rank's (the per-expert counts are
all-gathered over the DP group), and :func:`aux_loss` divides by the global
token count with the top-1 counts summed over the ranks, so that the ranks'
losses and gradients sum to the reference's. A rank computes the expert
FFN of its own kept pairs only. With ``NO_DIST`` or a one-rank mesh the
collectives change nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.dist import NO_DIST


def pad_experts(cfg: ArchConfig) -> int:
    """Expert-bank size after padding (qwen2-moe: 60 -> 64). Padded experts
    get -inf router logits and are never selected."""
    return cfg.e_pad


def _bank(gen: torch.Generator, E: int, i: int, o: int, dtype) -> torch.Tensor:
    """E independent ``dense_init`` matrices, filled one expert at a time so
    that the float32 draw of a whole bank is never held at once."""
    bank = torch.empty((E, i, o), dtype=dtype, device=gen.device)
    if bank.is_meta:  # shapes only (``registry.param_shapes``)
        return bank
    for e in range(E):
        bank[e] = L.dense_init(gen, i, o, dtype)
    return bank


def init_moe(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, pad_experts(cfg)
    p = {
        "router": L.dense_init(gen, d, E, torch.float32),
        "experts": {
            "wi_gate": _bank(gen, E, d, ff, cfg.dtype),
            "wi_up": _bank(gen, E, d, ff, cfg.dtype),
            "wo": _bank(gen, E, ff, d, cfg.dtype),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(cfg, gen, d_ff=ff * cfg.n_shared_experts)
    return p


def capacity(cfg: ArchConfig, T: int) -> int:
    """Slots per expert for T tokens, in Python floats as the reference
    computes it; never more than T * top_k."""
    k = cfg.top_k
    return min(max(1, int(T * k / cfg.n_experts * cfg.capacity_factor)), T * k)


def route(cfg: ArchConfig, p: dict, xt: torch.Tensor) -> tuple:
    """xt (T, d) -> (float32 softmax weights (T, k), int64 experts (T, k)):
    the top-k router logits, ties to the lowest expert, padded experts
    never chosen."""
    logits = torch.matmul(xt.float(), p["router"])  # (T, E) float32
    E = logits.shape[-1]
    if E > cfg.n_experts:
        pad = torch.arange(E, device=xt.device) >= cfg.n_experts
        logits = torch.where(pad, float("-inf"), logits)
    vals, experts = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :cfg.top_k], dim=-1), experts[:, :cfg.top_k]


def dispatch_slots(cfg: ArchConfig, experts: torch.Tensor, cap: int, dist=NO_DIST) -> tuple:
    """(T, k) experts -> (flat experts (T*k,), each pair's position in its
    expert's buffer (T*k,), kept mask (T*k,)): positions count the earlier
    pairs on the same expert in token-major order. Under a mesh the pair is
    kept when its global position (behind the earlier DP ranks' pairs on
    its expert) is below ``cap``; the position returned is the rank's own."""
    flat_e = experts.reshape(-1)
    onehot = F.one_hot(flat_e, cfg.e_pad).to(torch.int32)  # (T*k, E)
    pos = ((torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot) * onehot).sum(-1)
    if dist.mesh is None:
        return flat_e, pos, pos < cap
    counts = dist.all_gather(onehot.sum(0, dtype=torch.int32), "moe_counts")  # (dp, E)
    before = counts[:dist.dp_rank()].sum(0, dtype=torch.int32)  # the earlier ranks' pairs
    return flat_e, pos, pos + before[flat_e] < cap


def apply_moe(cfg: ArchConfig, p: dict, x: torch.Tensor, dist=NO_DIST) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d); ``dist``: this DP rank's rows of the
    global batch."""
    B, S, d = x.shape
    E = p["experts"]["wi_gate"].shape[0]
    T, k = B * S, cfg.top_k
    xt = x.reshape(T, d)
    weights, experts = route(cfg, p, xt)
    cap = capacity(cfg, T * dist.dp_size())
    flat_e, pos, keep = dispatch_slots(cfg, experts, cap, dist)
    safe_pos = torch.where(keep, pos, cap).long()  # the drop row

    buf = torch.zeros((E, cap + 1, d), dtype=x.dtype, device=x.device)
    buf = dist.constrain(buf, dist.tp, None, None)
    xk = dist.constrain(xt.repeat_interleave(k, dim=0), dist.dp, None)  # token-major, as flat_e
    buf[flat_e, safe_pos] = xk
    buf = dist.constrain(buf[:, :cap], dist.tp, None, None)

    # the expert FFN, batched over E: float32 products of the buffer's dtype
    ex = p["experts"]
    h = F.silu(L.matmul_f32(buf, ex["wi_gate"])) * L.matmul_f32(buf, ex["wi_up"])
    out_buf = L.matmul_f32(h.to(buf.dtype), ex["wo"]).to(buf.dtype)  # (E, C, d)

    gathered = out_buf[flat_e, safe_pos.clamp(max=cap - 1)]  # (T*k, d)
    gathered = torch.where(keep[:, None], gathered, torch.zeros((), dtype=gathered.dtype,
                                                                device=x.device))
    combined = (gathered.reshape(T, k, d).float() * weights[..., None]).sum(dim=1)
    out = combined.to(x.dtype)
    if "shared" in p:
        out = out + L.apply_mlp(cfg, p["shared"], xt)
    return out.reshape(B, S, d)


def aux_loss(cfg: ArchConfig, p: dict, x: torch.Tensor, dist=NO_DIST) -> torch.Tensor:
    """Load-balance auxiliary loss (Switch): E * sum(f_e * p_e), float32.
    The gradient flows through the mean router probability p_e only; the
    top-1 counts f_e (``argmax``, ties to the lowest expert) carry none.
    Under a mesh both means are over the global tokens: the counts summed
    over the DP ranks, the rank's probabilities divided by the global
    count, so that the ranks' values sum to the reference's."""
    logits = torch.matmul(x.reshape(-1, x.shape[-1]).float(), p["router"])
    T, E = logits.shape
    if E > cfg.n_experts:
        logits = torch.where(torch.arange(E, device=x.device) >= cfg.n_experts,
                             float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    top1 = dist.psum(F.one_hot(torch.argmax(logits, dim=-1), E).float().sum(0), "moe_top1")
    n = T * dist.dp_size()
    return cfg.n_experts * torch.sum(top1 / n * (probs.sum(0) / n))
