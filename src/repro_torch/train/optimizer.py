"""Optimizers on trees of tensors (port of ``repro.train.optimizer``):
AdamW and Adafactor, with the learning-rate schedule and global-norm
clipping, in the reference's float32 arithmetic, operation for operation.

The state is float32 whatever the params' dtype. :func:`update` writes the
new params and moments into the tensors it is given (in place: a model
whose state fills the card cannot hold a second copy) and returns the same
trees; the gradients are read, never written. A stacked leaf (rank 3 and
up: layer groups, expert banks) is updated one slice of its leading axis
at a time, so that the float32 temporaries of one update stay a slice's
size; every operation but Adafactor's RMS of the whole leaf is elementwise
or within a slice, so only that sum changes order.

Under data parallelism every rank holds the whole state and updates it
alike from the reduced gradients. The reference's docstring names a
``launch.sharding.zero1_specs`` that does not exist: its ZeRO-1 rule is
``launch.sharding.opt_specs`` (ported: ``repro_torch.launch.sharding``),
which no trainer applies yet (ROADMAP item 15d).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.train import tree as tr


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (float32)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of each leaf's summed
    float32 squares."""
    total = 0
    for g in tr.leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def _clip_scale(grads, max_norm: float) -> tuple:
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float) -> tuple:
    """(grads scaled to a global norm of at most ``max_norm``, as float32,
    the norm before clipping)."""
    scale, norm = _clip_scale(grads, max_norm)
    return tr.map(lambda g: g.float() * scale, grads), norm


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    dev = tr.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(params) -> dict:
    return {"m": tr.map(_zeros32, params), "v": tr.map(_zeros32, params),
            "step": _step0(params)}


def adamw_update(cfg: OptConfig, grads, state: dict, params) -> tuple:
    step = state["step"] + 1
    lr = schedule(cfg, step)
    scale, gnorm = _clip_scale(grads, cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** sf, 1 - b2 ** sf

    def upd(g, m, v, p):
        g = g.float() * scale  # the clipped gradient, float32 as the reference's
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)

    for (_, g), (_, m), (_, v), (_, p) in zip(tr.items(grads), tr.items(state["m"]),
                                              tr.items(state["v"]), tr.items(params)):
        for sl in _slices(p):
            upd(g[sl], m[sl], v[sl], p[sl])
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments)
# ---------------------------------------------------------------------------
def adafactor_init(params) -> dict:
    def per_leaf(p):
        if p.dim() >= 2:
            f32 = dict(dtype=torch.float32, device=p.device)
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": _zeros32(p)}

    return {"f": tr.map(per_leaf, params), "step": _step0(params)}


def adafactor_update(cfg: OptConfig, grads, state: dict, params) -> tuple:
    step = state["step"] + 1
    lr = schedule(cfg, step)
    scale, gnorm = _clip_scale(grads, cfg.grad_clip)
    decay = 1.0 - step.to(torch.float32) ** -0.8

    def factors(g, f):
        """Decay one slice's second-moment factors towards its g**2."""
        g2 = g * g + 1e-30
        if g.dim() >= 2:
            f["vr"].copy_(decay * f["vr"] + (1 - decay) * g2.mean(-1))
            f["vc"].copy_(decay * f["vc"] + (1 - decay) * g2.mean(-2))
        else:
            f["v"].copy_(decay * f["v"] + (1 - decay) * g2)

    def unclipped(g, f):
        """One slice's update before the RMS clip, from its factors."""
        if g.dim() >= 2:
            vr, vc = f["vr"], f["vc"]
            denom = (vr[..., None] * vc[..., None, :]) / torch.clamp(
                vr.mean(-1, keepdim=True)[..., None], min=1e-30)
            return g / torch.sqrt(denom + 1e-30)
        return g / torch.sqrt(f["v"] + 1e-30)

    def apply(u, p, rms):
        pf = p.float()
        p.copy_(pf - lr * (u / torch.clamp(rms, min=1.0) + cfg.weight_decay * pf))

    for (path, g), (_, p) in zip(tr.items(grads), tr.items(params)):
        f = _node(state["f"], path)
        slices = _slices(p)

        def part(sl):
            return g[sl].float() * scale, {k: t[sl] for k, t in f.items()}

        if len(slices) == 1:
            gs, fs = part(slices[0])
            factors(gs, fs)
            u = unclipped(gs, fs)
            apply(u, p, torch.sqrt(torch.mean(u ** 2) + 1e-30))  # the update's RMS clip
            continue
        # a stacked leaf: the factors and the sum of u**2 slice by slice,
        # then each slice's u again from the updated factors (the same values)
        sq = 0
        for sl in slices:
            gs, fs = part(sl)
            factors(gs, fs)
            sq = sq + torch.sum(unclipped(gs, fs) ** 2)
        rms = torch.sqrt(sq / p.numel() + 1e-30)
        for sl in slices:
            gs, fs = part(sl)
            apply(unclipped(gs, fs), p[sl], rms)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


def _slices(p: torch.Tensor) -> list:
    """Index of each slice of a stacked leaf's leading axis (rank 3 and
    up), or of the whole leaf."""
    return list(range(p.shape[0])) if p.dim() >= 3 else [slice(None)]


def _node(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def init(cfg: OptConfig, params) -> dict:
    return adamw_init(params) if cfg.name == "adamw" else adafactor_init(params)


def update(cfg: OptConfig, grads, state: dict, params) -> tuple:
    """-> (params, state, {"lr", "grad_norm"}); params and state updated in
    place."""
    fn = adamw_update if cfg.name == "adamw" else adafactor_update
    return fn(cfg, grads, state, params)
