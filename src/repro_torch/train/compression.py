"""Gradient compression (port of ``repro.train.compression``): int8 block
quantization with error feedback. Each gradient leaf, plus the residual
left by the last step, is quantized in blocks of :data:`BLOCK` values to
int8 codes and one float32 scale a block, and dequantized; the new residual
is what the codes missed, so that the sum of the dequantized gradients
follows the sum of the true ones.

The codes, scales and error state are the reference's bit for bit as XLA
compiles it (its train step is jitted): ``torch.round`` rounds half to
even as ``jnp.round`` does; the scale's ``/ 127.0`` is a multiply by the
float32 reciprocal (ROADMAP §3, Fault 1: XLA rewrites a division by a
constant so); the error ``x - q * scale`` is one fused multiply-add,
computed here in float64, where it is exact (|x| and q * scale lie within
a factor of two of each other, or q is 0), and rounded once. An eager
reference call divides and rounds the product first: its scales differ in
the last bit in a few blocks.
"""
from __future__ import annotations

import torch

from repro_torch.train import tree as tr

BLOCK = 256  # values per quantization block
CHUNK = BLOCK << 16  # values of a leaf compressed at a time (whole blocks)
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _quant_block(x: torch.Tensor) -> tuple:
    """x (..., BLOCK) float32 -> (int8 codes, float32 scale (..., 1))."""
    scale = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True) * _INV127, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_leaf(g: torch.Tensor) -> tuple:
    """-> (codes (n_blocks, BLOCK), scales (n_blocks, 1), g's shape, pad)."""
    flat = g.reshape(-1).float()
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    q, scale = _quant_block(flat.reshape(-1, BLOCK))
    return q, scale, tuple(g.shape), pad


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, shape: tuple, pad: int) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def init_error(params) -> dict:
    return tr.map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_grads_(grads, err) -> tuple:
    """In place: each gradient leaf becomes its dequantized value (in its
    own dtype) and each error leaf e becomes (g + e) - deq(quant(g + e)).
    Returns (grads, err), the trees given. A leaf is taken CHUNK values at
    a time (whole blocks: the same result), so that its float32 and
    float64 temporaries stay small beside a model that fills the card."""
    for (_, g), (_, e) in zip(tr.items(grads), tr.items(err)):
        gf, ef = g.view(-1), e.view(-1)
        for c0 in range(0, gf.numel(), CHUNK):
            gc, ec = gf[c0:c0 + CHUNK], ef[c0:c0 + CHUNK]
            x = gc.float() + ec
            q, scale, shape, pad = quantize_leaf(x)
            # x - q * scale with one rounding, as XLA's FMA
            ec.copy_(x.double() - dequantize_leaf(q.double(), scale.double(), shape, pad))
            gc.copy_(dequantize_leaf(q, scale, shape, pad))
    return grads, err


def compress_grads(grads, err) -> tuple:
    """(grads, error state) -> (dequantized grads, new error state), new
    trees; the inputs are left as they are."""
    return compress_grads_(tr.map(torch.clone, grads), tr.map(torch.clone, err))


def compressed_bytes(params) -> int:
    """The payload of one compressed gradient exchange: int8 codes and
    float32 scales."""
    n = sum(p.numel() for p in tr.leaves(params))
    return n + (n // BLOCK + 1) * 4


def uncompressed_bytes(params, dtype_bytes: int = 2) -> int:
    return sum(p.numel() * dtype_bytes for p in tr.leaves(params))
