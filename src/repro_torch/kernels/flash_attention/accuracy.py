"""How close K7's bf16 kernel and its plain version come to a float64
softmax, on the card:

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.accuracy

For each case (random normal q, k, v in bf16, causal; q scaled to make the
scores ``scale`` times their usual size) it prints one JSON line: how many
bf16 outputs of the kernel lie outside the card tests' tolerance (atol 1e-6,
rtol 2^-7) of the plain version, how many of each lie outside it of the
float64 result rounded to bf16, and the largest difference in units of that
tolerance (above 1: outside). At large scores one float32 rounding of a
score moves a probability by more than 1e-6, so two float32 versions can
disagree there by more than the tolerance whatever the kernel does.
"""
from __future__ import annotations

import json

import torch

from repro_torch.kernels.flash_attention import ops

TOL = dict(atol=1e-6, rtol=2 ** -7)
CASES = (  # (label, B, H, KVH, S, hd, score scale)
    ("scores x1, hd 128, S 9", 40, 28, 4, 9, 128, 1),
    ("scores x4", 4, 14, 2, 1024, 64, 4),
    ("scores x8", 2, 14, 2, 300, 64, 8),
    ("scores x8, S 1,024", 4, 14, 2, 1024, 64, 8),
)


def _ratio(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| over the tolerance at want, element by element."""
    got, want = got.double(), want.double()
    return (got - want).abs() / (TOL["atol"] + TOL["rtol"] * want.abs())


def _float64(q, k, v) -> torch.Tensor:
    B, H, S, hd = q.shape
    KVH = k.shape[1]
    s = torch.einsum("bkgqd,bksd->bkgqs", q.double().reshape(B, KVH, H // KVH, S, hd),
                     k.double()) * hd ** -0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1),
                      float("-inf"))
    return torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, -1),
                        v.double()).reshape(B, H, S, hd)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cpu").manual_seed(3)
    for label, B, H, KVH, S, hd, scale in CASES:
        q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16).cuda()
                   for shape in ((B, H, S, hd), (B, KVH, S, hd), (B, KVH, S, hd)))
        q = q * scale
        got = ops.flash_attention(q, k, v, causal=True)
        want = ops.gqa_attention_plain(q, k, v, causal=True)
        exact = _float64(q, k, v).to(torch.bfloat16)
        line = dict(case=label, outputs=got.numel())
        for key, (a, b) in dict(kernel_vs_plain=(got, want), kernel_vs_float64=(got, exact),
                                plain_vs_float64=(want, exact)).items():
            r = _ratio(a, b)
            line[f"{key}_outside"] = int((r > 1).sum())
            line[f"{key}_worst"] = float(r.max())
        print(json.dumps(dict(line, device=torch.cuda.get_device_name(0))), flush=True)


if __name__ == "__main__":
    main()
