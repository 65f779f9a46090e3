"""Sweep the paged-attention kernel's split count on the card.

    python -m repro_torch.kernels.paged_attention.sweep [--runs N]

At qwen2-0.5b's decode shape (8 sequences, 2 kv heads, G 7, hd 64, 16-token
pages, a table of 136 pages over pools of 204 pages per sequence and head,
K/V and q drawn from a seeded generator, each table a random choice of pool
pages) it runs every (case, splits) of the grid below. The cases: bf16 and
float32 at len 1,056 (the serve phase's decode shape), bf16 at ragged lens
drawn between 16 and 2,048, and bf16 at len 64 (one chunk per sequence: the
launch's fixed cost). For each it prints one JSON line: the kernel's mean
device time from a torch.profiler trace of ``--runs`` calls, the 50 MB L2
flushed before each call (null where the trace does not hold exactly one
kernel event per call), and the largest difference from the plain version.
The last line names the fastest split count of each case and the wrapper's
default. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels.paged_attention import ops

B, KVH, G, HD, PAGE, PPS, N_POOL = 8, 2, 7, 64, 16, 136, 204
SPLITS = (1, 2, 3, 4, 6, 9, 12, 17, 34)


def device_ms(fn, flush: torch.Tensor, runs: int, attempts: int = 3) -> float | None:
    """Mean device time of the kernel (one launch a call, its name holds
    ``paged_attn``) over ``runs`` calls, each after an L2 flush; None when
    no trace of ``attempts`` holds exactly ``runs`` such events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                torch.bitwise_not(flush, out=flush)
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "paged_attn" in e.name]
        if len(us) == runs:
            return sum(us) / runs / 1e3
    return None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the sweep runs on a CUDA card only")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    pools = [torch.randn((B, KVH, N_POOL, PAGE, HD), generator=gen, device=dev)
             for _ in range(2)]
    btab = torch.stack([torch.randperm(N_POOL, generator=gen, device=dev)[:PPS]
                        for _ in range(B)]).to(torch.int32)
    cases = {
        "bf16 len 1056": (torch.bfloat16, torch.full((B,), 1056, dtype=torch.int32, device=dev)),
        "float32 len 1056": (torch.float32, torch.full((B,), 1056, dtype=torch.int32,
                                                       device=dev)),
        "bf16 ragged": (torch.bfloat16, torch.randint(16, 2049, (B,), generator=gen, device=dev,
                                                      dtype=torch.int32)),
        "bf16 len 64": (torch.bfloat16, torch.full((B,), 64, dtype=torch.int32, device=dev)),
    }
    best = {}
    for label, (dtype, lens) in cases.items():
        q = torch.randn((B, KVH, G, HD), generator=gen, device=dev).to(dtype)
        k, v = (p.to(dtype) for p in pools)
        want = ops.paged_attention_plain(q, k, v, btab, lens).float()
        for splits in SPLITS:
            call = lambda: ops._launch(q, k, v, btab, lens, splits)  # noqa: E731
            err = float((call().float() - want).abs().max())
            ms = device_ms(call, flush, args.runs)
            row = dict(case=label, lens=lens.tolist(), splits=splits, ms=ms, max_abs_err=err)
            print(json.dumps(row), flush=True)
            if ms is not None and (label not in best or ms < best[label]["ms"]):
                best[label] = row
        if label in best:
            best[label]["default_splits"] = ops._n_splits(dev, B * KVH, PPS * PAGE, PAGE)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "best": best}), flush=True)


if __name__ == "__main__":
    main()
