"""Serving from the command line: continuous batching over the GPAC-tiered
paged KV cache (port of ``repro.launch.serve``, same options and summary).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --reduced \
        --requests 8 --max-new 16 [--device cpu]

It runs on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as config_lib
from repro_torch.kernels import runtime
from repro_torch.models import registry
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.scheduler import Request, SchedulerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seqs", type=int, default=4)
    ap.add_argument("--max-seq-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--near-fraction", type=float, default=0.4)
    ap.add_argument("--no-gpac", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = runtime.resolve_device(args.device)
    cfg = (config_lib.reduced(args.arch) if args.reduced
           else config_lib.get(args.arch))
    cfg = cfg.replace(page_size=args.page_size)
    model = registry.build(cfg)
    params = model.init(seed=0, device=device)
    ecfg = EngineConfig(
        max_seqs=args.max_seqs, max_seq_len=args.max_seq_len,
        pages_per_block=4, near_fraction=args.near_fraction,
        sched=SchedulerConfig(max_seqs=args.max_seqs, maintenance_every=8,
                              use_gpac=not args.no_gpac, reserve_tokens=8))
    eng = Engine(model, params, ecfg, device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len).tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.sched.submit(r)

    t0 = time.time()
    eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in reqs)
    stats = eng.stats()
    print(f"[serve] {cfg.name}: {len(reqs)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks/dt:.1f} tok/s) on {device.type}")
    print(f"[serve] near capacity used {stats['near_capacity_used']:.1%}, "
          f"KV hit rate {stats['hit_rate']:.3f}, "
          f"consolidated pages {stats['consolidated_pages']}, "
          f"blocks promoted/demoted {stats['promoted_blocks']}/"
          f"{stats['demoted_blocks']}")
    for r in reqs[:3]:
        print(f"[serve] req {r.rid}: {r.out[:8]}...")
    return stats


if __name__ == "__main__":
    main()
