"""Training from the command line (port of ``repro.launch.train``, same
options and log lines): the seeded token pipeline, AdamW (or what
``train.optimizer`` offers), micro-batches, int8 gradient compression,
checkpoints every ``--save-every`` steps and a resume from ``LATEST``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --reduced --steps 100 --ckpt-dir /tmp/ckpt [--device cpu]

It runs on the CUDA card unless ``--device`` names another device; weights
are random, from seed 0. ``--mesh single`` (``multi``: with a leading pod
axis) trains data-parallel on ``launch.mesh.make_production_mesh``, one
rank per card, inside a job that ``launch.multihost`` starts (each rank
runs this module; NCCL on CUDA, gloo on the CPU): every rank takes its rows
of each global batch, the gradients are summed over the data axes, and the
result is the one-device step's over the global batch. The mesh must have
as many places as the job has ranks (``DEFAULT_DATA x DEFAULT_MODEL``,
x ``DEFAULT_PODS``), else it raises naming both counts. Rank 0 logs and
writes the checkpoints; every rank resumes from them.

    python -c "from repro_torch.launch import multihost; multihost.launch(
        'src/repro_torch/launch/train.py', num_processes=256,
        args=('--mesh', 'single', '--steps', '100'))"
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs as config_lib
from repro_torch.data import pipeline
from repro_torch.kernels import runtime
from repro_torch.launch import multihost
from repro_torch.launch.mesh import make_dist, make_production_mesh
from repro_torch.models import registry
from repro_torch.models.dist import NO_DIST
from repro_torch.train import checkpoint, fault, optimizer, trainer
from repro_torch.train import tree as tr


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--mesh", default="none", choices=("none", "single", "multi"))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dist = NO_DIST
    if args.mesh != "none":
        if not torch.distributed.is_initialized():
            multihost.initialize()  # a no-op for one process
        dist = make_dist(make_production_mesh(multi_pod=args.mesh == "multi",
                                              device=args.device))
        device = dist.mesh.device
    else:
        device = runtime.resolve_device(args.device)
    log = print if dist.is_coordinator else (lambda *a, **k: None)
    cfg = config_lib.reduced(args.arch) if args.reduced else config_lib.get(args.arch)
    model = registry.build(cfg)
    tcfg = trainer.TrainConfig(
        micro_batches=args.micro_batches, compress_grads=args.compress_grads,
        opt=optimizer.OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10),
                                total_steps=args.steps))
    spec = pipeline.DataSpec(vocab=cfg.vocab, seq_len=args.seq_len,
                             global_batch=args.global_batch)

    params = model.init(seed=0, device=device)
    train_state = trainer.init_train_state(tcfg, params)
    data_state = pipeline.DataState()
    supervisor = None
    if args.ckpt_dir:
        supervisor = fault.Supervisor(args.ckpt_dir, save_every=args.save_every)
        if supervisor.resume_step():
            like = {"params": params, "train_state": train_state,
                    "data_step": torch.tensor(0)}
            restored, man = checkpoint.restore(args.ckpt_dir, like)
            params, train_state = restored["params"], restored["train_state"]
            data_state = pipeline.DataState(step=int(restored["data_step"]))
            log(f"[train] resumed from step {man['step']}")

    step_fn = trainer.make_train_step(model, tcfg, dist)
    n_params = sum(p.numel() for p in tr.leaves(params))
    log(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.global_batch}x{args.seq_len}")

    t0 = time.time()
    start = int(train_state["opt"]["step"])
    mets, writing = None, []
    for step in range(start, args.steps):
        batch, data_state = pipeline.next_batch(spec, data_state)
        params, train_state, mets = step_fn(params, train_state,
                                            trainer.batch_to(batch, device))
        if supervisor:
            writing.append(supervisor.maybe_save(
                step + 1, {"params": params, "train_state": train_state,
                           "data_step": torch.tensor(data_state.step)}, dist=dist))
        if (step + 1) % args.log_every == 0 or step == start:
            tps = (step + 1 - start) * args.global_batch * args.seq_len / (time.time() - t0)
            log(f"[train] step {step + 1:5d} loss {float(mets['loss']):.4f} "
                  f"lr {float(mets['lr']):.2e} gnorm "
                  f"{float(mets['grad_norm']):.2f} ({tps:.0f} tok/s)")
    for t in writing:  # a checkpoint's thread must finish before the process ends
        if t is not None:
            t.join()
    if mets is None:
        log(f"[train] nothing to do: the checkpoint is at step {start} of {args.steps}")
        return float("nan")
    log(f"[train] done in {time.time() - t0:.1f}s; final loss {float(mets['loss']):.4f}")
    return float(mets["loss"])


if __name__ == "__main__":
    main()
