"""Compares the training step of two checkouts of this repository on one
card: chip_smoke.py's train phase for qwen2-0.5b at full size (AdamW,
launch/train.py's defaults, batch 8 x 256; 10 steps, 8 of them timed, a
checkpoint restored and continued, 2 steps profiled), each checkout in
fresh processes, in alternating order (A B B A A B ...):

    python3 train_ab.py CHECKOUT_A CHECKOUT_B [--rounds 2] [--out FILE]

Each process imports the checkout's own ``chip_smoke.py`` (and so its own
package) and prints one JSON line. The last line of the output is one JSON
object: for each checkout, every process's s per step (the median of its
timed steps) and the timed steps themselves, the median of the processes'
medians, their profiled device busy ms and idle share, the peak GB, and
the Python function calls a step (``cProfile`` over two more steps of a
fresh model: the host work the checkout's step asks for). Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys

PROFILE = ("device_busy_ms_per_step", "device_idle_share", "wall_s_per_step_profiled")


def python_calls_per_step(cs, device, tcfg, steps: int = 2) -> float:
    """Python function calls a step of qwen2-0.5b at full size (batch 8 x
    256), counted by cProfile over ``steps`` steps after an untimed one."""
    cfg = cs.configs.get("qwen2-0.5b")
    model = cs.model_registry.build(cfg)
    params = model.init(seed=0, device=device)
    state = cs.trainer.init_train_state(tcfg, params)
    step = cs.trainer.make_train_step(model, tcfg)
    spec = cs.pipeline.DataSpec(vocab=cfg.vocab, seq_len=cs.TRAIN_SEQ,
                                global_batch=cs.TRAIN_BATCH)
    data, batches = cs.pipeline.DataState(), []
    for _ in range(steps + 1):
        batch, data = cs.pipeline.next_batch(spec, data)
        batches.append(cs.trainer.batch_to(batch, device))
    params, state, mets = step(params, state, batches[0])
    float(mets["loss"])
    prof = cProfile.Profile()
    prof.enable()
    for batch in batches[1:]:
        params, state, mets = step(params, state, batch)
    float(mets["loss"])
    prof.disable()
    return pstats.Stats(prof).total_calls / steps


def child(checkout: str) -> None:
    os.chdir(checkout)
    sys.path.insert(0, checkout)
    import chip_smoke as cs

    device, smi = cs.device_phase()
    opt = dict(lr=cs.TRAIN_LR, warmup_steps=min(100, cs.TRAIN_STEPS // 10),
               total_steps=cs.TRAIN_STEPS)
    tcfg = cs.trainer.TrainConfig(opt=cs.optimizer.OptConfig(**opt))
    line = cs.train_phase("qwen2-0.5b", None, tcfg, device)
    calls = python_calls_per_step(cs, device, tcfg)
    print(json.dumps(dict(nvidia_smi=smi, s_per_step=line["s_per_step"],
                          s_per_step_all=line["s_per_step_all"], peak_gb=line["peak_gb"],
                          losses=line["losses"], python_calls_per_step=calls,
                          profile={k: line["profile"][k] for k in PROFILE})), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=2, help="pairs of processes per checkout")
    ap.add_argument("--out", help="also write each process's output here")
    args = ap.parse_args()
    dirs = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    order = [("a", "b") if i % 2 == 0 else ("b", "a") for i in range(args.rounds)]
    order = [k for pair in order for k in pair]
    got: dict[str, list] = {"a": [], "b": []}
    log = open(args.out, "w") if args.out else None
    for i, key in enumerate(order):
        proc = subprocess.run([sys.executable, __file__, "--child", dirs[key]],
                              capture_output=True, text=True, timeout=600)
        if log:
            log.write(f"== {i} {key} {dirs[key]} rc={proc.returncode}\n"
                      f"{proc.stdout}{proc.stderr}\n")
            log.flush()
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise SystemExit(f"process {i} ({key}) exited {proc.returncode}")
        got[key].append(dict(json.loads(proc.stdout.strip().splitlines()[-1]), order=i))
        print(json.dumps({key: got[key][-1]}), flush=True)
    summary = {"order": "".join(order).upper()}
    for key, rows in got.items():
        summary[key] = dict(
            checkout=dirs[key],
            median_s_per_step=statistics.median(r["s_per_step"] for r in rows),
            python_calls_per_step=sorted({r["python_calls_per_step"] for r in rows}),
            median_profile={k: statistics.median(r["profile"][k] for r in rows)
                            for k in PROFILE},
            processes=rows)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        main()
