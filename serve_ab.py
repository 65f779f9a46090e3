"""Compares the serving path of two checkouts of this repository on one
card: chip_smoke.py's serve phase (qwen2-0.5b at full width, 16 requests
of 1,024 + 32 tokens; GPAC off and on through the kernels, then the plain
versions) and its profile of four decode steps, each checkout in fresh
processes, in alternating order (A B B A A B ...):

    python3 serve_ab.py CHECKOUT_A CHECKOUT_B [--rounds 3] [--out FILE]

Each process imports the checkout's own ``chip_smoke.py`` (and so its own
package and kernels, built into its own ``build/``) and prints one JSON
line. The last line of the output is one JSON object: for each checkout,
every process's s per decode step (median over the run's steps) for each
of the three runs, their medians, and the profile's device busy ms, idle
share and device operations per step. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

RUNS = ("kernels_gpac_off", "kernels_gpac_on", "plain_gpac_on")
PROFILE = ("device_busy_ms_per_step", "device_idle_share", "device_ops_per_step",
           "wall_s_per_step_profiled")


def child(checkout: str) -> None:
    os.chdir(checkout)
    sys.path.insert(0, checkout)
    import chip_smoke as cs
    import torch

    device, smi = cs.device_phase()
    cs.build_phase()
    model, params = cs.serve_model(device)
    line, eng, _ = cs.serve_phase(model, params, device)
    del eng
    torch.cuda.empty_cache()
    prof = cs.serve_profile_phase(model, params, device)
    print(json.dumps(dict(
        nvidia_smi=smi,
        s_per_decode_step={k: line["runs"][k]["s_per_decode_step"] for k in RUNS},
        decode_steps={k: line["runs"][k]["decode_steps"] for k in RUNS},
        prefill_s={k: line["runs"][k]["prefill_s"] for k in RUNS},
        profile={k: prof[k] for k in PROFILE})), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=3, help="pairs of processes per checkout")
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
            median_s_per_decode_step={
                k: statistics.median(r["s_per_decode_step"][k] for r in rows) for k in RUNS},
            median_profile={k: statistics.median(r["profile"][k] for r in rows)
                            for k in PROFILE},
            processes=rows)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        main()
