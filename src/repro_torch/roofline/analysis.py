"""Roofline analysis over the port's dry-run artifacts (port of
``repro.roofline.analysis``).

Per (arch x shape x mesh) cell, three per-device time lower bounds on an
NVIDIA H100 SXM5 80GB:

    compute term    = FLOPs_per_device              / 989e12  FLOP/s (bf16 dense)
    memory term     = bytes_per_device              / 3.35e12 B/s (HBM3)
    collective term = collective_bytes_per_device   / 450e9   B/s (NVLink 4)

Sources & corrections (all recorded per cell):
  * ``launch.dryrun`` counts one rank's local ops (per device). The port's
    layer loop is Python, so every layer, cross-entropy chunk and attention
    chunk is counted; two corrections remain, as in the reference:
      - gradient accumulation: flops/bytes are multiplied by
        ``micro_batches``, the reference's record schema (its count holds
        the micro-batch scan body once; the port's dry run records its
        whole-step count over the micro-batches, so the product is the
        step's count);
      - mixer time-scans (mamba chunk scan, xLSTM step scan): their
        per-trip body cost is added analytically (``time_scan_correction``),
        as their elementwise recurrences hold no matmul for the count.
  * ``bytes accessed`` is eager PyTorch's: every op's inputs and outputs,
    nothing fused, so the memory term is an upper bound on the fused one.
  * collective bytes are the result bytes of the collectives the step
    issues; per op kind the ring-transfer factor is applied (all-gather /
    reduce-scatter move (n-1)/n of the result bytes per device; all-reduce
    2(n-1)/n; all-to-all and collective-permute (n-1)/n and 1x
    respectively).
  * The link rate is NVLink 4's per direction per GPU within one 8-GPU
    node. A group that spans nodes is slower (one 400 Gb/s NIC per GPU,
    50e9 B/s), so the collective term is a lower bound, as the
    reference's is.
  * MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for training cells;
    2*N*D_new for decode. The ratio MODEL_FLOPS / FLOPs_global flags
    remat/redundancy waste.

Usage (no GPU needed):
    python -m repro_torch.roofline.analysis --dir experiments/dryrun_torch
"""
from __future__ import annotations

import json
import os

from repro_torch import configs as config_lib
from repro_torch.configs.base import SHAPE_SPECS

PEAK_FLOPS = 989e12  # bf16 dense FLOP/s, NVIDIA H100 SXM5 80GB (datasheet)
HBM_BW = 3.35e12  # B/s HBM3, NVIDIA H100 SXM5 80GB (datasheet)
LINK_BW = 450e9  # B/s NVLink 4 per direction per GPU, NVIDIA H100 SXM5 (datasheet)

RING = {  # effective bytes-on-link per result byte, ring algorithms
    "all-gather": 1.0,  # (n-1)/n ~ 1
    "all-reduce": 2.0,  # reduce-scatter + all-gather
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def _default_dir() -> str:
    from repro_torch.launch.dryrun import OUT_DIR

    return OUT_DIR


# ---------------------------------------------------------------------------
# analytic model FLOPs
# ---------------------------------------------------------------------------
def model_flops(arch: str, shape_name: str) -> float:
    """6*N_active*D for train; 2*N_active per generated token for decode;
    2*N_active*D for prefill. Attention's quadratic term is excluded by
    convention (it is what the ratio column exposes)."""
    cfg = config_lib.get(arch)
    spec = SHAPE_SPECS[shape_name]
    n = cfg.active_param_count()
    if spec["kind"] == "train":
        d = spec["global_batch"] * spec["seq_len"]
        return 6.0 * n * d
    if spec["kind"] == "prefill":
        d = spec["global_batch"] * spec["seq_len"]
        return 2.0 * n * d
    # decode: one token per sequence
    return 2.0 * n * spec["global_batch"]


def time_scan_correction(arch: str, shape_name: str) -> float:
    """Global FLOPs hidden inside the mixer time-scans:
    (trips - 1) x analytic per-trip body cost x (1 fwd + 2 bwd [+1 remat])."""
    cfg = config_lib.get(arch)
    spec = SHAPE_SPECS[shape_name]
    if spec["kind"] == "decode":
        return 0.0  # decode does exactly one time step (counted)
    B, S = spec["global_batch"], spec["seq_len"]
    grad_mult = 4.0 if spec["kind"] == "train" else 1.0  # fwd+bwd+remat
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "mamba":
            di = cfg.ssm_expand * cfg.d_model
            ds = cfg.ssm_state
            chunk = 16
            trips = -(-S // chunk)
            body = 10.0 * B * chunk * di * ds  # recurrence arithmetic
            total += (trips - 1) * body * grad_mult
        elif kind == "mlstm":
            di = 2 * cfg.d_model
            hd = di // cfg.n_heads
            body = 7.0 * B * cfg.n_heads * hd * hd  # outer products + Cq
            total += (S - 1) * body * grad_mult
        elif kind == "slstm":
            di = 2 * cfg.d_model
            body = 30.0 * B * di  # elementwise gates
            total += (S - 1) * body * grad_mult
    return total


# ---------------------------------------------------------------------------
# per-cell roofline
# ---------------------------------------------------------------------------
def micro_batches_of(arch: str, shape_name: str) -> int:
    from repro_torch.launch.dryrun import TRAIN_RECIPE

    if SHAPE_SPECS[shape_name]["kind"] != "train":
        return 1
    return TRAIN_RECIPE.get(arch, {"micro_batches": 1})["micro_batches"]


def analyze_cell(record: dict) -> dict:
    """Dry-run JSON record -> roofline terms (seconds) + diagnosis."""
    arch, shape_name = record["arch"], record["shape"]
    n_dev = record["n_devices"]
    micro = micro_batches_of(arch, shape_name)
    cost = record.get("cost_analysis", {})
    flops_dev = cost.get("flops", 0.0) * micro
    bytes_dev = cost.get("bytes accessed", 0.0) * micro
    flops_dev += time_scan_correction(arch, shape_name) / n_dev

    coll = record.get("collectives", {}).get("bytes", {})
    coll_bytes_dev = sum(RING[k] * v for k, v in coll.items())

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_bytes_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(arch, shape_name)
    global_flops = flops_dev * n_dev
    return dict(
        arch=arch, shape=shape_name, mesh=record["mesh"], n_devices=n_dev,
        micro_batches=micro,
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll_bytes_dev,
        collective_detail=coll,
        t_compute_s=t_compute, t_memory_s=t_memory, t_collective_s=t_coll,
        dominant=dominant,
        step_lower_bound_s=bound,
        model_flops_global=mf,
        useful_flops_ratio=(mf / global_flops) if global_flops else 0.0,
        roofline_fraction=(t_compute / bound) if bound else 0.0,
        memory_analysis=record.get("memory_analysis", {}),
    )


def load_records(dryrun_dir: str | None = None) -> list:
    dryrun_dir = dryrun_dir or _default_dir()
    out = []
    for f in sorted(os.listdir(dryrun_dir)):
        if f.endswith(".json"):
            with open(os.path.join(dryrun_dir, f)) as fh:
                out.append(json.load(fh))
    return out


def table(dryrun_dir: str | None = None, mesh: str = "single") -> list:
    rows = []
    for rec in load_records(dryrun_dir):
        if rec.get("status") == "ok" and rec.get("mesh") == mesh:
            rows.append(analyze_cell(rec))
    return rows


def format_markdown(rows: list) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| 6ND/FLOPs | roofline frac |\n|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4g} "
            f"| {r['t_memory_s']:.4g} | {r['t_collective_s']:.4g} "
            f"| {r['dominant']} | {r['useful_flops_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None, help="dry-run records (default: the dry run's OUT_DIR)")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    print(format_markdown(table(args.dir, args.mesh)))


if __name__ == "__main__":
    main()
