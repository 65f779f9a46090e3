#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc, at
first use), then, printing one JSON line per phase:

1. device -- the card's name and power limit (nvidia-smi);
2. build  -- the kernel build, timed;
3. kernels -- every kernel of the engine's main path at the full-width
   shapes the main path gives it, held bit for bit to its plain PyTorch
   version on the same inputs (tolerance: exact, the kernels are integer
   arithmetic and bit copies), timed beside the plain version, one library
   call computing the same function, and the least time the card could take
   (bytes over 3.35 TB/s, operations over 67 TFLOP/s), and bincount once
   more on the host histogram's pairs shuffled (no runs of equal ids); after
   the serve phase, the same for the serving path's kernels at its shapes:
   the paged-attention kernel at the full-width decode shape in bf16 and
   float32 and in bf16 at ragged lens drawn between 16 and 2,048 (tolerance
   below, SERVE_TOL), and hot_count at 4 pages per block, gather_rows on
   8-byte rows and topk_rows on the one-daemon filter row, bit for bit. A
   kernel row times the whole wrapper call: topk_rows is six launches on a
   wide row (four radix passes, a compaction and a sort, ``topk_rows_*``)
   and one on a row of at most 2,048 keys; paged_attention and bincount are
   one launch each (the serving rows' trace must show K6 as one kernel);
4. engine -- one Redis guest at the paper's size (3,276,800 4 KiB pages,
   2 MB huge pages, 16.8 GB of payload pools on the card) run through
   ``engine.run`` for 16 memtierd windows and 4 each of autonuma and tpp,
   twice through the kernels and twice with ``kernel_backend="torch"``, in
   turns: final states and series must be identical, every kernel must have
   launched in each kernel run, and every page must still read back its
   initial payload;
5. profile -- four memtierd windows through the kernels under
   torch.profiler: the device's busy time and idle share per window, the
   four kernels' share of the busy time, and device time by kernel name;
6. churn -- a five-guest fleet (masim, redis, memcached, hash, ocean_ncp at
   0.4 x their paper Table 2 RSS in 4 KiB pages, rounded down to a
   multiple of 512: 4,990,464 pages, 25.6 GB of payload pools) through
   ``engine.run_churn`` for 12 memtierd windows of 524,288 accesses per
   guest under a fixed fault schedule (a crash and a later restart, a
   reboot, a shrink of the near tier to 0.7 x n_near and its grow-back, a
   telemetry dropout), twice through the kernels and twice with
   ``kernel_backend="torch"``, in turns: final carries and series must be
   identical, K1-K4 must launch in each kernel run and nothing in a plain
   run, the ``active`` series must follow the schedule, the crashed
   guest's near blocks must be 0 from its crash window on, the pressure
   controller must engage under the shrink and be idle after the
   grow-back, allocated near usage must stay within n_near, the untouched
   guests' pages must read back their initial payload and the crashed and
   rebooted guests' pages zeros; then a no-fault ``run_churn`` over 4
   windows must equal ``engine.run`` over them bit for bit;
7. reference -- the same fleet with no faults, 4 memtierd windows through
   ``engine.run_reference`` (the per-guest oracle) and ``engine.run``, both
   through the kernels: final states and the hits/near_blocks series must
   be identical; both s/window printed;
8. serve -- qwen2-0.5b at full width in bf16 (random weights from a seeded
   torch.Generator) through ``repro_torch.serve.engine.Engine``: 16 requests
   of 1,024 prompt tokens and 32 new tokens, 8 sequences of up to 2,048
   tokens in 16-token pages, GPAC every 8 decode steps. The batch runs
   through the kernels with GPAC off and with GPAC on (the token streams
   must be identical, GPAC must consolidate pages, and paged_attention must
   launch 24 times per decode step), then with ``kernel_backend="torch"``
   (the first decode step's logits must agree with the kernel run's within
   SERVE_TOL); then four decode steps under torch.profiler;
9. registry -- the kernel registry's public entry points, the path of the
   kernels no model calls: ``consolidate_region`` and ``scatter_region``
   (K5a/K5b) on one 512-slot region of the engine's far row space
   (3,276,800 x 1,024 float32, 13.4 GB, filled as the engine phase fills
   it; the last 64 slots -1, and one duplicate destination for the
   scatter), ``gqa_attention`` (K7) at qwen2-0.5b's width (14 heads, 2 kv
   heads, hd 64, causal) for B 1 and S 1,024 in bf16 and float32 and B 8
   and S 2,048 in bf16, then every registry entry's example; the launch
   counts are set to 0 before and read after, and every entry must have
   launched. Each output is held to its plain version (K5 bit for bit, K7
   within SERVE_TOL), and K5a, K5b and K7 get kernel rows as in phase 3;
10. memory -- the tiered memory substrate at full width: a
   TieredEmbeddingStore over qwen2-0.5b's tied 151,936 x 896 table
   (float32, the serve phase's seeded params) through four rounds of a
   Zipf batch of 8 x 1,024 tokens (record_batch, maintenance, then lookup,
   which must equal table[ids] bit for bit and launch K4), and a
   TieredKVCache of 8 slots of 2,048 tokens (append every group, a skewed
   attention mass, two maintenance windows; read_groups must return what
   was appended bit for bit); each with GPAC on and off.

11. synth -- every workload's on-device window function (``data.traces``)
   in one plan, one row each at 3,276,800 pages, 4 windows of 65,536
   accesses made on the card and on the CPU: they must be equal bit for bit
   (the threefry streams, erf_inv and powf are built from exactly rounded
   operations, so the device does not matter); then one window of the churn
   fleet's mixed five-workload synthesis at 524,288 accesses per guest,
   timed on the card;
12. engine_synth -- phase 4's Redis guest over ``SynthTrace(16,
   2,097,152)``: memtierd twice through the kernels and twice plain, in
   turns, identical, K1-K4 launched in each kernel run; the same accesses
   as an ArrayTrace (the port's ``synth_generate``) must give the same state
   and series; s/window for both sources, and 4 SynthTrace windows under
   torch.profiler (device idle share);
13. churn_synth -- phase 6's fleet over a mixed ``SynthTrace(12, 524,288)``
   under phase 6's fault schedule, through the kernels and plain,
   identical; with the count of ocean_ncp's window-0 accesses that the
   reference's int32 stride wraps off ``floor(i * n / k)``;
14. service -- ``TieringService`` on that fleet for 12 ticks (six tenants
   into five lanes at tick 0, one with ``tier_floor`` 1; one departure at
   tick 4; the near tier cut to 0.7 x n_near at tick 5 and restored at tick
   9), through the kernels and plain: identical ``stats()`` after every
   tick, and the sixth tenant admitted only after the departure;
15. pebs -- phase 4's Redis guest with ``backend="pebs"`` (a binomial
   subsample of each window's counts, ``data.prng.binomial``): 16 memtierd
   windows through the kernels and plain, identical, payload intact; the
   binomial of one window's counts on the card must equal the CPU's bit for
   bit, for the Redis window and for the churn fleet's window 0 (whose
   masim guest takes the BTRS branch), with the loops' iterations, the
   elements on each branch and the host syncs; ``hot_mask_pebs`` timed;
16. ntier -- the Redis guest on three tiers, ``compressed_specs(0.15, 0.25,
   3.0)`` (boundaries 0 / 960 / 5,760 / 8,000, the same 16.8 GB of pools),
   collecting hits, near_blocks and tco: hybridtier for 16 windows and
   compressed, memtierd, autonuma and tpp for 4, each through the kernels
   and plain, identical; then a 2-tier TierSpec tuple that resolves to the
   no-tiers n_near must equal the no-tiers run over 4 windows;
17. ntier_churn -- phase 6's fleet on those three tiers under phase 6's
   fault schedule (the shrink at window 4 drives the pressure cascade),
   kernels and plain identical, per-tier block counts and the tco series
   printed; then phase 14's script on that fleet, kernels against plain.
18. families -- every other architecture through the serving engine, one
   at a time, random bf16 weights from a seeded torch.Generator, 16-token
   pages, 8 sequences: qwen2-moe-a2.7b at full size and the serve phase's
   traffic (16 requests of 1,024 + 32 tokens), then qwen2-vl-2b, gemma-7b,
   internlm2-20b, smollm-360m, whisper-tiny (1,500 zero frames),
   xlstm-1.3b (depth 16 of 48), kimi-k2-1t-a32b (depth 1 of 61) and jamba
   (its ``reduced()`` config) at 8 requests of 256 + 16 tokens in 512-token
   slots; each cut is on the arch's line. Each runs GPAC off and on through
   the kernels and then the plain versions: every request must complete
   with valid tokens, GPAC must leave the tokens unchanged and consolidate
   pages where there are attention layers, paged_attention must launch
   decode steps x attention layers times (0 for xLSTM) and K2-K4 in
   maintenance, nothing may launch on the plain run, and the first decode
   step's logits must agree with the plain run's within LOGITS_RTOL. In
   that first step each K6 call is held to its plain version on the same
   inputs at SERVE_TOL, and each MoE layer's routing is kept: the line
   prints how many (token, choice) pairs differ between the kernel and
   plain runs (a bf16 difference upstream can flip a route). qwen2-moe is
   profiled for four decode steps as in phase 8. K6 gets a kernel row at
   each family's decode shape on its GPAC-on cache (bf16; gemma-7b in
   float32 too, where the kernel's plan drops to 4 warps). The line gives
   the cache's bytes in three parts: paged K/V, the Mamba / xLSTM layers'
   recurrent states, and the encoder's K/V (whisper).
19. train -- the training path (which reaches none of the port's kernels,
   as the reference's reaches no Pallas kernel: every count must stay 0),
   on the port's seeded token pipeline at launch/train.py's defaults
   (batch 8 x 256 tokens, lr 3e-4, warmup then cosine over the run),
   seeded random bf16 weights, remat "block": qwen2-0.5b at full size with
   AdamW, and qwen2-moe-a2.7b at full width with Adafactor, 2 micro-batches
   and int8 gradient compression, cut to the largest depth whose state fits
   TRAIN_BUDGET_GB (the cut is on its line). Each takes 10 steps (2
   untimed, 8 timed: s/step, tokens/s, peak GB, every loss and gradient
   norm), a Supervisor checkpoint after step 5 restored to the host and
   held bit for bit to the live tensors, 2 more steps under torch.profiler
   (device busy ms, idle share, top operations); then the restored state
   goes back on the card and ``train_loop`` continues it to step 10: its
   losses within CONTINUED_LOSS_RTOL of the uninterrupted run's. Losses and
   norms must be finite and the tenth loss below the first. Last, one
   float32 loss-and-gradient step of both models reduced, on the card
   against the CPU, within CARD_CPU_*_RTOL.
20. train_dp -- data-parallel training over torch.distributed, through the
   entry points a user calls (``launch.mesh.train_mesh`` / ``make_dist``,
   ``trainer.make_train_step(..., dist)``), which reach none of the port's
   kernels either: (a) qwen2-0.5b on a forced one-rank NCCL mesh for 10
   steps, every param and loss equal to phase 19's no-mesh run bit for
   bit; (b) ``multihost.launch`` starts 2 ranks of ``python3 chip_smoke.py
   --train-dp-rank build/train_dp`` on the one card over gloo (NCCL takes
   one rank per card), each training qwen2-0.5b (AdamW) and then
   qwen2-moe-a2.7b at full width (Adafactor, 2 micro-batches, compression;
   cut in depth so that both ranks fit 60 GB together, the cut on its line)
   for 4 steps of the global batch 8 x 256: the ranks must be bit-identical
   (device checksums of params and state), every loss within 1e-3 and
   gradient norm within 5e-2 of this process's one-process run of the same
   batches, each leaf of qwen2-0.5b's first reduced gradient within 5e-2 of
   its L2 norm, and the MoE must drop tokens; then both models reduced in
   float32, one step on the two ranks, the reduced gradients within 1e-4 of
   each leaf's scale and the loss within 1e-5 of one process's; s/step,
   tokens/s, peak GB a rank, the drops and the collective bytes and calls
   per site a step are on its line.

21. contracts -- DESIGN.md §15's ten invariant contracts
   (``repro_torch.contracts``) on the card with ``kernel_backend="auto"``,
   each over ``fallback_draws()`` and its ``max_examples`` draws (173 in
   all) from a seeded numpy generator over the reference harness's ranges
   (1-3 ragged guests, hp_ratio 4 or 8, 3-5 windows of 8-32 accesses,
   non-dividing chunk sizes, both sources and host paths, the three
   builtin policies): runs, sharded runs on a one-rank NCCL mesh and churn
   runs bit for bit, the arbitration tie-break, the 2-tier special case,
   the pressure controller's bounds, the kernels against their plain
   versions (K1-K4 must launch), and INV-MULTIHOST-EXACT's 2-rank job over
   gloo on this card; one line per contract with its draws, seconds and
   launches by name, and a failing draw printed before the script stops.
22. dryrun -- item 17, the dry run and the roofline: (a) ``python -m
   repro_torch.launch.dryrun`` in subprocesses for qwen2-0.5b train_4k and
   qwen2-moe-a2.7b decode_32k at full size on the 256-rank single-pod mesh
   (fake process group, DTensor layouts, fake tensors): both records must
   be ``ok`` with 6ND over the counted FLOPs in (0, 1.05]; each line gives
   a rank's bytes, FLOPs, eager bytes, collectives by kind, trace seconds,
   the H100 roofline row and whether arguments + temps fit the card's
   memory (a finding, not a check); (b) qwen2-0.5b's train step at 2 x
   4,096 tokens counted on a one-rank mesh (``--dryrun-count``, a
   subprocess) and run on the card: argument bytes equal, the compute term
   at most 1.05 x the measured step, the predicted peak against
   ``max_memory_allocated``; (c) a 32,768-token prefill of qwen2-0.5b,
   scanned attention against unrolled with causal skip (seconds, peak GB,
   logits within UNROLL_LOGIT_RTOL), reduced float32 opt prefill and step
   card against CPU, and one opt train step at 2 x 4,096 whose loss is
   within UNROLL_LOSS_RTOL of the baseline's.

The phases run in the order 1-5, 11, 12, 6, 7, 13-17, the two sharded
phases, 21, 8-10, 18, 19, 20, 22. An engine
kernel row's ``launches`` counts the engine's main path (the memtierd run);
``launches_by_path`` adds the churn, reference, engine_synth, churn_synth,
service, pebs, ntier (the first policy's kernel run, hybridtier),
ntier_churn and its service runs. Every
kernel row carries ``floor_aware_bound_ms``: the launch floor (this run's
time of hot_count on the serve path's 1,632 bytes, ``launch_floor_ms``) plus
its bound. The script's total time is printed before the kernel rows,
and the last line is ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits non-zero; so it does without a CUDA device, and outside a
checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs, contracts  # noqa: E402
from repro_torch.contracts.draws import ContractDraw, GuestDraw, fallback_draws  # noqa: E402
from repro_torch.core import address_space as asp  # noqa: E402
from repro_torch.core import engine, faults, filter as pfilter, sharding, telemetry, tiering, tiers  # noqa: E402
from repro_torch.data import pipeline, prng, traces  # noqa: E402
from repro_torch.kernels import build, registry  # noqa: E402
from repro_torch.kernels.consolidate import consolidate_region, scatter_region  # noqa: E402
from repro_torch.kernels.flash_attention import gqa_attention  # noqa: E402
from repro_torch.memory.embedding import EmbedSpec, TieredEmbeddingStore  # noqa: E402
from repro_torch.memory.kvcache import KVSpec, TieredKVCache  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.serve.scheduler import Request, SchedulerConfig  # noqa: E402
from repro_torch.train import checkpoint, fault, optimizer, trainer  # noqa: E402
from repro_torch.train import tree as tr  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA cores (the table's non-tensor rate)
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores

# one Redis guest at the paper's size (Table 2: 12.5 GiB RSS in 4 KiB pages)
N_LOGICAL = 3_276_800
HOST = dict(hp_ratio=512, near_fraction=0.25, base_elems=1024,
            cl=traces.PAPER_CL["redis"])
N_WINDOWS, APW = 16, 2_097_152  # 2 * APW >= N_LOGICAL: the histogram branch
RUN = dict(backend="ipt", use_gpac=True, max_batches=4, budget=64,
           windows_per_step=4)
TIMED_RUNS = 25
TRACE_ATTEMPTS = 3  # profiler traces of one call before its device time counts as lost
LEAD_IN = 64  # untimed launches that open each trace (see Timer)
ENGINE_KERNELS = ("bincount", "hot_count", "topk_rows", "gather_rows")  # the engine's path

KERNEL_SOURCES = {  # name -> (CUDA source, the Pallas kernel it replaces)
    "bincount": ("src/repro_torch/csrc/histogram.cu",
                 "src/repro/kernels/histogram/kernel.py:46"),
    "hot_count": ("src/repro_torch/csrc/hotness_scan.cu",
                  "src/repro/kernels/hotness_scan/kernel.py:21"),
    "topk_rows": ("src/repro_torch/csrc/topk.cu",
                  "src/repro/kernels/topk/kernel.py:48"),
    "gather_rows": ("src/repro_torch/csrc/gather_rows.cu",
                    "src/repro/kernels/tiered_lookup/kernel.py:24"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:94"),
    "consolidate_region": ("src/repro_torch/csrc/consolidate.cu",
                           "src/repro/kernels/consolidate/kernel.py:29"),
    "scatter_region": ("src/repro_torch/csrc/consolidate.cu",
                       "src/repro/kernels/consolidate/kernel.py:59"),
    "gqa_attention": ("src/repro_torch/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention/kernel.py:89"),
}
INPLACE = {"scatter_region": 0}  # kernel -> the argument it writes in place


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


SAME_BITS_CHUNK = 1 << 30  # elements per torch.equal: its temporary is one byte each


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        a, b = a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)
    a, b = a.reshape(-1), b.reshape(-1)
    return all(torch.equal(a[i:i + SAME_BITS_CHUNK], b[i:i + SAME_BITS_CHUNK])
               for i in range(0, max(a.numel(), 1), SAME_BITS_CHUNK))


# --------------------------------------------------------------------------
# 1-2. device and build
# --------------------------------------------------------------------------
def device_phase() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count()))
    return torch.device("cuda"), smi


def build_phase() -> None:
    t0 = time.perf_counter()
    build.library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              **{k: v for k, v in build.BUILD_INFO.items() if k != "seconds"}))


# --------------------------------------------------------------------------
# 3. kernels at the main path's shapes
# --------------------------------------------------------------------------
class Timer:
    """Times a call on the card over TIMED_RUNS runs, with the 50 MB L2
    flushed before each run (the engine finds its inputs cold):

    * ``device_ms`` -- the time the card spends in the call's kernels, from
      a torch.profiler trace (mean per run; the flush's own kernel excluded
      by its full name), with the same time split by kernel name and each
      name's events per run. On the H100 a trace can lose its first few device
      events, more of them the longer the process has run, with or without
      the CPU's activity traced; so each trace starts with LEAD_IN untimed
      launches, and the runs are cut at the flushes after them. The trace
      counts only if it is whole: one flush event per run, the same kernel
      names the same number of times in every run, and in each run at
      least as many of the port's own kernels (the names outside PyTorch's
      ``at::``, copies and fills aside) as the wrappers counted launches.
      Else it is taken again, up to TRACE_ATTEMPTS times, and then the
      device time is None and the fault is kept;
    * ``call_ms`` -- the median time between CUDA events around one call,
      which adds the host's launch overhead whenever the card waits for it.
    """

    flush_name: str | None = None

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        self.lead = torch.zeros(1, device=device)
        # the flush kernel's full name (a call may run bitwise_not on other
        # dtypes): the last device event of a trace that ends with flushes.
        # Found by the process's first Timer: a trace late in a long process
        # can lose every device event (its rows then fall back to events)
        if Timer.flush_name is None:
            events = self._trace(lambda: [self._flush() for _ in range(4)])
            if not events:
                raise RuntimeError("torch.profiler traced no device event")
            Timer.flush_name = events[-1][0]

    def _flush(self):
        torch.bitwise_not(self.flush, out=self.flush)

    def _trace(self, body) -> list:
        """(name, us) of the device events of ``body``, in start order,
        after LEAD_IN untimed launches."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                self.lead.add_(1)
            torch.cuda.synchronize()
            body()
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                        for e in prof.events() if e.device_type == DeviceType.CUDA)
        return [(name, us) for _, name, us in events]

    def _runs(self, events, own_launches: int) -> tuple[list, str | None]:
        """A trace's device events cut into runs at the flushes, the lead-in
        before them dropped; and what makes the trace less than whole, or
        None."""
        flushes = [i for i, (name, _) in enumerate(events) if name == self.flush_name]
        if len(flushes) != TIMED_RUNS:
            return [], f"{len(flushes)} flush events for {TIMED_RUNS} runs"
        runs = [events[a + 1:b] for a, b in zip(flushes, flushes[1:] + [len(events)])]
        names = [sorted(name for name, _ in r) for r in runs]
        if not names[0] or any(n != names[0] for n in names):
            return [], "the runs' kernel events differ: " + ", ".join(
                str(len(n)) for n in names)
        own = sum("at::" not in name and not name.startswith(("Memcpy", "Memset"))
                  for name in names[0])
        if own * TIMED_RUNS < own_launches:
            return [], f"{own} of the port's kernels per run, {own_launches} launches counted"
        return runs, None

    def device_ms(self, fn) -> dict:
        def body():
            for _ in range(TIMED_RUNS):
                self._flush()
                fn()

        fn()
        torch.cuda.synchronize()
        for _ in range(TRACE_ATTEMPTS):
            before = sum(registry.launch_counts().values())
            events = self._trace(body)
            own_launches = sum(registry.launch_counts().values()) - before
            runs, fault = self._runs(events, own_launches)
            if fault is None:
                break
        if fault is not None:
            return dict(device_ms=None, by_name={}, events_per_run={}, trace_fault=fault)
        by_name: dict[str, float] = {}
        per_run: dict[str, int] = {}
        for name, us in (ev for run in runs for ev in run):
            name = name[:60]
            by_name[name] = by_name.get(name, 0.0) + us / TIMED_RUNS / 1e3
            per_run[name] = per_run.get(name, 0) + 1
        return dict(device_ms=sum(by_name.values()), by_name=by_name,
                    events_per_run={k: n // TIMED_RUNS for k, n in per_run.items()},
                    trace_fault=None)

    def call_ms(self, fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(TIMED_RUNS):
            self._flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def __call__(self, fn) -> dict:
        """``ms``: the device time, or the event time where the trace is not
        whole (``timing``: "profiler", or "events" and why); ``ms_by_kernel``:
        the device time by kernel name, ``events_per_run`` its launches."""
        call = self.call_ms(fn)
        d = self.device_ms(fn)
        dev = d["device_ms"]
        return dict(ms=call if dev is None else dev, call_ms=call, ms_by_kernel=d["by_name"],
                    events_per_run=d["events_per_run"],
                    timing="profiler" if dev is not None else f"events ({d['trace_fault']})")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_cases(spec, state, trace0: torch.Tensor, gen: torch.Generator) -> list:
    """(name, case, args, library call, bytes moved, operations, tolerance)
    for every kernel at the shapes of one full-width window of the engine's
    main path; the inputs come from the run's own first window."""
    cfg = spec.cfg
    dev = trace0.device
    ids = spec.localize(trace0).reshape(-1)
    valid = (ids >= 0) & (ids < cfg.n_logical)
    acc_ids = torch.where(valid, ids, cfg.n_logical).to(torch.int32)
    ones = torch.ones_like(acc_ids)
    h = registry.dispatch("bincount", "torch", acc_ids, ones, cfg.n_logical + 1)[: cfg.n_logical]
    hp_of = state.gpt // cfg.hp_ratio
    st1 = asp.record_accesses(cfg, state, ids, kernel_backend="torch")  # new counts only
    hot = telemetry.hot_mask(cfg, st1, "ipt")
    hot_gpa = torch.where(st1.rmap >= 0, hot[st1.rmap.clamp(min=0)], False)
    tables = spec.tables(dev)
    score = pfilter.candidate_score(cfg, st1, hot, tables.cl_per_logical, "torch")
    mat = torch.where(tables.logical_pad >= 0, score[tables.logical_pad.clamp(min=0)], -1)
    k = min(RUN["max_batches"] * cfg.hp_ratio, mat.shape[1])
    # eight rows of 262,144 with the same mass ties (-1) and a few candidates
    mat8 = torch.full((8, 262_144), -1, dtype=torch.int32, device=dev)
    pick = torch.randint(0, mat8.numel(), (20_000,), generator=gen, device=dev)
    mat8.view(-1)[pick] = torch.randint(0, 4096, (20_000,), generator=gen, device=dev,
                                        dtype=torch.int32)
    near_rows = state.near_pool.view(-1, cfg.base_elems)
    far_rows = state.far_pool.view(-1, cfg.base_elems)
    hp = cfg.hp_ratio
    near_ids = torch.randint(0, near_rows.shape[0], (1, hp), generator=gen,
                             device=dev, dtype=torch.int32)
    far_ids = torch.randint(0, far_rows.shape[0], (1, hp), generator=gen,
                            device=dev, dtype=torch.int32)
    row_bytes = cfg.base_elems * near_rows.element_size()

    # the host histogram's pairs in a random order: no runs of equal ids
    shuffle = torch.randperm(hp_of.numel(), generator=gen, device=dev)
    hp_sh, h_sh = hp_of[shuffle].contiguous(), h[shuffle].contiguous()
    # the library yardstick: torch.bincount wants int64 ids and float weights
    acc_ids64, hp_of64, h_f = acc_ids.long(), hp_of.long(), h.to(torch.float32)
    hp_sh64, h_sh_f = hp_sh.long(), h_sh.to(torch.float32)

    return [
        ("bincount", "access_histogram", (acc_ids, ones, cfg.n_logical + 1),
         lambda: torch.bincount(acc_ids64, minlength=cfg.n_logical + 1),
         _nbytes(acc_ids, ones) + 4 * (cfg.n_logical + 1), acc_ids.numel(), None),
        ("bincount", "host_histogram", (hp_of, h, cfg.n_gpa_hp),
         lambda: torch.bincount(hp_of64, weights=h_f, minlength=cfg.n_gpa_hp),
         _nbytes(hp_of, h) + 4 * cfg.n_gpa_hp, hp_of.numel(), None),
        ("bincount", "host_histogram shuffled (on no path)", (hp_sh, h_sh, cfg.n_gpa_hp),
         lambda: torch.bincount(hp_sh64, weights=h_sh_f, minlength=cfg.n_gpa_hp),
         _nbytes(hp_sh, h_sh) + 4 * cfg.n_gpa_hp, hp_sh.numel(), None),
        ("hot_count", "hot_subpages_per_hp", (hot_gpa, hp),
         lambda: hot_gpa.view(-1, hp).sum(dim=1, dtype=torch.int32),
         _nbytes(hot_gpa) + 4 * cfg.n_gpa_hp, hot_gpa.numel(), None),
        ("topk_rows", f"filter rows={mat.shape[0]} width={mat.shape[1]}", (mat, k),
         lambda: torch.topk(mat, k, dim=1),
         _nbytes(mat) + 8 * mat.shape[0] * k, mat.numel(), None),
        ("topk_rows", "rows=8 width=262144 mass ties", (mat8, k),
         lambda: torch.topk(mat8, k, dim=1),
         _nbytes(mat8) + 8 * 8 * k, mat8.numel(), None),
        ("gather_rows", "near pool", (near_rows, near_ids),
         lambda: torch.index_select(near_rows, 0, near_ids.view(-1)),
         2 * hp * row_bytes + _nbytes(near_ids), 0, None),
        ("gather_rows", "far pool", (far_rows, far_ids),
         lambda: torch.index_select(far_rows, 0, far_ids.view(-1)),
         2 * hp * row_bytes + _nbytes(far_ids), 0, None),
    ]


def kernels_phase(cases: list, device, path: str) -> list[dict]:
    """Hold every kernel to its plain version and time both. A case is
    (name, case, args, library call, bytes, operations, tolerance); the
    operations are a count at FP32_OPS_PER_S or a (count, rate) pair, and a
    tolerance of None means bit for bit. A kernel that writes an argument in
    place (INPLACE) and its plain version each get their own copy of it.
    Launches made here are not the main path's: the counts are reset before
    it runs."""
    timer = Timer(device)
    rows = []
    for name, case, args, library, nbytes, ops, tol in cases:
        kspec = registry.get_kernel(name)
        plain_args = list(args)
        if name in INPLACE:
            plain_args[INPLACE[name]] = args[INPLACE[name]].clone()
        got, want = kspec.kernel(*args), kspec.plain(*plain_args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for g, w in zip(got, want):
            if tol is None and not same_bits(g, w):
                raise AssertionError(f"{name} ({case}) differs from its plain version")
            if tol is not None:
                if g.dtype != w.dtype or not torch.isfinite(g).all():
                    raise AssertionError(f"{name} ({case}): wrong dtype or not finite")
                torch.testing.assert_close(g.float(), w.float(), **tol)
            if tol is not None and g.numel():  # bit for bit: the error is 0
                err = max(err, float((g.double() - w.double()).abs().max()))
        n_ops, rate = ops if isinstance(ops, tuple) else (ops, FP32_OPS_PER_S)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / rate
        source, replaces = KERNEL_SOURCES[name]
        kern = timer(lambda: kspec.kernel(*args))
        plain = timer(lambda: kspec.plain(*plain_args))
        lib = timer(library)
        rows.append(dict(
            name=name, case=case, path=path, route="cuda", source=source,
            replaces=replaces, launches=None, max_abs_err=err, tolerance=tol or "exact",
            ms=kern["ms"], plain_ms=plain["ms"],
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib["ms"], call_ms=kern["call_ms"],
            plain_call_ms=plain["call_ms"], library_call_ms=lib["call_ms"],
            timing=kern["timing"], plain_timing=plain["timing"], library_timing=lib["timing"],
            ms_by_kernel=kern["ms_by_kernel"], events_per_run=kern["events_per_run"],
            shapes=[list(a.shape) for a in args if isinstance(a, torch.Tensor)],
            bytes=nbytes))
    return rows


# --------------------------------------------------------------------------
# 4. the engine at full width
# --------------------------------------------------------------------------
def page_fill(ids: torch.Tensor, base_elems: int) -> torch.Tensor:
    """Each page's distinct payload: id + 4096 * element, exact in float32
    (below 2^24 for every page and element)."""
    e = torch.arange(base_elems, device=ids.device, dtype=torch.float32)
    return ids.to(torch.float32)[:, None] + 4096.0 * e[None, :]


CHUNK = 1 << 16


def filled_state(spec, device):
    """The engine's initial state with every page holding page_fill."""
    cfg = spec.cfg
    state = engine.init_engine_state(spec, device=device)
    for lo in range(0, cfg.n_logical, CHUNK):
        ids = torch.arange(lo, min(lo + CHUNK, cfg.n_logical), dtype=torch.int32,
                           device=device)
        state = asp.write_logical(cfg, state, ids, page_fill(ids, cfg.base_elems))
    return state


def clone_state(state):
    return dataclasses.replace(
        state, **{f.name: getattr(state, f.name).clone()
                  for f in dataclasses.fields(state) if f.name != "stats"},
        stats={k: v.clone() for k, v in state.stats.items()})


def check_payload(spec, state, pages=None, wiped: bool = False) -> None:
    """Every page of ``pages`` (a range; all when None) still reads back its
    initial payload, or zeros where ``wiped``."""
    cfg = spec.cfg
    pages = range(cfg.n_logical) if pages is None else pages
    for lo in range(pages.start, pages.stop, CHUNK):
        ids = torch.arange(lo, min(lo + CHUNK, pages.stop), dtype=torch.int32,
                           device=state.device)
        want = page_fill(ids, cfg.base_elems)
        if not same_bits(asp.read_logical(cfg, state, ids), want * 0 if wiped else want):
            raise AssertionError(f"payload of pages [{lo}, {lo + CHUNK}) changed")


def assert_same_states(a, b) -> None:
    for f in dataclasses.fields(a):
        if f.name == "stats":
            for k in a.stats:
                if not same_bits(a.stats[k], b.stats[k]):
                    raise AssertionError(f"stats.{k} differs between the runs")
        elif not same_bits(getattr(a, f.name), getattr(b, f.name)):
            raise AssertionError(f"{f.name} differs between the runs")


def assert_same_series(ref: dict, got: dict, what: str) -> None:
    if set(ref) != set(got):
        raise AssertionError(f"{what}: series keys {sorted(ref)} and {sorted(got)}")
    for k in ref:
        if got[k].dtype != ref[k].dtype or not np.array_equal(got[k], ref[k]):
            raise AssertionError(f"{what}: series {k} differs between the runs")


def timed_run(spec, state, trace, policy, kernel_backend):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, series = engine.run(spec, state, trace, policy=policy,
                               kernel_backend=kernel_backend,
                               device=state.device, **RUN)
    torch.cuda.synchronize()
    return state, series, time.perf_counter() - t0


def engine_phase(spec, trace: np.ndarray, policy: str, n_windows: int, device) -> dict:
    """One policy's run, from the same filled state, through the kernels and
    through the plain versions in turns (kernels, plain, plain, kernels).
    Every run must agree with the first bit for bit; the launch counts are
    set to 0 before each run and read after it."""
    trace = trace[:, :n_windows]
    base = filled_state(spec, device)
    ref = ref_series = launches = peak = None
    secs = {"auto": [], "torch": []}
    for backend in ("auto", "torch", "torch", "auto"):
        if ref is None:
            torch.cuda.reset_peak_memory_stats()
        registry.reset_launch_counts()
        state, series, t = timed_run(spec, clone_state(base), trace, policy, backend)
        counts = registry.launch_counts()
        secs[backend].append(t / n_windows)
        if backend == "torch" and any(counts.values()):
            raise AssertionError(f"{policy}: the plain run launched kernels: {counts}")
        if backend == "auto":
            missing = [k for k in ENGINE_KERNELS if counts[k] == 0]
            if missing:
                raise AssertionError(
                    f"{policy}: kernels never launched on the main path: {missing}")
            launches = launches or counts
        if ref is None:
            ref, ref_series, peak = state, series, torch.cuda.max_memory_allocated()
            continue
        assert_same_states(ref, state)
        assert_same_series(ref_series, series, policy)
        del state
    del base
    for k, v in ref_series.items():
        if v.shape[0] != n_windows:
            raise AssertionError(f"{policy}: series {k} has {v.shape[0]} windows")
    check_payload(spec, ref)
    stats = {k: int(v) for k, v in ref.stats.items()}
    if policy == "memtierd" and (stats["consolidated_pages"] == 0 or stats["promoted_blocks"] == 0):
        raise AssertionError(f"memtierd moved nothing: {stats}")
    hits = int(ref_series["near_hits"].sum() + ref_series["far_hits"].sum())
    if hits != int((trace >= 0).sum()):
        raise AssertionError("hit counts do not add up to the accesses")
    return dict(
        phase="engine", policy=policy, windows=n_windows,
        s_per_window=statistics.median(secs["auto"]),
        s_per_window_plain=statistics.median(secs["torch"]),
        s_per_window_runs=secs, launches=launches, peak_gb=peak / 1e9,
        pool_gb=(ref.near_pool.numel() + ref.far_pool.numel())
        * ref.near_pool.element_size() / 1e9,
        near_hit_share=ref_series["near_hits"].sum() / max(hits, 1),
        near_blocks_last=ref_series["near_blocks"][-1].tolist(), stats=stats,
        identical=True, payload_intact=True)


PORT_KERNELS = ("bincount_", "hot_count_", "topk_rows_", "gather_rows_")
PROFILED_WINDOWS = 4


def device_summary(prof, port_names: tuple, n: int, unit: str) -> dict:
    """A profiled run of ``n`` windows or steps: the device's busy time (the
    union of its activity intervals, kernels and copies) and idle share (the
    rest of the span from the first to the last), the port's kernels' share
    of the busy time, device kernels per unit, and device time by name."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:  # the trace holds no device activity: nothing to report
        return {f"device_busy_ms_per_{unit}": None, "device_idle_share": None,
                "port_kernels_share_of_busy": None, "top": None}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, hi = 0.0, spans[0][0]
    for start, end in spans:
        busy += max(0.0, end - max(start, hi))
        hi = max(hi, end)
    by_name: dict[str, list] = {}
    for e in events:
        agg = by_name.setdefault(e.name, [0, 0.0])
        agg[0] += 1
        agg[1] += e.time_range.elapsed_us()
    ours = sum(us for name, (_, us) in by_name.items() if any(k in name for k in port_names))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {f"device_busy_ms_per_{unit}": busy / 1e3 / n,
            "device_idle_share": 1.0 - busy / (hi - spans[0][0]),
            "port_kernels_share_of_busy": ours / busy,
            f"device_ops_per_{unit}": len(events) / n,
            "top": [{"name": k[:80], "count": c, f"ms_per_{unit}": us / 1e3 / n}
                    for k, (c, us) in top]}


def profile_phase(spec, trace: np.ndarray, device) -> dict:
    """Where a memtierd window's device time goes: a short kernel run under
    torch.profiler (``device_summary``)."""
    from torch.profiler import ProfilerActivity, profile

    state = filled_state(spec, device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(spec, state, trace[:, :PROFILED_WINDOWS], policy="memtierd",
                   kernel_backend="auto", device=device, **RUN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del state
    return dict(phase="profile", policy="memtierd", windows=PROFILED_WINDOWS,
                wall_s_per_window_profiled=wall / PROFILED_WINDOWS,
                **device_summary(prof, PORT_KERNELS, PROFILED_WINDOWS, "window"))


# --------------------------------------------------------------------------
# 6-7. the churn engine and the reference driver on a five-guest fleet
# --------------------------------------------------------------------------
CHURN_WORKLOADS = ("masim", "redis", "memcached", "hash", "ocean_ncp")
CHURN_RSS_SCALE = 0.4  # of the paper's RSS: the fleet's one cut (full: 63.9 GB of pools)
CHURN_HOST = dict(hp_ratio=512, near_fraction=0.25, base_elems=1024)
CHURN_WINDOWS, CHURN_APW = 12, 524_288
CHURN_RUN = dict(policy="memtierd", backend="ipt", use_gpac=True, max_batches=4, budget=64,
                 slack=1, windows_per_step=4)
CONTROL_WINDOWS = 4  # the no-fault control and the reference phase
INTACT, WIPED = ("masim", "redis", "ocean_ncp"), ("memcached", "hash")


def churn_fleet(device, scale: float = CHURN_RSS_SCALE):
    """The fleet's spec: each guest at ``scale`` x its paper RSS in 4 KiB
    pages, rounded down to a multiple of 512, with its paper CL."""
    guests = [engine.GuestSpec(int(scale * traces.PAPER_RSS_GB[w] * 2**30 / 4096) // 512 * 512,
                               cl=traces.PAPER_CL[w], workload=w, seed=g)
              for g, w in enumerate(CHURN_WORKLOADS)]
    spec, _ = engine.build(guests, engine.HostSpec(**CHURN_HOST), device=device)
    return spec


def churn_schedule(spec) -> faults.FaultSchedule:
    """Every kind of fault: memcached crashes at 3 and restarts at 7, hash
    reboots at 5, the near tier shrinks to 0.7 x n_near at 4 and grows back
    at 8, window 6's telemetry drops."""
    g = {w: i for i, w in enumerate(CHURN_WORKLOADS)}
    n_near = spec.cfg.n_near
    return (faults.FaultSchedule(len(CHURN_WORKLOADS))
            .crash(3, g["memcached"]).restart(7, g["memcached"])
            .crash(5, g["hash"]).restart(5, g["hash"])
            .shrink(4, int(0.7 * n_near)).shrink(8, n_near).dropout(6))


def assert_same_churn(a, b) -> None:
    assert_same_states(a.state, b.state)
    for f in ("active", "window", "near_cap", "pressure", "engaged"):
        if not same_bits(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"churn carry {f} differs between the runs")


def churn_run(spec, trace, sched, backend: str, device):
    """One run_churn from the filled state; the launch counts and the peak
    memory are reset just before the run and read just after."""
    cs = engine.init_churn(spec, filled_state(spec, device), device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    cs, series = engine.run_churn(spec, cs, trace, faults=sched, kernel_backend=backend,
                                  device=device, **CHURN_RUN)
    torch.cuda.synchronize()
    return (cs, series, time.perf_counter() - t0, registry.launch_counts(),
            torch.cuda.max_memory_allocated())


def churn_phase(spec, trace: np.ndarray, device) -> tuple[dict, dict]:
    """The faulted run through the kernels and the plain versions in turns
    (kernels, plain, plain, kernels), every run held to the first bit for
    bit, then the schedule's effects and the no-fault control. Returns the
    phase's line and the churn path's launch counts (the first kernel run)."""
    cfg, sched = spec.cfg, churn_schedule(spec)
    n_w, n_g = trace.shape[1], spec.n_guests
    g = {w: i for i, w in enumerate(CHURN_WORKLOADS)}
    ref = ref_series = launches = None
    secs, peaks = {"auto": [], "torch": []}, []
    gc.collect()  # the earlier phases' garbage
    allocated_at_start = torch.cuda.memory_allocated()
    for backend in ("auto", "torch", "torch", "auto"):
        cs, series, t, counts, peak = churn_run(spec, trace, sched, backend, device)
        peaks.append(peak)
        secs[backend].append(t / n_w)
        if backend == "torch" and any(counts.values()):
            raise AssertionError(f"churn: the plain run launched kernels: {counts}")
        if backend == "auto":
            missing = [k for k in ENGINE_KERNELS if counts[k] == 0]
            if missing:
                raise AssertionError(f"churn: kernels never launched on the path: {missing}")
            launches = launches or counts
        if ref is None:
            ref, ref_series = cs, series
            continue
        assert_same_churn(ref, cs)
        assert_same_series(ref_series, series, "churn")
        del cs
    want_active = np.ones((n_w, n_g), bool)
    want_active[3:7, g["memcached"]] = False
    if not np.array_equal(ref_series["active"], want_active):
        raise AssertionError(f"churn: active series {ref_series['active'].tolist()}")
    near_blocks, pressure = ref_series["near_blocks"], ref_series["pressure"]
    if near_blocks[3:7, g["memcached"]].any():
        raise AssertionError(f"churn: memcached holds near blocks while down: {near_blocks.tolist()}")
    if pressure[4] < 1 or pressure[8:].any():
        raise AssertionError(f"churn: pressure series {pressure.tolist()}")
    if (near_blocks.sum(axis=1) > cfg.n_near).any():
        raise AssertionError(f"churn: near usage above n_near={cfg.n_near}")
    for w in INTACT + WIPED:
        check_payload(spec, ref.state, range(*spec.logical_range(g[w])), wiped=w in WIPED)
    hits = int(ref_series["near_hits"].sum() + ref_series["far_hits"].sum())
    if hits != int((trace >= 0).sum() - (trace[g["memcached"], 3:7] >= 0).sum()):
        raise AssertionError("churn: hit counts do not add up to the active lanes' accesses")
    stats = {k: int(v) for k, v in ref.state.stats.items()}
    pool_gb = (ref.state.near_pool.numel() + ref.state.far_pool.numel()) * 4 / 1e9
    del ref

    # no-fault control: run_churn against run over the first windows
    ctl = trace[:, :CONTROL_WINDOWS]
    cs = engine.init_churn(spec, filled_state(spec, device), device=device)
    cs, churn_series = engine.run_churn(spec, cs, ctl, device=device, **CHURN_RUN)
    run_kw = {k: v for k, v in CHURN_RUN.items() if k != "slack"}
    st, run_series = engine.run(spec, filled_state(spec, device), ctl, device=device, **run_kw)
    assert_same_states(cs.state, st)
    assert_same_series(run_series, {k: v for k, v in churn_series.items()
                                    if k not in ("active", "near_cap", "pressure")}, "control")
    if not churn_series["active"].all() or churn_series["pressure"].any():
        raise AssertionError("control: a no-fault run deactivated a lane or engaged")
    del cs, st
    return dict(
        phase="churn", guests={w: spec.guests[i].n_logical for i, w in enumerate(CHURN_WORKLOADS)},
        n_logical=cfg.n_logical, n_gpa_hp=cfg.n_gpa_hp, n_near=cfg.n_near, windows=n_w,
        accesses_per_guest_window=trace.shape[2], faults=dataclasses.asdict(sched),
        s_per_window=statistics.median(secs["auto"]),
        s_per_window_plain=statistics.median(secs["torch"]), s_per_window_runs=secs,
        launches=launches, peak_gb=max(peaks) / 1e9,  # runs after the first hold two carries
        peak_gb_runs=[p / 1e9 for p in peaks], allocated_gb_at_start=allocated_at_start / 1e9,
        pool_gb=pool_gb, active=ref_series["active"].astype(int).tolist(), near_cap=ref_series["near_cap"].tolist(),
        pressure=pressure.tolist(), near_blocks=near_blocks.tolist(), stats=stats,
        identical=True, schedule_followed=True, payload_checked=True,
        noop_equals_run_windows=CONTROL_WINDOWS), launches


def reference_phase(spec, trace: np.ndarray, device) -> tuple[dict, dict]:
    """``run_reference`` (the sequential per-guest oracle) against ``run``
    over the fleet's first windows, no faults, both through the kernels."""
    trace = trace[:, :CONTROL_WINDOWS]
    kw = {k: CHURN_RUN[k] for k in ("policy", "backend", "use_gpac", "max_batches", "budget")}
    out = {}
    for name in ("reference", "run"):
        st = filled_state(spec, device)
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        if name == "reference":
            st, series = engine.run_reference(spec, st, trace, device=device, **kw)
        else:
            st, series = engine.run(spec, st, trace, device=device,
                                    windows_per_step=CHURN_RUN["windows_per_step"], **kw)
        torch.cuda.synchronize()
        out[name] = (st, series, (time.perf_counter() - t0) / CONTROL_WINDOWS,
                     registry.launch_counts())
    (ref_st, ref_series, ref_s, ref_counts), (st, series, run_s, run_counts) = (
        out["reference"], out["run"])
    assert_same_states(ref_st, st)
    assert_same_series(ref_series, series, "reference")
    missing = [k for k in ENGINE_KERNELS[1:] if ref_counts[k] == 0]
    if missing:
        raise AssertionError(f"reference: kernels never launched: {missing}")
    del out, ref_st, st
    return dict(phase="reference", windows=CONTROL_WINDOWS, s_per_window_reference=ref_s,
                s_per_window_run=run_s, speedup=ref_s / run_s, launches_reference=ref_counts,
                launches_run=run_counts, identical=True), ref_counts


# --------------------------------------------------------------------------
# 11-14. on-device synthesis: the window functions on the card and the CPU,
# then the engine, the churn engine and the service over SynthTrace
# --------------------------------------------------------------------------
SYNTH_K, SYNTH_WINDOWS = 65_536, 4
SYNTH_TIMED = 5  # timed windows of synth_accesses alone


def cuda_seconds(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def synth_window_ms(plan, setup) -> float:
    """The median time of one window of synth_accesses on the card."""
    return statistics.median(
        cuda_seconds(lambda: traces.synth_accesses(plan, setup, w))[1] * 1e3
        for w in range(SYNTH_TIMED))


def synth_phase(churn_spec, device) -> dict:
    """Every workload's window function in one plan, one row each (gid =
    row, seed 0, 3,276,800 pages), 4 windows of 65,536 accesses made on the
    card and on the CPU: equal bit for bit, in range. Then the churn fleet's
    mixed five-workload synthesis, one window timed on the card."""
    names = traces.workloads()
    plan = traces.SynthPlan(tuple(sorted(names)), SYNTH_K, HOST["hp_ratio"], N_LOGICAL)
    n = len(names)
    tables = dict(seeds=np.zeros(n, np.int32), gids=np.arange(n, dtype=np.int32),
                  wid=np.array([plan.workload_set.index(w) for w in names], np.int32),
                  n_logical=np.full(n, N_LOGICAL, np.int32))
    acc, secs = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        setup = traces.synth_setup(plan, tables, dev)
        acc[where] = np.stack([traces.synth_accesses(plan, setup, w).cpu().numpy()
                               for w in range(SYNTH_WINDOWS)])
        secs[where] = time.perf_counter() - t0
        del setup
    mismatches = {w: int((acc["card"][:, i] != acc["cpu"][:, i]).sum())
                  for i, w in enumerate(names)}
    if any(mismatches.values()):
        raise AssertionError(f"synth: card and CPU accesses differ: {mismatches}")
    if ((acc["card"] < 0) | (acc["card"] >= N_LOGICAL)).any():
        raise AssertionError("synth: an access outside the guest")
    distinct = {w: int(np.unique(acc["card"][:, i]).size) for i, w in enumerate(names)}
    del acc
    plan, tables = engine._bind_synth(churn_spec, engine.SynthTrace(1, CHURN_APW))
    setup, setup_s = cuda_seconds(lambda: traces.synth_setup(plan, tables, device))
    window_ms = synth_window_ms(plan, setup)
    del setup
    return dict(phase="synth", workloads=list(names), n_logical=N_LOGICAL, k=SYNTH_K,
                windows=SYNTH_WINDOWS, mismatches_card_vs_cpu=mismatches,
                distinct_pages=distinct, seconds_card=secs["card"], seconds_cpu=secs["cpu"],
                fleet=list(plan.workload_set), fleet_k=CHURN_APW,
                fleet_setup_s=setup_s, fleet_window_ms=window_ms, card_equals_cpu=True)


def engine_synth_phase(spec, device) -> tuple[dict, dict]:
    """The engine phase's Redis guest over SynthTrace(16, 2,097,152): memtierd
    through the kernels and the plain versions in turns, every run held to
    the first bit for bit; then the same accesses as an ArrayTrace (the
    port's synth_generate) through the kernels, which must give the same
    state and series; then 4 SynthTrace windows under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    source = engine.SynthTrace(N_WINDOWS, APW)
    base = filled_state(spec, device)
    ref = ref_series = launches = peak = None
    secs = {"auto": [], "torch": []}
    for backend in ("auto", "torch", "torch", "auto"):
        if ref is None:
            torch.cuda.reset_peak_memory_stats()
        registry.reset_launch_counts()
        state, series, t = timed_run(spec, clone_state(base), source, "memtierd", backend)
        counts = registry.launch_counts()
        secs[backend].append(t / N_WINDOWS)
        if backend == "torch" and any(counts.values()):
            raise AssertionError(f"engine_synth: the plain run launched kernels: {counts}")
        if backend == "auto":
            missing = [k for k in ENGINE_KERNELS if counts[k] == 0]
            if missing:
                raise AssertionError(f"engine_synth: kernels never launched: {missing}")
            launches = launches or counts
        if ref is None:
            ref, ref_series, peak = state, series, torch.cuda.max_memory_allocated()
            continue
        assert_same_states(ref, state)
        assert_same_series(ref_series, series, "engine_synth")
        del state
    arr, gen_s = cuda_seconds(lambda: traces.synth_generate(traces.TraceSpec(
        "redis", N_LOGICAL, HOST["hp_ratio"], N_WINDOWS, APW, seed=0), device=device)[None])
    state, series, t_arr = timed_run(spec, clone_state(base), arr, "memtierd", "auto")
    assert_same_states(ref, state)
    assert_same_series(ref_series, series, "engine_synth: ArrayTrace")
    del state
    hits = int(ref_series["near_hits"].sum() + ref_series["far_hits"].sum())
    if hits != int((arr >= 0).sum()):
        raise AssertionError("engine_synth: hit counts do not add up to the accesses")
    check_payload(spec, ref)
    stats = {k: int(v) for k, v in ref.stats.items()}
    del ref, arr
    state = clone_state(base)
    del base
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.run(spec, state, engine.SynthTrace(PROFILED_WINDOWS, APW), policy="memtierd",
                   kernel_backend="auto", device=device, **RUN)
        torch.cuda.synchronize()
    del state
    plan, tables = engine._bind_synth(spec, source)
    setup, setup_s = cuda_seconds(lambda: traces.synth_setup(plan, tables, device))
    window_ms = synth_window_ms(plan, setup)
    del setup
    return dict(
        phase="engine_synth", policy="memtierd", windows=N_WINDOWS, k=APW,
        s_per_window_synth=statistics.median(secs["auto"]),
        s_per_window_synth_plain=statistics.median(secs["torch"]),
        s_per_window_runs=secs, s_per_window_array=t_arr / N_WINDOWS,
        synth_generate_s=gen_s, synth_setup_s=setup_s, synth_window_ms=window_ms,
        launches=launches, peak_gb=peak / 1e9, stats=stats,
        profiled=device_summary(prof, PORT_KERNELS, PROFILED_WINDOWS, "window"),
        identical=True, synth_equals_array=True, payload_intact=True), launches


def churn_synth_phase(spec, device) -> tuple[dict, dict]:
    """The churn fleet over a mixed SynthTrace(12, 524,288) under the churn
    phase's fault schedule, through the kernels and the plain versions,
    identical; and ocean_ncp's window-0 positions that the reference's int32
    stride wraps away from floor(i * n / k)."""
    sched = churn_schedule(spec)
    source = engine.SynthTrace(CHURN_WINDOWS, CHURN_APW)
    runs = {}
    for backend in ("auto", "torch"):
        cs, series, t, counts, peak = churn_run(spec, source, sched, backend, device)
        runs[backend] = (cs, series, t / CHURN_WINDOWS, counts, peak)
        if backend == "auto":
            missing = [k for k in ENGINE_KERNELS if counts[k] == 0]
            if missing:
                raise AssertionError(f"churn_synth: kernels never launched: {missing}")
        elif any(counts.values()):
            raise AssertionError(f"churn_synth: the plain run launched kernels: {counts}")
        if backend == "torch":
            assert_same_churn(runs["auto"][0], cs)
            assert_same_series(runs["auto"][1], series, "churn_synth")
        del cs
    series = runs["auto"][1]
    g = {w: i for i, w in enumerate(CHURN_WORKLOADS)}
    want_active = np.ones((CHURN_WINDOWS, spec.n_guests), bool)
    want_active[3:7, g["memcached"]] = False
    if not np.array_equal(series["active"], want_active) or series["pressure"][4] < 1:
        raise AssertionError("churn_synth: the schedule's effects are missing")
    # window 0 of the ocean_ncp guest against the unwrapped stride
    plan, tables = engine._bind_synth(spec, source)
    setup = traces.synth_setup(plan, tables, device)
    acc0 = traces.synth_accesses(plan, setup, 0)[g["ocean_ncp"]].cpu().numpy().astype(np.int64)
    del setup
    n = spec.guests[g["ocean_ncp"]].n_logical
    half = int(np.float32(n) * np.float32(0.6)) // 2
    exact = np.minimum(acc0[0] + 2 * (np.arange(CHURN_APW, dtype=np.int64) * half // CHURN_APW),
                       n - 1)
    line = dict(
        phase="churn_synth", windows=CHURN_WINDOWS, k=CHURN_APW,
        workloads=list(CHURN_WORKLOADS),
        s_per_window=runs["auto"][2], s_per_window_plain=runs["torch"][2],
        launches=runs["auto"][3], peak_gb=max(r[4] for r in runs.values()) / 1e9,
        active=series["active"].astype(int).tolist(), pressure=series["pressure"].tolist(),
        near_blocks=series["near_blocks"].tolist(),
        ocean_window0_accesses_off_exact_stride=int((acc0 != exact).sum()),
        identical=True)
    launches = runs["auto"][3]
    del runs
    return line, launches


SERVICE_TICKS = 12


def service_script(svc, n_near: int) -> list:
    """Six tenants into five lanes at tick 0 (tenant 12 with tier_floor 1),
    tenant 11 departs at tick 4, the near tier is cut to 0.7 x n_near at
    tick 5 and restored at tick 9; stats() after every tick."""
    hist = []
    for t in range(6):
        svc.submit(10 + t, tier_floor=1 if t == 2 else 0)
    for tick in range(SERVICE_TICKS):
        if tick == 4:
            svc.depart(11)
        if tick == 5:
            svc.set_near_cap(int(0.7 * n_near))
        if tick == 9:
            svc.set_near_cap(None)
        svc.tick()
        hist.append(svc.stats())
    return hist


def service_phase(spec, device) -> tuple[dict, dict]:
    """TieringService on the churn fleet for 12 ticks of the script above,
    through the kernels and the plain versions: identical stats() after
    every tick; the sixth tenant waits for the departure."""
    runs = {}
    for backend in ("auto", "torch"):
        gc.collect()
        torch.cuda.empty_cache()
        registry.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        svc = serve_engine.TieringService(spec, accesses_per_window=CHURN_APW,
                                          kernel_backend=backend, device=device)
        hist, t = cuda_seconds(lambda: service_script(svc, spec.cfg.n_near))
        runs[backend] = (hist, t / SERVICE_TICKS, registry.launch_counts(),
                         torch.cuda.max_memory_allocated())
        del svc
    hist, counts = runs["auto"][0], runs["auto"][2]
    if runs["torch"][0] != hist:
        raise AssertionError("service: stats() differ between the kernel and plain runs")
    missing = [k for k in ENGINE_KERNELS if counts[k] == 0]
    if missing or any(runs["torch"][2].values()):
        raise AssertionError(f"service: launches {counts} / {runs['torch'][2]}")
    sixth = hist[-1]["tenants"][15]
    if [h["resident"] for h in hist[:4]] != [5] * 4 or sixth["admission_latency"] < 4:
        raise AssertionError(f"service: the sixth tenant got in before the departure: {hist}")
    return dict(
        phase="service", ticks=SERVICE_TICKS, lanes=spec.n_guests, tenants=6,
        k=CHURN_APW, s_per_tick=runs["auto"][1], s_per_tick_plain=runs["torch"][1],
        launches=counts, peak_gb=max(r[3] for r in runs.values()) / 1e9,
        sixth_tenant_admission_latency=sixth["admission_latency"],
        pressure=[h["pressure"] for h in hist], near_cap=[h["near_cap"] for h in hist],
        resident=[h["resident"] for h in hist], stats=hist[-1], identical=True), counts


# --------------------------------------------------------------------------
# 15-17. PEBS telemetry and N-tier hierarchies
# --------------------------------------------------------------------------
PEBS_TIMED = 5  # timed calls of hot_mask_pebs alone
# benchmarks/fig_tco_curve.py's first 3-tier point: DRAM / zram (x3) / NVMM
NTIER_SPECS = dict(near_fraction=0.15, mid_fraction=0.25, compression=3.0)
NTIER_COLLECT = ("hits", "near_blocks", "tco")
NTIER_POLICIES = (("hybridtier", N_WINDOWS), ("compressed", 4), ("memtierd", 4),
                  ("autonuma", 4), ("tpp", 4))
TWO_TIER_WINDOWS = 4


def kernel_and_plain(label: str, run) -> dict:
    """``run(backend)`` once through the kernels and once plain, the launch
    counts set to 0 just before each and read just after: the kernel run
    must launch K1-K4 and the plain run nothing. Returns both results, their
    seconds and the kernel run's counts."""
    out = {}
    for backend in ("auto", "torch"):
        gc.collect()
        torch.cuda.empty_cache()
        registry.reset_launch_counts()
        result, t = cuda_seconds(lambda: run(backend))
        counts = registry.launch_counts()
        if backend == "torch" and any(counts.values()):
            raise AssertionError(f"{label}: the plain run launched kernels: {counts}")
        missing = [k for k in ENGINE_KERNELS if counts[k] == 0]
        if backend == "auto" and missing:
            raise AssertionError(f"{label}: kernels never launched on the path: {missing}")
        out[backend] = (result, t, counts)
    return out


def window_counts(spec, trace_window: torch.Tensor) -> torch.Tensor:
    """float32[n_logical]: one window's access counts per page."""
    ids = spec.localize(trace_window).reshape(-1)
    return torch.bincount(ids[ids >= 0].long(), minlength=spec.cfg.n_logical).to(torch.float32)


def binomial_card_vs_cpu(counts: torch.Tensor, epoch: int) -> dict:
    """hot_mask_pebs's draw of ``counts`` on the card and on the CPU: equal
    bit for bit. Returns the card's stats (iterations, branches, syncs) and
    its time."""
    key = prng.fold_in(prng.PRNGKey(0, device=counts.device), epoch)
    stats: dict = {}
    card, t = cuda_seconds(lambda: prng.binomial(key, counts, 0.25, stats=stats))
    cpu = prng.binomial(key.cpu(), counts.cpu(), 0.25)
    if not same_bits(card.cpu(), cpu):
        raise AssertionError(f"pebs: the card's binomial differs from the CPU's: "
                             f"{int((card.cpu() != cpu).sum())} elements")
    return dict(stats, card_ms=t * 1e3, elements=counts.numel(), card_equals_cpu=True)


def pebs_phase(spec, trace: np.ndarray, churn_spec, churn_trace: np.ndarray,
               device) -> tuple[dict, dict]:
    """The engine phase's Redis guest with backend="pebs": 16 memtierd
    windows through the kernels and plain, identical; one window's binomial
    on the card against the CPU's (the Redis window, then the churn fleet's
    window 0, whose masim guest takes the BTRS branch); hot_mask_pebs timed
    alone."""
    kw = dict(RUN, backend="pebs")
    base = filled_state(spec, device)
    runs = kernel_and_plain("pebs", lambda b: engine.run(
        spec, clone_state(base), trace, policy="memtierd", kernel_backend=b,
        device=device, **kw))
    (ref, ref_series), t_k, launches = runs["auto"]
    (st, series), t_p, _ = runs["torch"]
    assert_same_states(ref, st)
    assert_same_series(ref_series, series, "pebs")
    del st, runs
    check_payload(spec, ref)
    stats = {k: int(v) for k, v in ref.stats.items()}
    if stats["consolidated_pages"] == 0 or stats["promoted_blocks"] == 0:
        raise AssertionError(f"pebs: memtierd moved nothing: {stats}")
    del ref
    trace0 = torch.from_numpy(trace[:, 0]).to(device)
    draws = {"redis": binomial_card_vs_cpu(window_counts(spec, trace0), 0)}
    fleet0 = torch.from_numpy(np.ascontiguousarray(churn_trace[:, 0])).to(device)
    draws["churn_fleet"] = binomial_card_vs_cpu(window_counts(churn_spec, fleet0), 0)
    if draws["churn_fleet"]["btrs_elements"] == 0:
        raise AssertionError("pebs: no element of the fleet's window took BTRS")
    st = asp.record_accesses(spec.cfg, clone_state(base), spec.localize(trace0).reshape(-1))
    del base
    mask_ms = statistics.median(
        cuda_seconds(lambda: telemetry.hot_mask(spec.cfg, st, "pebs"))[1] * 1e3
        for _ in range(PEBS_TIMED))
    hot = int(telemetry.hot_mask(spec.cfg, st, "pebs").sum())
    del st
    n_w = trace.shape[1]
    return dict(
        phase="pebs", policy="memtierd", windows=n_w, k=trace.shape[2],
        s_per_window=t_k / n_w, s_per_window_plain=t_p / n_w, launches=launches,
        hot_mask_pebs_ms=mask_ms, hot_pages_window0=hot, binomial=draws, stats=stats,
        identical=True, payload_intact=True), launches


def ntier_phase(trace: np.ndarray, device) -> tuple[dict, dict]:
    """The Redis guest on NTIER_SPECS' three tiers, collecting hits,
    near_blocks and tco: hybridtier for 16 windows and the other four
    policies for 4, each through the kernels and plain, identical; then a
    2-tier TierSpec tuple that resolves to the no-tiers n_near, which must
    equal the no-tiers run (states and series, tco included)."""
    guest = [engine.GuestSpec(N_LOGICAL, workload="redis", seed=0)]
    host = {k: v for k, v in HOST.items() if k != "near_fraction"}
    spec, st = engine.build(guest, engine.HostSpec(**host, tiers=tiers.compressed_specs(
        **NTIER_SPECS)), device=device)
    del st
    pool_gb = spec.cfg.n_gpa_hp * spec.cfg.hp_bytes / 1e9
    base = filled_state(spec, device)
    lines, main_launches = {}, None
    for policy, n_w in NTIER_POLICIES:
        runs = kernel_and_plain(f"ntier {policy}", lambda b: engine.run(
            spec, clone_state(base), trace[:, :n_w], policy=policy, collect=NTIER_COLLECT,
            kernel_backend=b, device=device, **RUN))
        (ref, ref_series), t_k, launches = runs["auto"]
        (st, series), t_p, _ = runs["torch"]
        assert_same_states(ref, st)
        assert_same_series(ref_series, series, f"ntier {policy}")
        if (ref_series["tier_blocks"][:, 0] > spec.tiers.bounds(0)[1]).any():
            raise AssertionError(f"ntier {policy}: tier 0 holds more blocks than its slots")
        check_payload(spec, ref)
        lines[policy] = dict(
            windows=n_w, s_per_window=t_k / n_w, s_per_window_plain=t_p / n_w,
            tco=ref_series["tco"].tolist(), amat_ns=ref_series["amat_ns"].tolist(),
            tier_blocks_last=ref_series["tier_blocks"][-1].tolist(),
            tier_hits_last=ref_series["tier_hits"][-1].tolist(),
            promoted=int(ref.stats["promoted_blocks"]), demoted=int(ref.stats["demoted_blocks"]))
        main_launches = main_launches or launches
        del runs, ref, st
    del base

    # the 2-tier special case against the no-tiers engine
    dram = tiers.TierSpec("dram", HOST["near_fraction"], 90.0)
    nvmm = tiers.TierSpec("nvmm", 1.0, 350.0, cost_per_gb=0.4)
    spec2, st = engine.build(guest, engine.HostSpec(**host, tiers=(dram, nvmm)), device=device)
    spec0, _ = engine.build(guest, engine.HostSpec(**HOST), device=device)
    del st
    if spec2.cfg != spec0.cfg or spec2.tiers.boundaries != (0, spec0.cfg.n_near, spec0.cfg.n_slots):
        raise AssertionError(f"ntier: the 2-tier spec resolves to {spec2.tiers.boundaries}")
    out = {}
    for name, sp in (("two_tier", spec2), ("no_tiers", spec0)):
        out[name] = engine.run(sp, filled_state(sp, device), trace[:, :TWO_TIER_WINDOWS],
                               policy="memtierd", collect=NTIER_COLLECT, device=device, **RUN)
    assert_same_states(out["two_tier"][0], out["no_tiers"][0])
    assert_same_series(out["no_tiers"][1], out["two_tier"][1], "ntier: 2-tier special case")
    del out
    return dict(
        phase="ntier", specs=NTIER_SPECS, boundaries=list(spec.tiers.boundaries),
        n_near=spec.cfg.n_near, pool_gb=pool_gb, k=trace.shape[2], policies=lines,
        launches=main_launches, two_tier_equals_no_tiers_windows=TWO_TIER_WINDOWS,
        identical=True, payload_intact=True), main_launches


def ntier_fleet(device):
    """The churn fleet's five guests on NTIER_SPECS' three tiers."""
    base = churn_fleet(device)
    host = {k: v for k, v in CHURN_HOST.items() if k != "near_fraction"}
    spec, _ = engine.build(list(base.guests), engine.HostSpec(
        **host, tiers=tiers.compressed_specs(**NTIER_SPECS)), device=device)
    return spec


def ntier_churn_phase(trace: np.ndarray, device) -> tuple[dict, dict, dict]:
    """The churn fleet on three tiers under the churn phase's fault schedule
    (the shrink at window 4 drives the pressure cascade), collecting tco,
    through the kernels and plain, identical; then the service phase's
    script on that fleet (one tenant at tier_floor 1), kernels against
    plain."""
    spec = ntier_fleet(device)
    sched = churn_schedule(spec)
    kw = dict(CHURN_RUN, collect=NTIER_COLLECT)
    runs = kernel_and_plain("ntier_churn", lambda b: engine.run_churn(
        spec, engine.init_churn(spec, filled_state(spec, device), device=device), trace,
        faults=sched, kernel_backend=b, device=device, **kw))
    (ref, ref_series), t_k, launches = runs["auto"]
    (cs, series), t_p, _ = runs["torch"]
    assert_same_churn(ref, cs)
    assert_same_series(ref_series, series, "ntier_churn")
    del cs, runs
    pressure, blocks = ref_series["pressure"], ref_series["tier_blocks"]
    if pressure[4] < 1:
        raise AssertionError(f"ntier_churn: the shrink did not engage: {pressure.tolist()}")
    slots = np.diff(spec.tiers.boundaries)
    if (blocks > slots).any():
        raise AssertionError(f"ntier_churn: a tier holds more blocks than slots: {blocks.tolist()}")
    g = {w: i for i, w in enumerate(CHURN_WORKLOADS)}
    for w in INTACT + WIPED:
        check_payload(spec, ref.state, range(*spec.logical_range(g[w])), wiped=w in WIPED)
    n_w = trace.shape[1]
    line = dict(
        phase="ntier_churn", specs=NTIER_SPECS, boundaries=list(spec.tiers.boundaries),
        windows=n_w, k=trace.shape[2], s_per_window=t_k / n_w, s_per_window_plain=t_p / n_w,
        launches=launches, pressure=pressure.tolist(), tier_blocks=blocks.tolist(),
        tco=ref_series["tco"].tolist(), near_cap=ref_series["near_cap"].tolist(),
        identical=True, payload_checked=True)
    del ref

    svc_runs = {}
    for backend in ("auto", "torch"):
        gc.collect()
        torch.cuda.empty_cache()
        registry.reset_launch_counts()
        svc = serve_engine.TieringService(spec, accesses_per_window=CHURN_APW,
                                          kernel_backend=backend, device=device)
        hist, t = cuda_seconds(lambda: service_script(svc, spec.cfg.n_near))
        svc_runs[backend] = (hist, t / SERVICE_TICKS, registry.launch_counts())
        del svc
    hist, svc_counts = svc_runs["auto"][0], svc_runs["auto"][2]
    if svc_runs["torch"][0] != hist:
        raise AssertionError("ntier service: stats() differ between the kernel and plain runs")
    if [k for k in ENGINE_KERNELS if svc_counts[k] == 0] or any(svc_runs["torch"][2].values()):
        raise AssertionError(f"ntier service: launches {svc_counts} / {svc_runs['torch'][2]}")
    if hist[-1]["tenants"][12]["tier_floor"] != 1:
        raise AssertionError("ntier service: the tier floor was not kept")
    line["service"] = dict(
        s_per_tick=svc_runs["auto"][1], s_per_tick_plain=svc_runs["torch"][1],
        launches=svc_counts, pressure=[h["pressure"] for h in hist],
        resident=[h["resident"] for h in hist], tenants=hist[-1]["tenants"], identical=True)
    return line, launches, svc_counts


# --------------------------------------------------------------------------
# 18-19. sharded runs over torch.distributed
# --------------------------------------------------------------------------
SHARDED_RUN = dict(backend="ipt", use_gpac=True, max_batches=4, budget=64,
                   windows_per_step=4)
SHARDED_POLICIES = (("memtierd", CHURN_WINDOWS), ("autonuma", 4), ("tpp", 4))
HOST_CHUNK = 1 << 30  # bytes per copy between a state on the card and its pinned host copy
RANKS = 2
RANKS_RSS_SCALE = 0.02  # the 2-rank job's one cut: 1.26 GB of pools, two replicas on one card
RANKS_WINDOWS = 4
RANKS_DIR = ROOT / "build" / "sharded_ranks"


class HostHeld:
    """A state (or churn carry) held in pinned host memory while the card
    runs the next one, and compared with a later state on the card a chunk
    at a time (each chunk copied back into one device buffer). The pinned
    memory is allocated once and reused."""

    def __init__(self):
        self.arena = torch.empty(0, dtype=torch.uint8)
        self.stage = None

    def hold(self, state) -> dict:
        leaves = self._leaves(state)
        need = sum(t.numel() * t.element_size() for _, t in leaves)
        if self.arena.numel() < need:  # with room for a churn carry's extra leaves
            self.arena = torch.empty(0, dtype=torch.uint8)
            self.arena = torch.empty(need + (1 << 24), dtype=torch.uint8, pin_memory=True)
        held, at = {}, 0
        for path, t in leaves:
            n = t.numel() * t.element_size()
            dst = self.arena[at:at + n]
            src = t.contiguous().reshape(-1).view(torch.uint8) if n else t.reshape(-1)
            for i in range(0, n, HOST_CHUNK):
                dst[i:i + HOST_CHUNK].copy_(src[i:i + HOST_CHUNK])
            held[path] = (dst, t.dtype, tuple(t.shape))
            at += n
        torch.cuda.synchronize()
        return held

    def assert_same(self, state, held: dict, what: str) -> None:
        leaves = self._leaves(state)
        if [p for p, _ in leaves] != list(held):
            raise AssertionError(f"{what}: another set of leaves")
        if self.stage is None:
            self.stage = torch.empty(HOST_CHUNK, dtype=torch.uint8, device=state_device(state))
        for path, t in leaves:
            dst, dtype, shape = held[path]
            if t.dtype != dtype or tuple(t.shape) != shape:
                raise AssertionError(f"{what}: {path} has another dtype or shape")
            src = t.contiguous().reshape(-1).view(torch.uint8) if t.numel() else t.reshape(-1)
            for i in range(0, dst.numel(), HOST_CHUNK):
                n = min(HOST_CHUNK, dst.numel() - i)
                self.stage[:n].copy_(dst[i:i + n])
                if not torch.equal(src[i:i + n], self.stage[:n]):
                    raise AssertionError(f"{what}: {path} differs from the unsharded run")

    @staticmethod
    def _leaves(state, path: str = "") -> list:
        if dataclasses.is_dataclass(state):
            state = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
        if isinstance(state, dict):
            return [x for k, v in state.items() for x in HostHeld._leaves(v, f"{path}{k}.")]
        return [(path[:-1], state)]


def state_device(state) -> torch.device:
    return state.state.device if hasattr(state, "active") else state.device


def measured(fn) -> dict:
    """``fn()`` with the launch counts, the peak memory and the collective
    record set to 0 just before and read just after."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    sharding.reset_collective_bytes()
    result, t = cuda_seconds(fn)
    return dict(result=result, seconds=t, launches=registry.launch_counts(),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                collective_bytes=sharding.collective_bytes(),
                collective_calls=sharding.collective_calls())


def sharded_case(label: str, n_w: int, spec, reference, sharded: dict, device,
                 host: HostHeld) -> dict:
    """``reference(state)`` (the unsharded run, through the kernels) held on
    the host, then every ``sharded[name](backend, state)`` through the
    kernels and plain, each from a fresh filled state made before its clock
    starts: each must equal the reference bit for bit, each kernel run must
    launch K1-K4 and each plain run nothing. Returns the case's line and the
    first kernel run's counts."""
    t0 = time.perf_counter()
    state = filled_state(spec, device)
    ref = measured(lambda: reference(state))
    del state
    (held_state, ref_series) = ref.pop("result")
    held = host.hold(held_state)
    del held_state
    line = dict(case=label, windows=n_w, s_per_window_run=ref["seconds"] / n_w,
                peak_gb_run=ref["peak_gb"], runs={})
    first = None
    for name, fn in sharded.items():
        for backend in ("auto", "torch"):
            state = filled_state(spec, device)
            out = measured(lambda: fn(backend, state))
            del state
            state, series = out.pop("result")
            host.assert_same(state, held, f"{label} {name} {backend}")
            assert_same_series(ref_series, series, f"{label} {name} {backend}")
            del state
            counts = out["launches"]
            if backend == "torch" and any(counts.values()):
                raise AssertionError(f"{label} {name}: the plain run launched {counts}")
            missing = [k for k in ENGINE_KERNELS if counts[k] == 0]
            if backend == "auto" and missing:
                raise AssertionError(f"{label} {name}: kernels never launched: {missing}")
            first = first or counts
            line["runs"][f"{name}/{backend}"] = dict(
                s_per_window=out["seconds"] / n_w, peak_gb=out["peak_gb"],
                launches=counts if backend == "auto" else None,
                collective_bytes=out["collective_bytes"],
                collective_calls=out["collective_calls"])
    del held
    line["seconds"] = time.perf_counter() - t0
    return line, first


def sharded_phase(trace: np.ndarray, device) -> tuple[dict, dict, dict]:
    """Phase 6's fleet on a forced one-rank NCCL mesh: ``run_sharded`` on the
    replicated and the host-partitioned path (memtierd, autonuma, tpp), the
    host-partitioned path at arbitration stride 2, ``run_churn(mesh=)``
    under phase 6's schedule and ``compressed`` host-partitioned on three
    tiers with ``tco``, each through the kernels and plain and equal to
    ``run`` / ``run_churn`` bit for bit."""
    t0 = time.perf_counter()
    spec = churn_fleet(device)
    mesh = sharding.guest_mesh(1, device=device)
    host = HostHeld()
    cases, sharded_launches, churn_launches = [], None, None

    def run_ref(policy, n_w, s=spec, **kw):
        return lambda st: engine.run(s, st, trace[:, :n_w], policy=policy,
                                     kernel_backend="auto", device=device,
                                     **SHARDED_RUN, **kw)

    def run_sh(policy, n_w, host_sharded, s=spec, **kw):
        return lambda b, st: engine.run_sharded(
            s, st, trace[:, :n_w], mesh=mesh, host_sharded=host_sharded, policy=policy,
            kernel_backend=b, device=device, **SHARDED_RUN, **kw)

    for policy, n_w in SHARDED_POLICIES:
        line, counts = sharded_case(policy, n_w, spec, run_ref(policy, n_w), {
            "replicated": run_sh(policy, n_w, False),
            "host_partitioned": run_sh(policy, n_w, True)}, device, host)
        cases.append(line)
        sharded_launches = sharded_launches or counts
    line, _ = sharded_case("memtierd_stride2", CHURN_WINDOWS, spec,
                           run_ref("memtierd", CHURN_WINDOWS, arbitration_stride=2),
                           {"host_partitioned": run_sh("memtierd", CHURN_WINDOWS, True,
                                                       arbitration_stride=2)}, device, host)
    cases.append(line)

    sched = churn_schedule(spec)

    def churn(mesh_, st, b="auto"):
        cs = engine.init_churn(spec, st, device=device)
        return engine.run_churn(spec, cs, trace, faults=sched, mesh=mesh_, kernel_backend=b,
                                device=device, **CHURN_RUN)

    line, churn_launches = sharded_case(
        "churn", trace.shape[1], spec, lambda st: churn(None, st),
        {"mesh": lambda b, st: churn(mesh, st, b)}, device, host)
    cases.append(line)

    nspec = ntier_fleet(device)
    n_w = 4
    line, _ = sharded_case(
        "compressed", n_w, nspec, run_ref("compressed", n_w, s=nspec, collect=NTIER_COLLECT),
        {"host_partitioned": run_sh("compressed", n_w, True, s=nspec,
                                    collect=NTIER_COLLECT)}, device, host)
    cases.append(line)
    del host
    torch.distributed.destroy_process_group()
    cfg = spec.cfg
    part = {n: sharding.host_state_bytes_sharded(cfg, sharding.host_partition(spec, n))
            for n in (1, 2, 4)}
    return dict(phase="sharded", mesh=dict(ranks=mesh.size, backend=mesh.backend,
                                           device=str(mesh.device)),
                n_gpa_hp=cfg.n_gpa_hp, n_near=cfg.n_near,
                host_state_bytes=sharding.host_state_bytes(cfg),
                host_state_bytes_sharded=part, cases=cases, identical=True,
                seconds=time.perf_counter() - t0), \
        sharded_launches, churn_launches


def state_digest(state) -> dict:
    """SHA-256 of every leaf's bytes (a state on the card, hashed on the
    host)."""
    import hashlib

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        leaves = v.items() if isinstance(v, dict) else [("", v)]
        for k, t in leaves:
            out[f"{f.name}{'.' + k if k else ''}"] = hashlib.sha256(
                t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
    return out


def ranks_fleet(device):
    spec = churn_fleet(device, RANKS_RSS_SCALE)
    return spec, engine.guest_traces(spec, RANKS_WINDOWS, CHURN_APW)


RANKS_RUNS = (("memtierd", True), ("memtierd", False), ("tpp", True), ("tpp", False))


def sharded_rank_worker(out_dir: str) -> None:
    """One rank of the ``sharded_ranks`` job (``--sharded-rank``): the
    reduced fleet through ``run_sharded`` on the job's gloo mesh, every run
    through the kernels; writes its digests, series and numbers."""
    from repro_torch.launch import multihost

    info = multihost.initialize()
    mesh = multihost.global_guest_mesh(device="cuda")
    device = mesh.device
    spec, trace = ranks_fleet(device)
    out = {}
    for policy, host_sharded in RANKS_RUNS:
        state = filled_state(spec, device)
        m = measured(lambda: engine.run_sharded(
            spec, state, trace, mesh=mesh, host_sharded=host_sharded, policy=policy,
            device=device, **SHARDED_RUN))
        st, series = m.pop("result")
        out[f"{policy}/{'host_partitioned' if host_sharded else 'replicated'}"] = dict(
            digest=state_digest(st), series={k: v.tolist() for k, v in series.items()},
            s_per_window=m["seconds"] / RANKS_WINDOWS, peak_gb=m["peak_gb"],
            launches=m["launches"], collective_bytes=m["collective_bytes"],
            collective_calls=m["collective_calls"])
        del state, st
    torch.distributed.destroy_process_group()
    (pathlib.Path(out_dir) / f"rank{info.process_id}.json").write_text(json.dumps(out))
    print(f"sharded rank {info.process_id} of {info.num_processes} done", flush=True)


def sharded_ranks_phase(device) -> dict:
    """``multihost.launch`` starts RANKS ranks on this one card over gloo;
    each runs the reduced fleet host-partitioned and replicated, memtierd
    and tpp, and every rank's state and series must equal this process's
    ``run`` bit for bit (SHA-256 of every leaf; series exactly)."""
    from repro_torch.launch import multihost

    t_phase = time.perf_counter()
    spec, trace = ranks_fleet(device)
    want = {}
    for policy in ("memtierd", "tpp"):
        state, series = engine.run(spec, filled_state(spec, device), trace, policy=policy,
                                   device=device, **SHARDED_RUN)
        want[policy] = (state_digest(state), {k: v.tolist() for k, v in series.items()})
        del state
    RANKS_DIR.mkdir(parents=True, exist_ok=True)
    for old in RANKS_DIR.glob("rank*.json"):
        old.unlink()
    t0 = time.perf_counter()
    results = multihost.launch_check(str(ROOT / "chip_smoke.py"), marker="done",
                                     num_processes=RANKS, args=("--sharded-rank", RANKS_DIR),
                                     backend="gloo", device="cuda", cwd=str(ROOT),
                                     timeout=600)
    wall = time.perf_counter() - t0
    ranks = [json.loads((RANKS_DIR / f"rank{r}.json").read_text()) for r in range(RANKS)]
    for r, res in enumerate(ranks):
        for key, got in res.items():
            digest, series = want[key.split("/")[0]]
            if got["digest"] != digest:
                bad = sorted(k for k in digest if got["digest"][k] != digest[k])
                raise AssertionError(f"sharded_ranks: rank {r} {key} state differs: {bad}")
            if got["series"] != series:
                raise AssertionError(f"sharded_ranks: rank {r} {key} series differ")
            missing = [k for k in ENGINE_KERNELS if got["launches"][k] == 0]
            if missing:
                raise AssertionError(f"sharded_ranks: rank {r} {key} never launched {missing}")
    cfg = spec.cfg
    full = sharding.host_state_bytes(cfg)
    per_rank = sharding.host_state_bytes_sharded(cfg, sharding.host_partition(spec, RANKS))
    return dict(
        phase="sharded_ranks", ranks=RANKS, backend="gloo", rss_scale=RANKS_RSS_SCALE,
        windows=RANKS_WINDOWS, n_gpa_hp=cfg.n_gpa_hp, n_near=cfg.n_near,
        pool_gb=cfg.n_gpa_hp * cfg.hp_bytes / 1e9, host_state_bytes=full,
        host_state_bytes_per_rank=per_rank, per_rank_share=per_rank / full,
        launch_s=wall, outputs=[r.stdout.strip().splitlines()[-1] for r in results],
        runs={key: [{k: res[key][k] for k in ("s_per_window", "peak_gb", "launches",
                                              "collective_bytes", "collective_calls")}
                    for res in ranks] for key in ranks[0]},
        identical=True, seconds=time.perf_counter() - t_phase)


# --------------------------------------------------------------------------
# 21. contracts: DESIGN.md §15's invariants through the hand kernels
# --------------------------------------------------------------------------
CONTRACT_SEED = 0
# the reference harness's ranges (tests/strategies.py: guest_draws,
# contract_draws), sampled here with numpy: this script imports nothing of
# the JAX package
CONTRACT_WORKLOADS = ("redis", "masim", "liblinear", "hash")


def contract_draw(rng: np.random.Generator) -> ContractDraw:
    """One point of the contracts' parameter space: 1-3 ragged guests,
    ``hp_ratio`` 4 or 8, 3-5 windows of 8-32 accesses, a chunk size in
    ``[2, n_windows]`` (dividing or not), either source and host path, any
    builtin policy, the pressure knobs and a telemetry seed."""
    hp_ratio = int(rng.choice([4, 8]))
    guests = tuple(
        GuestDraw(n_logical=int(rng.integers(hp_ratio, 4 * hp_ratio + 1)),
                  cl=None if rng.random() < 0.5 else int(rng.integers(1, hp_ratio + 1)),
                  gpa_slack=float(rng.choice([0.25, 0.5])),
                  workload=str(rng.choice(CONTRACT_WORKLOADS)),
                  seed=int(rng.integers(0, 6)))
        for _ in range(int(rng.integers(1, 4))))
    n_windows = int(rng.integers(3, 6))
    return ContractDraw(
        guests=guests, hp_ratio=hp_ratio,
        near_fraction=float(rng.choice([0.25, 0.5])),
        host_cl=int(rng.integers(1, hp_ratio + 1)),
        policy=str(rng.choice(tiering.POLICIES)),
        use_gpac=bool(rng.random() < 0.5), synth=bool(rng.random() < 0.5),
        n_windows=n_windows, accesses_per_window=int(rng.integers(8, 33)),
        windows_per_step=int(rng.integers(2, n_windows + 1)),
        host_sharded=bool(rng.random() < 0.5), cap=int(rng.integers(0, 7)),
        budget=int(rng.integers(1, 9)), slack=int(rng.integers(0, 3)),
        seed=int(rng.integers(0, 1024)))


def contracts_phase(device) -> dict:
    """Every registered contract on the card with ``kernel_backend="auto"``
    (the hand kernels) over ``fallback_draws()`` and its ``max_examples``
    draws from ``contract_draw``; one line per contract with its draws,
    seconds and kernel launches by name. INV-MULTIHOST-EXACT starts its
    2-rank job once, over gloo on this card. A failing draw is printed and
    raises."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(CONTRACT_SEED)
    summary = {}
    for c in contracts.all_contracts():
        todo = list(fallback_draws()) + [contract_draw(rng) for _ in range(c.max_examples)]
        registry.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, draw in enumerate(todo):
            try:
                c.check_fn(draw, device=device)
            except Exception:
                emit(dict(phase="contracts", contract=c.name, failed_draw=i,
                          draw=dataclasses.asdict(draw)))
                raise
        torch.cuda.synchronize()
        line = dict(phase="contracts", contract=c.name, draws=len(todo),
                    seconds=time.perf_counter() - t0, launches=registry.launch_counts())
        emit(line)
        summary[c.name] = line
    if torch.distributed.is_initialized():  # the contracts' one-rank mesh
        torch.distributed.destroy_process_group()
    backend_launches = summary["INV-KERNEL-BACKEND-EXACT"]["launches"]
    missing = [k for k in ENGINE_KERNELS if not backend_launches[k]]
    if missing:
        raise AssertionError(f"contracts: kernel_backend='auto' never launched {missing}")
    return dict(phase="contracts", seed=CONTRACT_SEED, contracts=len(summary),
                draws=sum(v["draws"] for v in summary.values()),
                seconds_by_contract={k: v["seconds"] for k, v in summary.items()},
                passed=True, seconds=time.perf_counter() - t_phase)


# --------------------------------------------------------------------------
# 8. serving: qwen2-0.5b at full width over the GPAC-tiered paged KV cache
# --------------------------------------------------------------------------
SERVE = dict(max_seqs=8, max_seq_len=2048, page_size=16, pages_per_block=4,
             near_fraction=0.4, maintenance_every=8, reserve_tokens=8)
N_REQUESTS, PROMPT_LEN, MAX_NEW = 16, 1024, 32
SERVE_TRAFFIC = dict(n_requests=N_REQUESTS, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                     max_seq_len=SERVE["max_seq_len"])
# Tolerances. paged_attention against its plain version: the same float32
# sums in another order, so float32 outputs agree within 1e-5 and bf16
# outputs within one bf16 rounding step (2^-7 relative). The first decode
# step's logits of the kernel run against the plain run: a one-step bf16
# difference in one layer's attention output passes through 24 layers of
# bf16 residual adds, so they are held to 2^-4 of the largest logit.
SERVE_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=1e-6, rtol=2 ** -7)}
LOGITS_RTOL = 2 ** -4
SERVE_KERNELS = ("paged_attention", "hot_count", "topk_rows", "gather_rows")  # the path's
PORT_SERVE_KERNELS = ("paged_attn_", "hot_count_", "topk_rows_", "gather_rows_")


def serve_model(device):
    cfg = configs.get("qwen2-0.5b").replace(page_size=SERVE["page_size"])
    model = model_registry.build(cfg)
    return model, model.init(seed=0, device=device)


def serve_engine_for(model, params, device, use_gpac: bool, kernel_backend: str,
                     max_seq_len: int = SERVE["max_seq_len"]):
    ecfg = serve_engine.EngineConfig(
        max_seqs=SERVE["max_seqs"], max_seq_len=max_seq_len,
        pages_per_block=SERVE["pages_per_block"], near_fraction=SERVE["near_fraction"],
        sched=SchedulerConfig(max_seqs=SERVE["max_seqs"],
                              maintenance_every=SERVE["maintenance_every"],
                              use_gpac=use_gpac, reserve_tokens=SERVE["reserve_tokens"]))
    return serve_engine.Engine(model, params, ecfg, device=device,
                               kernel_backend=kernel_backend)


def serve_requests(vocab: int, n: int | None = None, traffic: dict = SERVE_TRAFFIC) -> list:
    n = traffic["n_requests"] if n is None else n
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab, traffic["prompt_len"]).tolist(),
                    max_new=traffic["max_new"]) for i in range(n)]


class FirstStepProbe:
    """Inside one decode step: keeps each MoE layer's routing (``moe.route``)
    and, with ``check_k6``, holds every paged_attention call against its
    plain version on the same inputs at SERVE_TOL (the plain call launches
    nothing)."""

    def __init__(self, check_k6: bool):
        self.check_k6 = check_k6
        self.routes: list[torch.Tensor] = []
        self.k6_calls, self.k6_max_abs_err = 0, 0.0

    def __enter__(self):
        self._route, self._dispatch = moe.route, registry.dispatch

        def route(cfg, p, xt, *dist):
            weights, experts = self._route(cfg, p, xt, *dist)
            self.routes.append(experts.clone())
            return weights, experts

        def dispatch(name, choice, *args, **kw):
            out = self._dispatch(name, choice, *args, **kw)
            if name == "paged_attention" and self.check_k6:
                want = registry.get_kernel(name).plain(*args, **kw)
                torch.testing.assert_close(out.float(), want.float(), **SERVE_TOL[out.dtype])
                self.k6_calls += 1
                self.k6_max_abs_err = max(self.k6_max_abs_err,
                                          float((out.double() - want.double()).abs().max()))
            return out

        moe.route, registry.dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        moe.route, registry.dispatch = self._route, self._dispatch


def instrument(eng, probe: FirstStepProbe | None = None) -> dict:
    """Time each prefill (between synchronisations) and keep the first
    decode step's logits, by wrapping the engine's two calls; the first
    decode step runs inside ``probe`` where one is given."""
    rec = dict(prefill_s=[], first_logits=None)
    prefill, decode = eng._prefill_into_slot, eng.decode_fn

    def timed_prefill(req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(req)
        torch.cuda.synchronize()
        rec["prefill_s"].append(time.perf_counter() - t0)

    def kept_decode(p, c, t):
        if rec["first_logits"] is not None:
            return decode(p, c, t)
        if probe is None:
            logits, c = decode(p, c, t)
        else:
            with probe:
                logits, c = decode(p, c, t)
        rec["first_logits"] = logits.clone()
        return logits, c

    eng._prefill_into_slot, eng.decode_fn = timed_prefill, kept_decode
    return rec


def serve_run(model, params, device, use_gpac: bool, kernel_backend: str,
              traffic: dict = SERVE_TRAFFIC, probe: FirstStepProbe | None = None) -> dict:
    """The whole batch through one engine; the launch counts are set to 0
    just before and read just after. A step's decode time is its time less
    its prefills'; it includes the GPAC/tier maintenance on its cadence."""
    eng = serve_engine_for(model, params, device, use_gpac, kernel_backend,
                           traffic["max_seq_len"])
    reqs = serve_requests(model.cfg.vocab, traffic=traffic)
    for r in reqs:
        eng.sched.submit(r)
    rec = instrument(eng, probe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    decode_s = []
    t0 = time.perf_counter()
    while eng.sched.has_work:
        t_step, n_pre = time.perf_counter(), len(rec["prefill_s"])
        eng.step()
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t_step - sum(rec["prefill_s"][n_pre:]))
    wall = time.perf_counter() - t0
    launches = registry.launch_counts()
    tokens = [r.out for r in reqs]
    if not all(len(t) == traffic["max_new"] and all(0 <= x < model.cfg.vocab for x in t)
               for t in tokens):
        raise AssertionError("a request did not complete with valid tokens")
    if not torch.isfinite(rec["first_logits"]).all():
        raise AssertionError("non-finite logits")
    return dict(eng=eng, tokens=tokens, launches=launches, stats=eng.stats(),
                first_logits=rec["first_logits"], decode_steps=len(decode_s),
                prefill_s=sum(rec["prefill_s"]), n_prefills=len(rec["prefill_s"]),
                s_per_decode_step=statistics.median(decode_s),
                s_per_decode_step_mean=sum(decode_s) / len(decode_s), wall_s=wall,
                tokens_per_s=sum(map(len, tokens)) / wall,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def serve_phase(model, params, device) -> tuple[dict, object, dict]:
    """GPAC off and on through the kernels, then the plain versions. Returns
    the phase's line, the GPAC-on engine (its state feeds the serve kernel
    rows) and the main path's launch counts (the GPAC-on kernel run)."""
    n_layers = model.cfg.n_layers
    runs = {}
    for key, use_gpac, backend in (("kernels_gpac_off", False, "auto"),
                                   ("kernels_gpac_on", True, "auto"),
                                   ("plain_gpac_on", True, "torch")):
        runs[key] = serve_run(model, params, device, use_gpac, backend)
        counts = runs[key]["launches"]
        if backend == "torch" and any(counts.values()):
            raise AssertionError(f"serve {key}: the plain run launched kernels: {counts}")
        if backend == "auto" and counts["paged_attention"] != runs[key]["decode_steps"] * n_layers:
            raise AssertionError(f"serve {key}: paged_attention launched "
                                 f"{counts['paged_attention']} times in "
                                 f"{runs[key]['decode_steps']} decode steps")
    on, off, plain = runs["kernels_gpac_on"], runs["kernels_gpac_off"], runs["plain_gpac_on"]
    if on["tokens"] != off["tokens"]:
        raise AssertionError("GPAC changed the generated tokens")
    if on["stats"]["consolidated_pages"] == 0:
        raise AssertionError(f"GPAC consolidated nothing: {on['stats']}")
    missing = [k for k in SERVE_KERNELS if on["launches"][k] == 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched on the path: {missing}")
    diff = float((on["first_logits"] - plain["first_logits"]).abs().max())
    scale = float(plain["first_logits"].abs().max())
    if not diff <= LOGITS_RTOL * scale:
        raise AssertionError(f"first decode logits differ by {diff} (largest {scale})")
    pairs = [(a, b) for ta, tb in zip(on["tokens"], plain["tokens"]) for a, b in zip(ta, tb)]
    keep = ("decode_steps", "prefill_s", "n_prefills", "s_per_decode_step",
            "s_per_decode_step_mean", "wall_s", "tokens_per_s", "peak_gb", "launches")
    line = dict(
        phase="serve", arch=model.cfg.name, params=model.cfg.param_count(),
        dtype=str(model.cfg.dtype), requests=N_REQUESTS, prompt_len=PROMPT_LEN,
        max_new=MAX_NEW, **SERVE,
        kv_cache_gb=sum(t.numel() * t.element_size() for lc in on["eng"].cache["layers"].values()
                        for t in lc.values()) / 1e9,
        runs={k: {f: r[f] for f in keep} for k, r in runs.items()},
        stats_gpac_on=on["stats"], stats_gpac_off=off["stats"],
        tokens_identical_gpac_on_off=True,
        first_logits_max_abs_diff_vs_plain=diff, first_logits_max_abs=scale,
        logits_rtol=LOGITS_RTOL,
        token_agreement_vs_plain=sum(a == b for a, b in pairs) / len(pairs))
    del runs["kernels_gpac_off"]["eng"], runs["plain_gpac_on"]["eng"]
    return line, on["eng"], on["launches"]


def serve_profile_phase(model, params, device, n_steps: int = 4) -> dict:
    """Device time of ``n_steps`` decode steps of a full batch (8 running
    sequences, past their prefills) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    eng = serve_engine_for(model, params, device, True, "auto")
    for r in serve_requests(model.cfg.vocab, SERVE["max_seqs"]):
        eng.sched.submit(r)
    eng.step()  # admits and prefills all 8, then decodes once
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(phase="serve_profile", decode_steps=n_steps,
                wall_s_per_step_profiled=wall / n_steps,
                **device_summary(prof, PORT_SERVE_KERNELS, n_steps, "step"))


def paged_attention_case(eng, layer: str, dtype, lens: torch.Tensor, gen: torch.Generator,
                         note: str = "") -> tuple:
    """K6 on one attention layer's pages of an engine's cache (group 0) at
    the decode shape, in ``dtype``, with a random q and the yardstick: SDPA
    over K/V gathered into contiguous rows beforehand."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    cfg, dev = eng.model.cfg, eng.device
    B, KVH, G, hd = SERVE["max_seqs"], cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    kp = eng.cache["layers"][layer]["k_pages"][0]
    vp = eng.cache["layers"][layer]["v_pages"][0]
    btab = eng.cache["btab"]
    pps, page = btab.shape[1], cfg.page_size
    q = torch.randn((B, KVH, G, hd), generator=gen, device=dev).to(dtype)
    k, v = kp.to(dtype), vp.to(dtype)
    bidx = torch.arange(B, device=dev)[:, None]
    safe = btab.clamp(0, k.shape[2] - 1).long()
    kg = k[bidx, :, safe].transpose(1, 2).reshape(B, KVH, pps * page, hd).contiguous()
    vg = v[bidx, :, safe].transpose(1, 2).reshape(B, KVH, pps * page, hd).contiguous()
    mask = (torch.arange(pps * page, device=dev) < lens[:, None])[:, None, None, :]
    qs = q.reshape(B, KVH * G, 1, hd)
    n_tok = int(lens.clamp(0, pps * page).sum())
    row = hd * q.element_size()
    nbytes = 2 * n_tok * KVH * row + 2 * _nbytes(q) + _nbytes(btab, lens)
    return (
        "paged_attention", f"decode {str(dtype)[6:]} B={B} KVH={KVH} G={G} hd={hd} "
        f"page={page} pps={pps} len={int(lens.min())}-{int(lens.max())}" + note,
        (q, k, v, btab, lens),
        lambda: sdpa(qs, kg, vg, attn_mask=mask, enable_gqa=True),
        nbytes, 4 * G * hd * n_tok * KVH, SERVE_TOL[dtype])


def serve_kernel_cases(eng, gen: torch.Generator) -> list:
    """The serving path's kernels at its shapes, on the GPAC-on run's final
    cache and placement state: paged_attention on layer 0's pages at the
    full-width decode shape (bf16, the same data in float32, and bf16 at
    ragged lens), hot_count at 4 pages per block, gather_rows on the 8-byte
    placement rows and topk_rows on one daemon's filter row."""
    pcfg, dev = eng.pcfg, eng.device
    lens = eng.cache["lens"] + 1
    # ragged: per-sequence lens across the cache's range (on no path)
    ragged = torch.randint(16, SERVE["max_seq_len"] + 1, (SERVE["max_seqs"],), generator=gen,
                           device=dev, dtype=torch.int32)
    cases = [paged_attention_case(eng, "layer0", dtype, lens_, gen,
                                  " ragged (on no path)" if lens_ is ragged else "")
             for dtype, lens_ in ((torch.bfloat16, lens), (torch.float32, lens),
                                  (torch.bfloat16, ragged))]
    st = eng.pstate
    hot = telemetry.hot_mask(pcfg, st, "ipt")
    hot_gpa = torch.where(st.rmap >= 0, hot[st.rmap.clamp(min=0)], False)
    hp = pcfg.hp_ratio
    score = torch.where(hot, pfilter._hotness_score(st), -1)[None]
    k_top = 2 * hp  # the engine's max_batches (2) x hp_ratio
    near_rows = st.near_pool.view(-1, pcfg.base_elems)
    ids = torch.randint(0, near_rows.shape[0], (1, hp), generator=gen, device=dev,
                        dtype=torch.int32)
    cases += [
        ("hot_count", f"serve placement hp_ratio={hp}", (hot_gpa, hp),
         lambda: hot_gpa.view(-1, hp).sum(dim=1, dtype=torch.int32),
         _nbytes(hot_gpa) + 4 * pcfg.n_gpa_hp, hot_gpa.numel(), None),
        ("gather_rows", f"serve placement rows of {near_rows.shape[1] * 4} bytes",
         (near_rows, ids), lambda: torch.index_select(near_rows, 0, ids.view(-1)),
         2 * hp * near_rows.shape[1] * 4 + _nbytes(ids), 0, None),
        ("topk_rows", f"serve filter rows=1 width={score.shape[1]} k={k_top}",
         (score, k_top), lambda: torch.topk(score, k_top, dim=1),
         _nbytes(score) + 8 * k_top, score.numel(), None),
    ]
    return cases


# --------------------------------------------------------------------------
# 9. the kernel registry's entry points: K5a, K5b and K7 at full width
# --------------------------------------------------------------------------
PADDED_SLOTS = 64
FA_CASES = (("a", 1, 1024, torch.bfloat16), ("b", 1, 1024, torch.float32),
            ("c", 8, 2048, torch.bfloat16))
OPS_PER_S = {torch.bfloat16: BF16_OPS_PER_S, torch.float32: FP32_OPS_PER_S}
ENTRY_POINTS = {"consolidate_region": consolidate_region, "scatter_region": scatter_region,
                "gqa_attention": gqa_attention}  # the public calls of the slice's path


def registry_cases(spec, device, gen, model_cfg) -> list:
    """K5a/K5b on one region of the engine's far row space, filled as the
    engine phase fills it, and K7 at qwen2-0.5b's width."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    cfg = spec.cfg
    far = filled_state(spec, device).far_pool.view(-1, cfg.base_elems)  # the near pool goes
    hp, row_bytes = cfg.hp_ratio, cfg.base_elems * far.element_size()
    ids = torch.randperm(far.shape[0], generator=gen, device=device)[:hp].to(torch.int32)
    ids[hp - PADDED_SLOTS:] = -1
    sids = ids.clone()
    sids[hp - PADDED_SLOTS - 1] = sids[0]  # one duplicate destination: the later slot wins
    region = torch.randn((hp, cfg.base_elems), generator=gen, device=device)
    valid, svalid = ids >= 0, sids >= 0
    safe, pad = ids.clamp(min=0), ~valid[:, None]
    n_valid, n_dest = int(valid.sum()), int(sids[svalid].unique().numel())
    lib_ids, lib_region = sids[svalid].long(), region[svalid]
    cases = [
        ("consolidate_region", f"far rows {far.shape[0]} x {far.shape[1]} f32, region {hp} "
         f"slots, {PADDED_SLOTS} padded", (far, ids),
         lambda: torch.index_select(far, 0, safe).masked_fill_(pad, 0),
         (n_valid + hp) * row_bytes + _nbytes(ids), 0, None),
        ("scatter_region", f"far rows {far.shape[0]} x {far.shape[1]} f32, region {hp} "
         f"slots, {PADDED_SLOTS} padded, 1 duplicate", (far, region, sids),
         lambda: far.index_copy_(0, lib_ids, lib_region),
         2 * n_dest * row_bytes + _nbytes(sids), 0, None),
    ]
    H, KVH, hd = model_cfg.n_heads, model_cfg.n_kv_heads, model_cfg.hd
    for label, B, S, dtype in FA_CASES:
        q = torch.randn((B, H, S, hd), generator=gen, device=device).to(dtype)
        k, v = (torch.randn((B, KVH, S, hd), generator=gen, device=device).to(dtype)
                for _ in range(2))
        cases.append((
            "gqa_attention", f"({label}) {str(dtype)[6:]} B={B} H={H} KVH={KVH} S={S} "
            f"hd={hd} causal", (q, k, v),
            lambda q=q, k=k, v=v: sdpa(q, k, v, is_causal=True, enable_gqa=True),
            2 * _nbytes(q) + _nbytes(k, v), (4 * B * H * hd * S * (S + 1) // 2, OPS_PER_S[dtype]),
            SERVE_TOL[dtype]))
    return cases


def registry_phase(cases: list, device) -> tuple[dict, dict]:
    """The slice's path: each full-width case through its public entry
    point, then every registry entry's example through ``dispatch``, with
    the launch counts set to 0 just before and read just after. Then each
    example's output is held to its plain version on a fresh copy of the
    example (bit for bit; the attention entries within float32 SERVE_TOL)."""
    registry.reset_launch_counts()
    outs = {}
    for name, case, args, *_ in cases:
        outs[case] = ENTRY_POINTS[name](*args)
    walk = {}
    for kspec in registry.all_kernels():
        args, kw = kspec.example(device)
        walk[kspec.name] = registry.dispatch(kspec.name, "auto", *args, **kw)
    torch.cuda.synchronize()
    counts = registry.launch_counts()
    missing = [n for n in registry.kernel_names() if counts[n] == 0]
    if missing or len(walk) != 9:
        raise AssertionError(f"registry: entries never launched: {missing} (walked {list(walk)})")
    for case, out in outs.items():
        if not torch.isfinite(out).all():
            raise AssertionError(f"registry: non-finite output in {case}")
    errs = {}
    for kspec in registry.all_kernels():
        args, kw = kspec.example(device)
        want = kspec.plain(*args, **kw)
        got = walk[kspec.name]
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        errs[kspec.name] = 0.0
        for g, w in zip(got, want):
            if kspec.name in ("gqa_attention", "paged_attention"):
                torch.testing.assert_close(g, w, **SERVE_TOL[torch.float32])
                errs[kspec.name] = max(errs[kspec.name], float((g - w).abs().max()))
            elif not same_bits(g, w):
                raise AssertionError(f"registry walk: {kspec.name} differs from its plain version")
    return dict(phase="registry", launches=counts, walk_max_abs_err=errs,
                walked=sorted(walk), cases=[c[1] for c in cases]), counts


# --------------------------------------------------------------------------
# 10. the tiered memory substrate at full width
# --------------------------------------------------------------------------
EMBED_ROUNDS, EMBED_BATCH = 4, (8, 1024)
KV_SLOTS, KV_LEN, KV_WINDOWS = 8, 2048, 2


def embedding_run(cfg, table, batches, device, use_gpac: bool) -> dict:
    """Four rounds of record_batch, maintenance and a lookup that must equal
    table[ids] bit for bit, each lookup through K4."""
    store = TieredEmbeddingStore(EmbedSpec(arch=cfg), table, device=device)
    registry.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lookup_s = []
    for b in batches:
        store.record_batch(b)
        store.maintenance(use_gpac=use_gpac)
        ids = torch.from_numpy(b.astype(np.int32)).to(device)
        before = registry.launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = store.lookup(ids)
        torch.cuda.synchronize()
        lookup_s.append(time.perf_counter() - t1)
        after = registry.launch_counts()
        if not (after["gather_rows"] > before["gather_rows"]
                and after["tiered_lookup"] > before["tiered_lookup"]):
            raise AssertionError("embedding lookup did not launch K4")
        if not same_bits(got, table[ids.long()]):
            raise AssertionError(f"embedding lookup differs from the table (gpac {use_gpac})")
    wall = time.perf_counter() - t0
    stats = {k: int(v) for k, v in store.state.stats.items()}
    return dict(near_usage=store.near_usage(), hit_rate=store.hit_rate(), stats=stats,
                launches=registry.launch_counts(), s_per_round=wall / len(batches),
                lookup_s=lookup_s, pool_gb=(store.state.near_pool.numel()
                                            + store.state.far_pool.numel()) * 4 / 1e9)


def kvcache_run(cfg, device, gen, use_gpac: bool) -> dict:
    """Append every slot's groups, record a skewed mass (one hot group per
    tier block) over two maintenance windows, and read every group back."""
    spec = KVSpec(arch=cfg, max_seqs=KV_SLOTS, max_seq_len=KV_LEN)
    cache = TieredKVCache(spec, device=device)
    shape = (spec.groups_per_seq, cfg.n_attn_layers, cfg.n_kv_heads, spec.group_tokens, cfg.hd)
    registry.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kv = []
    for seq in range(KV_SLOTS):
        kv.append(tuple(torch.randn(shape, generator=gen, device=device) for _ in range(2)))
        cache.append_groups(seq, *kv[-1])
    groups = [cache.seq_groups(s) for s in range(KV_SLOTS)]
    hot = np.concatenate([g[:: spec.hp_ratio] for g in groups])
    for _ in range(KV_WINDOWS):
        cache.record_attention_mass(hot, np.full(hot.shape, 0.9))
        cache.maintenance(use_gpac=use_gpac)
    for seq, (k, v) in enumerate(kv):
        k2, v2 = cache.read_groups(groups[seq])
        if not (same_bits(k2, k) and same_bits(v2, v)):
            raise AssertionError(f"KV cache: slot {seq} reads back other values (gpac {use_gpac})")
    torch.cuda.synchronize()
    stats = cache.stats()
    if use_gpac and stats["consolidated_pages"] == 0:
        raise AssertionError(f"KV cache: GPAC consolidated nothing: {stats}")
    return dict(n_logical=spec.n_logical, elems_per_group=spec.elems_per_group,
                pool_gb=(cache.state.near_pool.numel() + cache.state.far_pool.numel()) * 4 / 1e9,
                stats=stats, launches=registry.launch_counts(), wall_s=time.perf_counter() - t0)


def memory_phase(model, params, device, gen) -> dict:
    cfg = model.cfg
    table = params["embed"]["tok"].float()
    if tuple(table.shape) != (cfg.vocab, cfg.d_model):
        raise AssertionError(f"unexpected embedding table {tuple(table.shape)}")
    rng = np.random.default_rng(0)
    batches = [np.minimum(rng.zipf(1.3, size=EMBED_BATCH) - 1, cfg.vocab - 1)
               for _ in range(EMBED_ROUNDS)]
    line = dict(phase="memory", table=list(table.shape), rounds=EMBED_ROUNDS,
                batch=list(EMBED_BATCH), kv_slots=KV_SLOTS, kv_len=KV_LEN,
                kv_windows=KV_WINDOWS)
    for use_gpac in (True, False):
        key = "gpac_on" if use_gpac else "gpac_off"
        line[f"embedding_{key}"] = embedding_run(cfg, table, batches, device, use_gpac)
        torch.cuda.empty_cache()
        line[f"kvcache_{key}"] = kvcache_run(cfg, device, gen, use_gpac)
        torch.cuda.empty_cache()
    line.update(embedding_lookup_bit_exact=True, kvcache_read_back_bit_exact=True)
    return line


# --------------------------------------------------------------------------
# 18. families: every other architecture over the GPAC-tiered paged KV cache
# --------------------------------------------------------------------------
FAMILY_TRAFFIC = dict(n_requests=8, prompt_len=256, max_new=16, max_seq_len=512)
# (arch, traffic, the cut as printed): the published configs in bf16 with
# 16-token pages; qwen2-moe at the serve phase's own traffic
FAMILIES = (
    ("qwen2-moe-a2.7b", SERVE_TRAFFIC, None),
    ("qwen2-vl-2b", FAMILY_TRAFFIC, None),
    ("gemma-7b", FAMILY_TRAFFIC, None),
    ("internlm2-20b", FAMILY_TRAFFIC, None),
    ("smollm-360m", FAMILY_TRAFFIC, None),
    ("whisper-tiny", FAMILY_TRAFFIC, None),
    # its prefill runs the recurrence token by token: 4.8 s a request at 48
    ("xlstm-1.3b", FAMILY_TRAFFIC, "depth 16 of 48 (two super-blocks of 7 mLSTM + 1 sLSTM)"),
    # one MoE layer of 384 experts is 33.8 GB: 61 of them do not fit one card
    ("kimi-k2-1t-a32b", FAMILY_TRAFFIC, "depth 1 of 61 (one MoE layer: 33.8 GB of experts)"),
    # one full-width super-block holds four MoE layers of 77 GB
    ("jamba-1.5-large-398b", FAMILY_TRAFFIC,
     "reduced(): 8 layers, d_model 64 (a full-width super-block is over 80 GB)"),
)
FAMILY_F32_ROW = "gemma-7b"  # K6 in float32 at hd 256: its plan drops to 4 warps


def family_config(arch: str, cut: str | None):
    """The published config with 16-token pages, cut as ``cut`` says:
    ``reduced()``, or ``depth N`` (the first N layers)."""
    if cut is not None and cut.startswith("reduced"):
        cfg = configs.reduced(arch)
    else:
        cfg = configs.get(arch)
        if cut is not None and cut.startswith("depth "):
            cfg = cfg.replace(n_layers=int(cut.split()[1]))
    return cfg.replace(page_size=SERVE["page_size"])


def family_phase(arch: str, traffic: dict, cut: str | None, device,
                 gen: torch.Generator) -> tuple:
    """One architecture through ``Engine``: GPAC off and on through the
    kernels, then the plain versions, each from its first request to its
    last; the first decode step of each run inside a FirstStepProbe.
    Returns the line, the K6 cases on the GPAC-on run's cache, the model
    and its params."""
    cfg = family_config(arch, cut)
    model = model_registry.build(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_attn = cfg.n_attn_layers
    runs, probes = {}, {}
    for key, use_gpac, backend in (("kernels_gpac_off", False, "auto"),
                                   ("kernels_gpac_on", True, "auto"),
                                   ("plain_gpac_on", True, "torch")):
        probes[key] = FirstStepProbe(check_k6=backend == "auto")
        runs[key] = serve_run(model, params, device, use_gpac, backend, traffic, probes[key])
        counts = runs[key]["launches"]
        if backend == "torch" and any(counts.values()):
            raise AssertionError(f"{arch} {key}: the plain run launched kernels: {counts}")
        if backend == "auto" and counts["paged_attention"] != runs[key]["decode_steps"] * n_attn:
            raise AssertionError(f"{arch} {key}: paged_attention launched "
                                 f"{counts['paged_attention']} times in "
                                 f"{runs[key]['decode_steps']} decode steps x {n_attn} layers")
        missing = [k for k in SERVE_KERNELS[0 if n_attn else 1:] if counts[k] == 0]
        if backend == "auto" and use_gpac and missing:
            raise AssertionError(f"{arch} {key}: kernels never launched on the path: {missing}")
        if backend == "auto" and probes[key].k6_calls != n_attn:
            raise AssertionError(f"{arch} {key}: {probes[key].k6_calls} K6 calls held to the "
                                 f"plain version in the first decode step, not {n_attn}")
        if key != "kernels_gpac_on":
            del runs[key]["eng"]  # free its cache
    on, off, plain = runs["kernels_gpac_on"], runs["kernels_gpac_off"], runs["plain_gpac_on"]
    if on["tokens"] != off["tokens"]:
        raise AssertionError(f"{arch}: GPAC changed the generated tokens")
    if n_attn and on["stats"]["consolidated_pages"] == 0:
        raise AssertionError(f"{arch}: GPAC consolidated nothing: {on['stats']}")
    diff = float((on["first_logits"] - plain["first_logits"]).abs().max())
    scale = float(plain["first_logits"].abs().max())
    if not diff <= LOGITS_RTOL * scale:
        raise AssertionError(f"{arch}: first decode logits differ by {diff} (largest {scale})")
    route_k, route_p = probes["kernels_gpac_on"].routes, probes["plain_gpac_on"].routes
    routing_diffs = sum(int((a != b).sum()) for a, b in zip(route_k, route_p))
    pairs = [(a, b) for ta, tb in zip(on["tokens"], plain["tokens"]) for a, b in zip(ta, tb)]
    eng = on.pop("eng")
    leaves = [(k, t) for lc in eng.cache["layers"].values() for k, t in lc.items()]
    paged_kv_gb = _nbytes(*(t for k, t in leaves if k in ("k_pages", "v_pages"))) / 1e9
    state_gb = _nbytes(*(t for k, t in leaves if k not in ("k_pages", "v_pages"))) / 1e9
    enc_kv_gb = _nbytes(*(eng.cache[k] for k in ("enc_k", "enc_v") if k in eng.cache)) / 1e9
    keep = ("decode_steps", "prefill_s", "n_prefills", "s_per_decode_step",
            "s_per_decode_step_mean", "wall_s", "tokens_per_s", "peak_gb", "launches")
    line = dict(
        phase="families", arch=cfg.name, cut=cut, family=cfg.family, n_layers=cfg.n_layers,
        d_model=cfg.d_model, params=cfg.param_count(), active_params=cfg.active_param_count(),
        n_attn_layers=n_attn, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        dtype=str(cfg.dtype), init_s=init_s,
        **traffic, max_seqs=SERVE["max_seqs"], page_size=cfg.page_size,
        paged_kv_gb=paged_kv_gb, recurrent_state_gb=state_gb, encoder_kv_gb=enc_kv_gb,
        runs={k: {f: r[f] for f in keep} for k, r in runs.items()},
        stats_gpac_on=on["stats"], stats_gpac_off=off["stats"],
        tokens_identical_gpac_on_off=True,
        first_logits_max_abs_diff_vs_plain=diff, first_logits_max_abs=scale,
        logits_rtol=LOGITS_RTOL,
        first_step_moe_layers=len(route_k), first_step_routing_diffs=routing_diffs,
        first_step_k6_calls_checked=probes["kernels_gpac_on"].k6_calls,
        first_step_k6_max_abs_err=max(probes[k].k6_max_abs_err
                                      for k in ("kernels_gpac_off", "kernels_gpac_on")),
        token_agreement_vs_plain=sum(a == b for a, b in pairs) / len(pairs))
    cases = []
    if n_attn:  # K6 at this family's decode shape, on its GPAC-on cache
        layer = f"layer{cfg.attn_layers[0] % cfg.group_size}"
        lens = eng.cache["lens"] + 1
        dtypes = (torch.bfloat16, torch.float32) if arch == FAMILY_F32_ROW else (torch.bfloat16,)
        cases = [paged_attention_case(eng, layer, dt, lens, gen, f" ({cfg.name})")
                 for dt in dtypes]
    return line, cases, model, params


def families_phase(device, gen: torch.Generator) -> tuple[list, list]:
    """Every other architecture, one at a time (each freed before the
    next), with qwen2-moe profiled; returns the lines and the K6 rows."""
    lines, rows = [], []
    for arch, traffic, cut in FAMILIES:
        t0 = time.perf_counter()
        line, cases, model, params = family_phase(arch, traffic, cut, device, gen)
        fam_rows = kernels_phase(cases, device, f"families:{line['arch']}") if cases else []
        for row in fam_rows:  # the main path's launches: the GPAC-on kernel run
            row["launches"] = line["runs"]["kernels_gpac_on"]["launches"]["paged_attention"]
        rows += fam_rows
        del cases
        gc.collect()
        torch.cuda.empty_cache()
        if arch == "qwen2-moe-a2.7b":
            line["profile"] = serve_profile_phase(model, params, device)
        line["phase_s"] = time.perf_counter() - t0
        emit(line)
        lines.append(line)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return lines, rows


# --------------------------------------------------------------------------
# 19. train: the training path on the card
# --------------------------------------------------------------------------
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 256, 3e-4  # launch/train.py's defaults
TRAIN_STEPS, TRAIN_UNTIMED, TRAIN_SAVE_AT, TRAIN_PROFILED = 10, 2, 5, 2
TRAIN_DIR = ROOT / "build" / "train_ckpt"
# the MoE's depth: the largest whose state fits TRAIN_BUDGET_GB at these
# bytes a param (bf16 params and grads, the float32 micro-batch accumulator
# and error state; Adafactor's factored state is under 0.1% of it)
TRAIN_BUDGET_GB, MOE_BYTES_PER_PARAM = 60, 2 + 2 + 4 + 4
# the run continued from the middle checkpoint against the uninterrupted one:
# the card's backward sums the embedding's and the MoE combine's gradients
# with atomics, so the order of float additions may differ between runs
CONTINUED_LOSS_RTOL = 1e-3
# one reduced step on the card against the CPU, float32 (TF32 off): the
# loss, and each gradient leaf against its largest entry (the CPU tests' tolerances)
CARD_CPU_LOSS_RTOL, CARD_CPU_GRAD_RTOL = 1e-5, 1e-4


def moe_train_depth(arch: str) -> tuple[int, str]:
    """(depth, the cut as printed) for ``arch`` in TRAIN_BUDGET_GB."""
    cfg = configs.get(arch)
    one, two = (cfg.replace(n_layers=n).param_count() for n in (1, 2))
    per_layer, base = two - one, 2 * one - two
    depth = int((TRAIN_BUDGET_GB * 1e9 / MOE_BYTES_PER_PARAM - base) // per_layer)
    return depth, (f"depth {depth} of {cfg.n_layers}: {base / 1e9:.3f} B params of embeddings "
                   f"+ {per_layer / 1e9:.3f} B a layer, at {MOE_BYTES_PER_PARAM} bytes a param "
                   f"(bf16 params and grads, float32 accumulator and error state), in "
                   f"{TRAIN_BUDGET_GB} GB")


def train_tree(params, state, data_step: int) -> dict:
    return {"params": params, "train_state": state, "data_step": torch.tensor(data_step)}


def train_phase(arch: str, cut: str | None, tcfg, device, keep: dict | None = None) -> dict:
    """``arch`` trained on the port's pipeline (batch 8 x 256, seed 0) for
    TRAIN_STEPS steps: TRAIN_UNTIMED untimed, then timed, a Supervisor
    checkpoint after step TRAIN_SAVE_AT restored (to the host) and held bit
    for bit to the live tensors, TRAIN_PROFILED more steps profiled; then
    the restored state continued by ``train_loop`` to TRAIN_STEPS, its
    losses held to the uninterrupted run's. ``keep`` receives a host copy
    of the params after step TRAIN_STEPS."""
    from torch.profiler import ProfilerActivity, profile

    cfg = configs.get(arch)
    if cut is not None:
        cfg = cfg.replace(n_layers=int(cut.split()[1]))
    model = model_registry.build(cfg)
    spec = pipeline.DataSpec(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    ckpt_dir = TRAIN_DIR / cfg.name
    if ckpt_dir.exists():
        import shutil
        shutil.rmtree(ckpt_dir)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9  # left by earlier phases
    t0 = time.perf_counter()
    params = model.init(seed=0, device=device)
    state = trainer.init_train_state(tcfg, params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = trainer.make_train_step(model, tcfg)
    sup = fault.Supervisor(str(ckpt_dir), save_every=TRAIN_SAVE_AT, keep=1)
    data = pipeline.DataState()
    losses, norms, step_s, restored, ckpt = [], [], [], None, {}
    registry.reset_launch_counts()

    def one_step():
        nonlocal params, state, data
        batch, data = pipeline.next_batch(spec, data)
        batch = trainer.batch_to(batch, device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, mets = step_fn(params, state, batch)
        losses.append(float(mets["loss"]))  # syncs
        norms.append(float(mets["grad_norm"]))
        return time.perf_counter() - t

    for step in range(1, TRAIN_STEPS + 1):
        dt = one_step()
        if step > TRAIN_UNTIMED:
            step_s.append(dt)
        if step == TRAIN_STEPS and keep is not None:
            keep["params"] = tr.map(lambda v: v.detach().cpu(), params)
        if step == TRAIN_SAVE_AT:
            t = time.perf_counter()
            thread = sup.maybe_save(step, train_tree(params, state, data.step))
            ckpt["save_host_copy_s"] = time.perf_counter() - t
            thread.join()
            ckpt["save_s"] = time.perf_counter() - t
            t = time.perf_counter()
            restored, man = checkpoint.restore(str(ckpt_dir), train_tree(params, state, 0),
                                               device="cpu")
            ckpt["restore_s"] = time.perf_counter() - t
            live = dict(tr.items(train_tree(params, state, data.step)))
            got = dict(tr.items(restored))
            assert man["step"] == step and set(live) == set(got)
            bad = [k for k, v in live.items() if not same_bits(v.detach().cpu(), got[k])]
            if bad:
                raise AssertionError(f"{arch}: restored leaves differ from the saved: {bad[:5]}")
            ckpt.update(leaves=len(live), bytes=sum(_nbytes(v) for v in got.values()),
                        restored_bit_exact=True)
            del live, got  # the live dict holds the state's tensors
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(TRAIN_PROFILED):
            one_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    prof_line = dict(steps=TRAIN_PROFILED, wall_s_per_step_profiled=wall / TRAIN_PROFILED,
                     **device_summary(prof, ("port_none",), TRAIN_PROFILED, "step"))
    del prof
    launches = registry.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in tr.leaves(params))
    state_gb = sum(_nbytes(v) for v in tr.leaves(state)) / 1e9
    del params, state
    gc.collect()
    torch.cuda.empty_cache()

    # the restart: the restored host copy on the card, continued by train_loop
    t = time.perf_counter()
    params = tr.map(lambda v: v.to(device), restored["params"])
    state = tr.map(lambda v: v.to(device), restored["train_state"])
    del restored
    _, _, _, hist = trainer.train_loop(model, tcfg, spec, steps=TRAIN_STEPS, params=params,
                                       train_state=state,
                                       data_state=pipeline.DataState(step=TRAIN_SAVE_AT))
    ckpt["continued_s"] = time.perf_counter() - t
    ckpt["continued_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    cont = [h["loss"] for h in hist]
    want = losses[TRAIN_SAVE_AT:TRAIN_STEPS]
    diff = max(abs(a - b) / abs(b) for a, b in zip(cont, want))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"{arch}: a loss or gradient norm is not finite: {losses} {norms}")
    if not losses[TRAIN_STEPS - 1] < losses[0]:
        raise AssertionError(f"{arch}: the loss did not fall: {losses}")
    if len(cont) != len(want) or not diff <= CONTINUED_LOSS_RTOL:
        raise AssertionError(f"{arch}: the continued run's losses {cont} differ from {want}")
    if any(launches.values()):
        raise AssertionError(f"{arch}: training launched the port's kernels: {launches}")
    med = statistics.median(step_s)
    return dict(
        phase="train", arch=cfg.name, cut=cut, n_layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab, params=n_params, dtype=str(cfg.dtype), remat=cfg.remat,
        optimizer=tcfg.opt.name, lr=tcfg.opt.lr, micro_batches=tcfg.micro_batches,
        compress_grads=tcfg.compress_grads, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        init_s=init_s, held_by_earlier_phases_gb=held_gb, steps=TRAIN_STEPS, timed_steps=len(step_s), s_per_step=med,
        s_per_step_all=step_s, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / med, peak_gb=peak_gb,
        train_state_gb=state_gb, losses=losses, grad_norms=norms, profile=prof_line,
        checkpoint=dict(at_step=TRAIN_SAVE_AT, **ckpt), continued_losses=cont,
        continued_max_rel_diff=diff, continued_rtol=CONTINUED_LOSS_RTOL,
        continued_bit_identical=cont == want, kernel_launches=launches)


def card_vs_cpu_phase(device) -> dict:
    """One loss-and-gradient step of reduced qwen2-0.5b and reduced
    qwen2-moe in float32 on the card and on the CPU, from the same params
    and batch."""
    out = {}
    for arch in ("qwen2-0.5b", "qwen2-moe-a2.7b"):
        cfg = configs.reduced(arch).replace(dtype=torch.float32)
        model = model_registry.build(cfg)
        params = model.init(seed=1, device="cpu")
        spec = pipeline.DataSpec(vocab=cfg.vocab, seq_len=64, global_batch=4)
        batch, _ = pipeline.next_batch(spec, pipeline.DataState())
        cpu = trainer._grads(model, params, trainer.batch_to(batch, "cpu"))
        card = trainer._grads(model, tr.map(lambda v: v.to(device), params),
                              trainer.batch_to(batch, device))
        loss_diff = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
        worst = 0.0
        for (k, g), (_, w) in zip(tr.items(card[2]), tr.items(cpu[2])):
            scale = float(w.abs().max())
            err = float((g.cpu() - w).abs().max())
            if err > CARD_CPU_GRAD_RTOL * scale + 1e-12:
                raise AssertionError(f"{arch} {k}: card and CPU gradients differ by {err} "
                                     f"(largest {scale})")
            worst = max(worst, err / scale if scale else 0.0)
        if not loss_diff <= CARD_CPU_LOSS_RTOL:
            raise AssertionError(f"{arch}: card loss {float(card[0])} against CPU {float(cpu[0])}")
        out[cfg.name] = dict(loss_card=float(card[0]), loss_cpu=float(cpu[0]),
                             loss_rel_diff=loss_diff, grad_max_rel_diff=worst,
                             leaves=len(tr.leaves(cpu[2])))
    return dict(phase="train_card_vs_cpu", dtype="float32", loss_rtol=CARD_CPU_LOSS_RTOL,
                grad_rtol=CARD_CPU_GRAD_RTOL, **out)


def train_phases(device) -> tuple[list, dict]:
    """qwen2-0.5b at full size with AdamW; qwen2-moe-a2.7b at full width
    with Adafactor, 2 micro-batches and compression, cut in depth to
    TRAIN_BUDGET_GB; both models one reduced float32 step card against
    CPU. -> (the lines, qwen2-0.5b's params (on the host) and losses after
    TRAIN_STEPS for the train_dp phase)."""
    opt = dict(lr=TRAIN_LR, warmup_steps=min(100, TRAIN_STEPS // 10), total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    kept = {}
    lines = [train_phase("qwen2-0.5b", None,
                         trainer.TrainConfig(opt=optimizer.OptConfig(**opt)), device, keep=kept)]
    kept["losses"] = lines[-1]["losses"][:TRAIN_STEPS]
    emit(lines[-1])
    depth, cut = moe_train_depth("qwen2-moe-a2.7b")
    moe = trainer.TrainConfig(micro_batches=2, compress_grads=True,
                              opt=optimizer.OptConfig(name="adafactor", **opt))
    lines.append(train_phase("qwen2-moe-a2.7b", f"depth {depth}", moe, device))
    lines[-1]["cut"] = cut
    emit(lines[-1])
    lines.append(card_vs_cpu_phase(device))
    lines[-1]["train_phases_s"] = time.perf_counter() - t0
    emit(lines[-1])
    return lines, kept


# --------------------------------------------------------------------------
# 20. train_dp: data-parallel training over torch.distributed
# --------------------------------------------------------------------------
TRAIN_DP_RANKS, TRAIN_DP_STEPS = 2, 4
TRAIN_DP_DIR = ROOT / "build" / "train_dp"
# the two ranks' MoE: the largest depth at which both ranks' state (at
# MOE_BYTES_PER_PARAM) and TRAIN_DP_RESERVE_GB of activations each fit
# TRAIN_DP_BUDGET_GB together (the train phase's MoE peaks ~2.9 GB above its state)
TRAIN_DP_BUDGET_GB, TRAIN_DP_RESERVE_GB = 60, 3
# the bf16 train tolerance (tests/test_torch_train.py's BF16_LOSS_RTOL and
# BF16_GRAD_RTOL): each step's loss, each step's gradient norm, and each leaf
# of the first step's gradient by its L2 norm. (Not each entry against the
# leaf's largest, as the CPU tests hold a batch of 48 tokens: the card's
# bf16 embedding gradient sums a frequent token's 2,048-position rows with a
# bf16 rounding each, differently for one rank's half of the batch and for
# the whole; its largest entry moved by 8.5% of the leaf's largest.)
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 1e-3, 5e-2
# the float32 witness: both models reduced, one step at TRAIN_BATCH x
# F32_SEQ, the ranks' reduced gradients against one process's at the CPU
# tests' float32 tolerance (tests/test_torch_dist.py), entry by entry
F32_SEQ, F32_LOSS_RTOL, F32_GRAD_RTOL = 64, 1e-5, 1e-4
TRAIN_DP_SITES = ("grads", "moe_counts", "moe_top1", "ce_count", "loss")


def dp_moe_depth(arch: str) -> tuple[int, str]:
    """(depth, the cut as printed) of ``arch`` for the two ranks."""
    cfg = configs.get(arch)
    one, two = (cfg.replace(n_layers=n).param_count() for n in (1, 2))
    per_layer, base = two - one, 2 * one - two
    per_rank = TRAIN_DP_BUDGET_GB / TRAIN_DP_RANKS - TRAIN_DP_RESERVE_GB
    depth = int((per_rank * 1e9 / MOE_BYTES_PER_PARAM - base) // per_layer)
    n = base + depth * per_layer
    total_gb = TRAIN_DP_RANKS * (n * MOE_BYTES_PER_PARAM / 1e9 + TRAIN_DP_RESERVE_GB)
    return depth, (f"depth {depth} of {cfg.n_layers}: {TRAIN_DP_RANKS} ranks x ({n / 1e9:.3f} B "
                   f"params x {MOE_BYTES_PER_PARAM} bytes + {TRAIN_DP_RESERVE_GB} GB of "
                   f"activations) = {total_gb:.1f} GB of {TRAIN_DP_BUDGET_GB} on the one card")


def dp_models() -> list:
    """(arch, depth cut or None, TrainConfig) of the two ranks' runs: the
    train phase's settings."""
    opt = dict(lr=TRAIN_LR, warmup_steps=min(100, TRAIN_STEPS // 10), total_steps=TRAIN_STEPS)
    depth, cut = dp_moe_depth("qwen2-moe-a2.7b")
    return [("qwen2-0.5b", None, trainer.TrainConfig(opt=optimizer.OptConfig(**opt))),
            ("qwen2-moe-a2.7b", (depth, cut), trainer.TrainConfig(
                micro_batches=2, compress_grads=True,
                opt=optimizer.OptConfig(name="adafactor", **opt)))]


def device_checksum(tree) -> str:
    """A digest of every leaf's bits computed on the card: each leaf's words
    times odd position-dependent multipliers, summed mod 2^64, then the
    leaves' sums hashed together (any one differing word changes it)."""
    import hashlib

    h = hashlib.sha256()
    for k, v in tr.items(tree):
        flat = v.detach().reshape(-1)
        words = flat.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[flat.element_size()])
        total = 0
        for a in range(0, words.numel(), 1 << 24):
            w = words[a:a + (1 << 24)].to(torch.int64)
            mult = torch.arange(a, a + w.numel(), device=w.device) * 2654435761 % (1 << 32) | 1
            total += int((w * mult).sum())  # int64 sums wrap alike on every rank
        h.update(f"{k}:{total % (1 << 64)};".encode())
    return h.hexdigest()


def moe_drops(model, tcfg, params, batch, dist) -> int:
    """This rank's dropped (token, choice) pairs in a forward of the step's
    micro-batches (``moe.dispatch_slots``' kept mask)."""
    dropped, inner = [], moe.dispatch_slots

    def counting(*a, **kw):
        out = inner(*a, **kw)
        dropped.append((~out[2]).sum())
        return out

    moe.dispatch_slots = counting
    try:
        micro = trainer._split_micro(trainer.rank_batch(batch, tcfg.micro_batches, dist),
                                     tcfg.micro_batches)
        with torch.no_grad():
            for i in range(tcfg.micro_batches):
                model.loss_fn(params, {k: v[i] for k, v in micro.items()}, dist)
    finally:
        moe.dispatch_slots = inner
    return int(sum(dropped))


def dp_run(arch: str, cut, tcfg, device, dist, steps: int, first_grads: bool = False,
           keep_params: bool = False) -> tuple:
    """``steps`` steps of ``arch`` from seed 0 on the pipeline's global
    batches (8 x 256, seed 0), under ``dist`` (``NO_DIST``: one process):
    (its line, the first step's gradients on the host if asked, the final
    params on the host if asked)."""
    cfg = configs.get(arch)
    if cut is not None:
        cfg = cfg.replace(n_layers=cut[0])
    model = model_registry.build(cfg)
    spec = pipeline.DataSpec(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, device=device)
    state = trainer.init_train_state(tcfg, params)
    step_fn = trainer.make_train_step(model, tcfg, dist)
    data = pipeline.DataState()
    losses, norms, step_s, grads, drops = [], [], [], None, None
    registry.reset_launch_counts()
    for k in range(1, steps + 1):
        batch, data = pipeline.next_batch(spec, data)
        batch = trainer.batch_to(batch, device)
        if k == 1 and cfg.is_moe:
            drops = moe_drops(model, tcfg, params, batch, dist)
        if k == 1 and first_grads:
            _, _, g = trainer.step_grads(model, tcfg, params, batch, dist)
            grads = tr.map(lambda v: v.detach().cpu(), g)
            del g
        sharding.reset_collective_bytes()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, mets = step_fn(params, state, batch)
        losses.append(float(mets["loss"]))  # syncs
        norms.append(float(mets["grad_norm"]))
        step_s.append(time.perf_counter() - t)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(step_s[1:])
    line = dict(arch=cfg.name, cut=None if cut is None else cut[1], n_layers=cfg.n_layers,
                params=sum(p.numel() for p in tr.leaves(params)), optimizer=tcfg.opt.name,
                micro_batches=tcfg.micro_batches, compress_grads=tcfg.compress_grads,
                steps=steps, losses=losses, grad_norms=norms, s_per_step=med,
                s_per_step_all=step_s, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / med,
                peak_gb=peak_gb, drops_step1=drops,
                collective_bytes_per_step=sharding.collective_bytes_total(),
                collective_calls_per_step=sharding.collective_calls(),
                kernel_launches=registry.launch_counts(),
                checksum=device_checksum({"params": params, "state": state}))
    host = tr.map(lambda v: v.detach().cpu(), params) if keep_params else None
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return line, grads, host


def f32_witness(device, dist):
    """One step's loss and reduced gradients (on the host) of both models
    reduced in float32, with their ``dp_models`` settings, under ``dist``:
    -> [(arch, TrainConfig, loss, gradients)]. Held at 1e-4 of each leaf's
    scale between the ranks and one process, this parts a fault in the
    data-parallel logic from bf16's summation order."""
    out = []
    for arch, _, tcfg in dp_models():
        cfg = configs.reduced(arch).replace(dtype=torch.float32)
        model = model_registry.build(cfg)
        params = model.init(seed=1, device=device)
        spec = pipeline.DataSpec(vocab=cfg.vocab, seq_len=F32_SEQ, global_batch=TRAIN_BATCH)
        batch, _ = pipeline.next_batch(spec, pipeline.DataState())
        loss, _, g = trainer.step_grads(model, tcfg, params, trainer.batch_to(batch, device),
                                        dist)
        out.append((arch, tcfg, float(loss), tr.map(lambda v: v.detach().cpu(), g)))
    return out


def train_dp_rank_worker(out_dir: str) -> None:
    """One rank of the ``train_dp`` job (``--train-dp-rank``): both models
    data-parallel on the job's gloo mesh (data 2 x model 1); rank 0 also
    saves the first step's gradients of qwen2-0.5b."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import multihost

    info = multihost.initialize()
    dist = mesh_mod.make_dist(mesh_mod.train_mesh(TRAIN_DP_RANKS, 1))
    out = {}
    for arch, cut, tcfg in dp_models():
        dense = arch == "qwen2-0.5b"  # every rank takes the gradient (collectives)
        out[arch], grads, _ = dp_run(arch, cut, tcfg, dist.mesh.device, dist, TRAIN_DP_STEPS,
                                     first_grads=dense)
        if dense and info.process_id == 0:
            torch.save(grads, pathlib.Path(out_dir) / "grads_qwen2-0.5b.pt")
        del grads
    for arch, tcfg, loss, grads in f32_witness(dist.mesh.device, dist):
        if info.process_id == 0:
            torch.save({"loss": loss, "grads": grads},
                       pathlib.Path(out_dir) / f"f32_{arch}.pt")
    torch.distributed.destroy_process_group()
    (pathlib.Path(out_dir) / f"rank{info.process_id}.json").write_text(json.dumps(out))
    print(f"train_dp rank {info.process_id} of {info.num_processes} done", flush=True)


def train_dp_phase(device, kept: dict) -> dict:
    """(a) qwen2-0.5b at full size, AdamW, on a forced one-rank NCCL mesh
    for TRAIN_STEPS steps: every param and every loss equal to the train
    phase's no-mesh run's bit for bit (``kept``, from ``train_phases``).
    (b) ``multihost.launch`` starts TRAIN_DP_RANKS ranks on this one card
    over gloo; each trains qwen2-0.5b (AdamW) and then qwen2-moe-a2.7b at
    full width (Adafactor, 2 micro-batches, compression; cut in depth by
    ``dp_moe_depth``) for TRAIN_DP_STEPS steps: the ranks
    bit-identical (device checksums of params and state), each within the
    bf16 train tolerance of this process's one-process run of the same
    global batches; and both models reduced in float32, one step on the
    ranks, their reduced gradients within F32_GRAD_RTOL of each leaf's
    scale of one process's (``f32_witness``)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import multihost
    from repro_torch.models.dist import NO_DIST

    t0 = time.perf_counter()
    models = dp_models()
    dense = models[0]
    d1 = mesh_mod.make_dist(mesh_mod.train_mesh(1, 1, device=device))
    one, _, params = dp_run(*dense, d1.mesh.device, d1, TRAIN_STEPS, keep_params=True)
    torch.distributed.destroy_process_group()
    want = kept.pop("params")
    bad = [k for (k, a), (_, b) in zip(tr.items(params), tr.items(want)) if not same_bits(a, b)]
    if bad or len(tr.leaves(params)) != len(tr.leaves(want)):
        raise AssertionError(f"train_dp: one-rank mesh params differ from the no-mesh run's: "
                             f"{bad[:5]}")
    if one["losses"] != kept["losses"]:
        raise AssertionError(f"train_dp: one-rank mesh losses {one['losses']} against "
                             f"{kept['losses']}")
    one.update(mesh="data 1 x model 1, NCCL", params_bit_identical=True)
    del params, want

    solo, solo_grads = {}, None
    for arch, cut, tcfg in models:
        solo[arch], g, _ = dp_run(arch, cut, tcfg, device, NO_DIST, TRAIN_DP_STEPS,
                                  first_grads=arch == "qwen2-0.5b")
        if g is not None:
            solo_grads = g
    TRAIN_DP_DIR.mkdir(parents=True, exist_ok=True)
    for old in TRAIN_DP_DIR.iterdir():
        old.unlink()
    t = time.perf_counter()
    results = multihost.launch_check(str(ROOT / "chip_smoke.py"), marker="done",
                                     num_processes=TRAIN_DP_RANKS,
                                     args=("--train-dp-rank", TRAIN_DP_DIR), backend="gloo",
                                     device="cuda", cwd=str(ROOT), timeout=900)
    job_s = time.perf_counter() - t
    ranks = [json.loads((TRAIN_DP_DIR / f"rank{r}.json").read_text())
             for r in range(TRAIN_DP_RANKS)]
    runs = {}
    for arch, _, _ in models:
        lines = [r[arch] for r in ranks]
        if len({ln["checksum"] for ln in lines}) != 1:
            raise AssertionError(f"train_dp: {arch}'s ranks differ: "
                                 f"{[ln['checksum'] for ln in lines]}")
        ref = solo[arch]
        for what, rtol in (("losses", BF16_LOSS_RTOL), ("grad_norms", BF16_GRAD_RTOL)):
            diff = max(abs(a - b) / abs(b) for a, b in zip(lines[0][what], ref[what]))
            if not diff <= rtol:
                raise AssertionError(f"train_dp: {arch} {what} {lines[0][what]} against the "
                                     f"one-process run's {ref[what]}")
            lines[0][f"{what}_max_rel_diff"] = diff
        if any(ln["kernel_launches"].get(k) for ln in lines for k in ln["kernel_launches"]):
            raise AssertionError(f"train_dp: {arch} launched the port's kernels")
        need = [s for s in TRAIN_DP_SITES if "moe" in arch or not s.startswith("moe")]
        missing = [s for s in need if s not in lines[0]["collective_calls_per_step"]]
        if missing:
            raise AssertionError(f"train_dp: {arch} issued no {missing} collective")
        if "moe" in arch and not (lines[0]["drops_step1"] or lines[1]["drops_step1"]):
            raise AssertionError(f"train_dp: {arch} dropped no tokens")
        runs[arch] = dict(ranks=lines, one_process=ref,
                          drops_step1_sum=(sum(ln["drops_step1"] for ln in lines)
                                           if "moe" in arch else None))
    got = torch.load(TRAIN_DP_DIR / "grads_qwen2-0.5b.pt")
    worst_l2, worst_entry = 0.0, 0.0
    for (k, g), (_, w) in zip(tr.items(got), tr.items(solo_grads)):
        g, w = g.float(), w.float()
        norm, err = float(w.norm()), float((g - w).norm())
        if not err <= BF16_GRAD_RTOL * norm:
            raise AssertionError(f"train_dp: qwen2-0.5b step-1 gradient {k} differs by {err} "
                                 f"in L2 (its norm {norm})")
        worst_l2 = max(worst_l2, err / norm if norm else 0.0)
        scale = float(w.abs().max())
        worst_entry = max(worst_entry, float((g - w).abs().max()) / scale if scale else 0.0)
    runs["qwen2-0.5b"].update(step1_grad_max_rel_l2=worst_l2,
                              step1_grad_max_entry_over_scale=worst_entry)
    f32 = {}
    for arch, tcfg, loss, want in f32_witness(device, NO_DIST):
        got = torch.load(TRAIN_DP_DIR / f"f32_{arch}.pt")
        loss_diff = abs(got["loss"] - loss) / abs(loss)
        if not loss_diff <= F32_LOSS_RTOL:
            raise AssertionError(f"train_dp: float32 {arch} loss {got['loss']} on the ranks "
                                 f"against {loss} in one process")
        worst = 0.0
        for (k, g), (_, w) in zip(tr.items(got["grads"]), tr.items(want)):
            scale, err = float(w.abs().max()), float((g - w).abs().max())
            if not err <= F32_GRAD_RTOL * scale + 1e-12:
                raise AssertionError(f"train_dp: float32 {arch} gradient {k} differs by {err} "
                                     f"(largest {scale})")
            worst = max(worst, err / scale if scale else 0.0)
        f32[arch] = dict(micro_batches=tcfg.micro_batches, loss_rel_diff=loss_diff,
                         grad_max_rel_diff=worst, leaves=len(tr.leaves(want)))
    return dict(phase="train_dp", one_rank_mesh=one, ranks=TRAIN_DP_RANKS, backend="gloo",
                job_s=job_s, outputs=[r.stdout.strip().splitlines()[-1] for r in results],
                loss_rtol=BF16_LOSS_RTOL, grad_rtol=BF16_GRAD_RTOL, runs=runs,
                f32_witness=dict(reduced=True, batch=[TRAIN_BATCH, F32_SEQ],
                                 loss_rtol=F32_LOSS_RTOL, grad_rtol=F32_GRAD_RTOL, **f32),
                ranks_bit_identical=True, seconds=time.perf_counter() - t0)


# --------------------------------------------------------------------------
# 22. dryrun: the dry run and the roofline on the H100's constants
# --------------------------------------------------------------------------
DRYRUN_DIR = ROOT / "build" / "dryrun_torch"
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"))
DRYRUN_TIMEOUT_S = 300
# (b): qwen2-0.5b's train step at a size that fits one card, counted on a
# one-rank mesh and run for real; 1 untimed step, then COUNT_TIMED
COUNT_BATCH, COUNT_SEQ, COUNT_TIMED = 2, 4096, 3
COMPUTE_SLACK = 1.05  # the compute term may exceed the measured step by no more
# (c): prefill_32k's length, one sequence, baseline (scanned) against opt
# (unrolled, causal skip). The opt run rounds each score and each softmax
# weight to bf16 (2^-9 relative) where the baseline keeps float32: the last
# position's logits within UNROLL_LOGIT_RTOL of their largest; its train
# step's loss within UNROLL_LOSS_RTOL (the CPU tests' BF16_LOSS_RTOL) of the
# baseline step's from the same params and batch; reduced float32, card
# against CPU, the CPU tests' float32 tolerances (CARD_CPU_*_RTOL)
PREFILL_SEQ, UNROLL_LOGIT_RTOL, UNROLL_LOSS_RTOL = 32_768, 5e-2, 1e-3
UNROLL_CPU_SEQ = 1_100  # three query chunks, the last one padded


def dryrun_count_worker(out_path: str) -> None:
    """(b)'s count in a process of its own (the fake process group is per
    process): qwen2-0.5b's train step at COUNT_BATCH x COUNT_SEQ, the
    recipe the dry run gives it, traced on a one-rank mesh."""
    from repro_torch.configs.base import SHAPE_SPECS
    from repro_torch.launch import dryrun, mesh as mesh_lib

    dryrun.init_fake_world(1)
    SHAPE_SPECS["smoke_train"] = dict(seq_len=COUNT_SEQ, global_batch=COUNT_BATCH, kind="train")
    rec = dryrun.lower_stats("qwen2-0.5b", "smoke_train", mesh_lib.spmd_mesh(1, 1), unroll=False)
    with open(out_path, "w") as f:
        json.dump(rec, f)


def _finish(proc, log: pathlib.Path, what: str) -> None:
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}: {log.read_text()[-3000:]}")


def _timed_steps(step, params, state, batch, n: int) -> tuple:
    """n + 1 steps on one batch, the first untimed: (params, state, the
    losses, the timed seconds), each step synced as the train phase's."""
    losses, secs = [], []
    for i in range(n + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, mets = step(params, state, batch)
        losses.append(float(mets["loss"]))  # syncs
        if i:
            secs.append(time.perf_counter() - t)
    return params, state, losses, secs


def unroll_card_vs_cpu(device) -> dict:
    """Reduced qwen2-0.5b in float32 with the opt flags: prefill logits and
    one loss-and-gradient step on the card against the CPU."""
    cfg = configs.reduced("qwen2-0.5b").replace(dtype=torch.float32, unroll=True,
                                                causal_skip=True)
    model = model_registry.build(cfg)
    params = model.init(seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, UNROLL_CPU_SEQ)).astype(np.int32))
    card_params = tr.map(lambda v: v.to(device), params)
    with torch.no_grad():
        cpu_log = model.prefill(params, {"tokens": toks})[0]
        card_log = model.prefill(card_params, {"tokens": toks.to(device)})[0].cpu()
    logit_diff = float((card_log - cpu_log).abs().max() / cpu_log.abs().max())
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    cpu = trainer._grads(model, params, batch)
    card = trainer._grads(model, card_params, {k: v.to(device) for k, v in batch.items()})
    loss_diff = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    grad_diff = max(float((g.cpu() - w).abs().max() / w.abs().max())
                    for (_, g), (_, w) in zip(tr.items(card[2]), tr.items(cpu[2])))
    if not (logit_diff <= CARD_CPU_LOSS_RTOL and loss_diff <= CARD_CPU_LOSS_RTOL
            and grad_diff <= CARD_CPU_GRAD_RTOL):
        raise AssertionError(f"reduced opt run, card against CPU: logits {logit_diff}, "
                             f"loss {loss_diff}, gradients {grad_diff}")
    return dict(seq=UNROLL_CPU_SEQ, logits_rel_diff=logit_diff, loss_rel_diff=loss_diff,
                grad_max_rel_diff=grad_diff, rtol=CARD_CPU_LOSS_RTOL,
                grad_rtol=CARD_CPU_GRAD_RTOL)


def dryrun_phase(device) -> dict:
    """(a) the dry run of two full-size cells on the 256-rank single-pod
    mesh (subprocesses, meanwhile the card works), checked and put on the
    H100's roofline; (b) qwen2-0.5b's step at COUNT_BATCH x COUNT_SEQ
    counted on a one-rank mesh (a subprocess) and run on the card; (c) the
    unrolled, causal-skip attention at PREFILL_SEQ against the scanned one."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis as roofline

    t0 = time.perf_counter()
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        log = DRYRUN_DIR / f"{arch}__{shape}.log"
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--mesh", "single", "--out", str(DRYRUN_DIR)], cwd=ROOT, env=env,
            stdout=log.open("w"), stderr=subprocess.STDOUT), log, f"dry run {arch} {shape}"))
    count_path, log = DRYRUN_DIR / "count.json", DRYRUN_DIR / "count.log"
    procs.append((subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-count", str(count_path)],
        cwd=ROOT, env=env, stdout=log.open("w"), stderr=subprocess.STDOUT), log, "count"))

    # (b) the counted step, run on the card
    cfg = configs.get("qwen2-0.5b")
    model = model_registry.build(cfg)
    tcfg = dryrun.train_cfg_for("qwen2-0.5b")
    spec = pipeline.DataSpec(vocab=cfg.vocab, seq_len=COUNT_SEQ, global_batch=COUNT_BATCH)
    batch = trainer.batch_to(pipeline.next_batch(spec, pipeline.DataState())[0], device)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, device=device)
    state = trainer.init_train_state(tcfg, params)
    arg_bytes = _nbytes(*tr.leaves(params), *tr.leaves(state), *batch.values())
    params, state, losses, secs = _timed_steps(trainer.make_train_step(model, tcfg), params,
                                               state, batch, COUNT_TIMED)
    peak = torch.cuda.max_memory_allocated() - held
    del params, state
    gc.collect()
    torch.cuda.empty_cache()

    # (c) prefill at PREFILL_SEQ, baseline and opt, from the same params
    params = model.init(seed=0, device=device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, PREFILL_SEQ)).astype(np.int32)).to(device)
    prefill = {}
    variants = (("baseline", cfg), ("opt", cfg.replace(unroll=True, causal_skip=True)))
    for name, vcfg in variants:
        vm = model_registry.build(vcfg)
        with torch.no_grad():
            vm.prefill(params, {"tokens": toks[:, :1024]})  # warm up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            logits = vm.prefill(params, {"tokens": toks})[0]
            torch.cuda.synchronize()
            prefill[name] = dict(s=time.perf_counter() - t, logits=logits.float().cpu(),
                                 peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        gc.collect()
        torch.cuda.empty_cache()
    del params
    base_log, opt_log = prefill["baseline"].pop("logits"), prefill["opt"].pop("logits")
    if not (torch.isfinite(opt_log).all() and torch.isfinite(base_log).all()):
        raise AssertionError("a 32k prefill gave non-finite logits")
    logit_diff = float((opt_log - base_log).abs().max() / base_log.abs().max())
    if not logit_diff <= UNROLL_LOGIT_RTOL:
        raise AssertionError(f"opt prefill at {PREFILL_SEQ}: logits {logit_diff} of the largest "
                             f"from the baseline's (tolerance {UNROLL_LOGIT_RTOL})")
    same_top = bool(opt_log.argmax(-1).eq(base_log.argmax(-1)).all())
    cpu_check = unroll_card_vs_cpu(device)
    # one opt train step at COUNT_BATCH x COUNT_SEQ from the same params and batch
    om = model_registry.build(variants[1][1])
    params = om.init(seed=0, device=device)
    state = trainer.init_train_state(tcfg, params)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, mets = trainer.make_train_step(om, tcfg)(params, state, batch)
    opt_loss = float(mets["loss"])
    opt_step_s = time.perf_counter() - t
    del params, state, mets
    gc.collect()
    torch.cuda.empty_cache()
    loss_diff = abs(opt_loss - losses[0]) / abs(losses[0])
    if not (np.isfinite(opt_loss) and loss_diff <= UNROLL_LOSS_RTOL):
        raise AssertionError(f"opt train step loss {opt_loss} against the baseline's {losses[0]}")

    for proc, log, what in procs:
        _finish(proc, log, what)
    total_mem = torch.cuda.get_device_properties(0).total_memory
    cells = []
    for arch, shape in DRYRUN_CELLS:
        with open(DRYRUN_DIR / f"{arch}__{shape}__single.json") as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {arch} {shape}: {rec.get('error')}")
        row = roofline.analyze_cell(rec)
        if not 0 < row["useful_flops_ratio"] <= 1.05:
            raise AssertionError(f"dry run {arch} {shape}: 6ND over the counted FLOPs is "
                                 f"{row['useful_flops_ratio']}")
        mem = rec["memory_analysis"]
        per_dev = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        cells.append(dict(
            arch=arch, shape=shape, n_devices=rec["n_devices"], memory=mem,
            flops_per_device=rec["cost_analysis"]["flops"],
            bytes_per_device=rec["cost_analysis"]["bytes accessed"],
            collectives=rec["collectives"], build_s=rec["lower_s"], trace_s=rec["compile_s"],
            roofline={k: row[k] for k in (
                "t_compute_s", "t_memory_s", "t_collective_s", "dominant", "step_lower_bound_s",
                "useful_flops_ratio", "roofline_fraction", "collective_bytes_per_device")},
            per_device_bytes=per_dev, card_bytes=total_mem,
            fits="fits" if per_dev <= total_mem else "does not fit"))

    # (b) the count against the card
    with open(count_path) as f:
        count = json.load(f)
    pred_args = count["memory_analysis"]["argument_size_in_bytes"]
    if pred_args != arg_bytes:
        raise AssertionError(f"counted argument bytes {pred_args} against the card's {arg_bytes}")
    flops, nbytes = count["cost_analysis"]["flops"], count["cost_analysis"]["bytes accessed"]
    t_compute, t_memory = flops / roofline.PEAK_FLOPS, nbytes / roofline.HBM_BW
    measured = statistics.median(secs)
    if t_compute > COMPUTE_SLACK * measured:
        raise AssertionError(f"compute term {t_compute} s exceeds the measured step {measured} s")
    pred_peak = pred_args + count["memory_analysis"]["temp_size_in_bytes"]
    return dict(
        phase="dryrun", cells=cells,
        count=dict(arch="qwen2-0.5b", batch=COUNT_BATCH, seq_len=COUNT_SEQ, mesh="1 rank",
                   trace_s=count["compile_s"], argument_bytes=pred_args,
                   card_argument_bytes=arg_bytes, flops=flops, bytes_accessed=nbytes,
                   predicted_peak_bytes=pred_peak, card_peak_bytes=peak,
                   peak_ratio=pred_peak / peak, t_compute_s=t_compute, t_memory_s=t_memory,
                   bound_s=max(t_compute, t_memory), measured_s=measured, step_s_all=secs,
                   losses=losses, compute_fraction=t_compute / measured,
                   bound_fraction=max(t_compute, t_memory) / measured),
        unroll=dict(seq_len=PREFILL_SEQ, prefill=prefill,
                    speedup=prefill["baseline"]["s"] / prefill["opt"]["s"],
                    logits_rel_diff=logit_diff, logit_rtol=UNROLL_LOGIT_RTOL,
                    same_top_token=same_top, card_vs_cpu=cpu_check,
                    opt_step=dict(loss=opt_loss, baseline_loss=losses[0], rel_diff=loss_diff,
                                  rtol=UNROLL_LOSS_RTOL, s_with_warmup=opt_step_s)),
        seconds=time.perf_counter() - t0)


def main() -> None:
    t_start = time.perf_counter()
    device, _ = device_phase()
    build_phase()
    t0 = time.perf_counter()
    spec, state = engine.build([engine.GuestSpec(N_LOGICAL, workload="redis", seed=0)],
                               engine.HostSpec(**HOST), device=device)
    trace = engine.guest_traces(spec, N_WINDOWS, APW)  # [1, 16, 2,097,152]
    emit(dict(phase="setup", seconds=time.perf_counter() - t0,
              n_logical=spec.cfg.n_logical, n_gpa_hp=spec.cfg.n_gpa_hp,
              n_near=spec.cfg.n_near, trace_shape=list(trace.shape)))
    gen = torch.Generator(device=device).manual_seed(0)
    trace0 = torch.from_numpy(trace[:, 0]).to(device)
    kernel_rows = kernels_phase(kernel_cases(spec, state, trace0, gen), device, "engine")
    del state, trace0
    torch.cuda.empty_cache()

    # autonuma and tpp first: they also warm the allocator and the library
    # kernels up, so that the main path's two runs are both timed warm
    runs = []
    for policy, n_w in (("autonuma", 4), ("tpp", 4), ("memtierd", N_WINDOWS)):
        runs.append(engine_phase(spec, trace, policy, n_w, device))
        emit(runs[-1])
        torch.cuda.empty_cache()
    main_launches = runs[-1]["launches"]  # the engine's main path: memtierd, 16 windows
    emit(profile_phase(spec, trace, device))
    del runs
    torch.cuda.empty_cache()

    churn_spec = churn_fleet(device)
    emit(synth_phase(churn_spec, device))
    engine_synth_line, engine_synth_launches = engine_synth_phase(spec, device)
    emit(engine_synth_line)
    gc.collect()
    torch.cuda.empty_cache()

    churn_trace = engine.guest_traces(churn_spec, CHURN_WINDOWS, CHURN_APW)
    churn_line, churn_launches = churn_phase(churn_spec, churn_trace, device)
    emit(churn_line)
    torch.cuda.empty_cache()
    reference_line, reference_launches = reference_phase(churn_spec, churn_trace, device)
    emit(reference_line)
    gc.collect()
    torch.cuda.empty_cache()
    churn_synth_line, churn_synth_launches = churn_synth_phase(churn_spec, device)
    emit(churn_synth_line)
    gc.collect()
    torch.cuda.empty_cache()
    service_line, service_launches = service_phase(churn_spec, device)
    emit(service_line)
    gc.collect()
    torch.cuda.empty_cache()
    pebs_line, pebs_launches = pebs_phase(spec, trace, churn_spec, churn_trace, device)
    emit(pebs_line)
    del churn_spec
    ntier_line, ntier_launches = ntier_phase(trace, device)
    emit(ntier_line)
    del trace
    ntier_churn_line, ntier_churn_launches, ntier_service_launches = ntier_churn_phase(
        churn_trace, device)
    emit(ntier_churn_line)
    gc.collect()
    torch.cuda.empty_cache()
    sharded_line, sharded_launches, sharded_churn_launches = sharded_phase(churn_trace, device)
    emit(sharded_line)
    del churn_trace
    gc.collect()
    torch.cuda.empty_cache()
    emit(sharded_ranks_phase(device))
    gc.collect()
    torch.cuda.empty_cache()
    emit(contracts_phase(device))
    gc.collect()
    torch.cuda.empty_cache()
    for row in kernel_rows:
        row["launches"] = main_launches[row["name"]]
        row["launches_by_path"] = {path: counts[row["name"]] for path, counts in (
            ("engine", main_launches), ("churn", churn_launches),
            ("reference", reference_launches), ("engine_synth", engine_synth_launches),
            ("churn_synth", churn_synth_launches), ("service", service_launches),
            ("pebs", pebs_launches), ("ntier", ntier_launches),
            ("ntier_churn", ntier_churn_launches), ("ntier_service", ntier_service_launches),
            ("sharded", sharded_launches), ("sharded_churn", sharded_churn_launches))}

    model, params = serve_model(device)
    serve_line, serve_eng, serve_launches = serve_phase(model, params, device)
    emit(serve_line)
    serve_rows = kernels_phase(serve_kernel_cases(serve_eng, gen), device, "serve")
    for row in serve_rows:
        row["launches"] = serve_launches[row["name"]]
        if row["name"] == "paged_attention" and row["timing"] == "profiler":
            assert list(row["events_per_run"].values()) == [1], \
                f"K6 is one launch a call: {row['events_per_run']}"
    del serve_eng
    torch.cuda.empty_cache()
    emit(serve_profile_phase(model, params, device))

    cases = registry_cases(spec, device, gen, model.cfg)
    registry_line, registry_launches = registry_phase(cases, device)
    emit(registry_line)
    registry_rows = kernels_phase(cases, device, "registry")
    for row in registry_rows:
        row["launches"] = registry_launches[row["name"]]
    del cases, spec
    torch.cuda.empty_cache()
    emit(memory_phase(model, params, device, gen))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    _, family_rows = families_phase(device, gen)
    gc.collect()
    torch.cuda.empty_cache()
    _, kept = train_phases(device)
    gc.collect()
    torch.cuda.empty_cache()
    emit(train_dp_phase(device, kept))
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    emit(dryrun_phase(device))
    rows = kernel_rows + serve_rows + registry_rows + family_rows
    # the launch floor: this run's time of K2 on the serve path's 1,632 bytes
    floor = next(r["ms"] for r in serve_rows if r["name"] == "hot_count")
    for row in rows:
        row.update(launch_floor_ms=floor, floor_aware_bound_ms=floor + row["bound_ms"])
    emit(dict(phase="total", seconds=time.perf_counter() - t_start))
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--train-dp-rank"]:
        train_dp_rank_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--dryrun-count"]:
        dryrun_count_worker(sys.argv[2])
    else:
        main()
