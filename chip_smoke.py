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

The phases run in the order 1-5, 11, 12, 6, 7, 13-17, 8-10. An engine
kernel row's ``launches`` counts the engine's main path (the memtierd run);
``launches_by_path`` adds the churn, reference, engine_synth, churn_synth,
service, pebs, ntier (the first policy's kernel run, hybridtier),
ntier_churn and its service runs. Every
kernel row carries ``floor_aware_bound_ms``: the launch floor (this run's
time of hot_count on the serve path's 1,632 bytes, ``launch_floor_ms``) plus
its bound. The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits non-zero; so it does without a CUDA device, and outside a
checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core import address_space as asp  # noqa: E402
from repro_torch.core import engine, faults, filter as pfilter, telemetry, tiers  # noqa: E402
from repro_torch.data import prng, traces  # noqa: E402
from repro_torch.kernels import build, registry  # noqa: E402
from repro_torch.kernels.consolidate import consolidate_region, scatter_region  # noqa: E402
from repro_torch.kernels.flash_attention import gqa_attention  # noqa: E402
from repro_torch.memory.embedding import EmbedSpec, TieredEmbeddingStore  # noqa: E402
from repro_torch.memory.kvcache import KVSpec, TieredKVCache  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.serve.scheduler import Request, SchedulerConfig  # noqa: E402

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

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        self.lead = torch.zeros(1, device=device)
        # the flush kernel's full name (a call may run bitwise_not on other
        # dtypes): the last device event of a trace that ends with flushes
        events = self._trace(lambda: [self._flush() for _ in range(4)])
        if not events:
            raise RuntimeError("torch.profiler traced no device event")
        self.flush_name = events[-1][0]

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
# 8. serving: qwen2-0.5b at full width over the GPAC-tiered paged KV cache
# --------------------------------------------------------------------------
SERVE = dict(max_seqs=8, max_seq_len=2048, page_size=16, pages_per_block=4,
             near_fraction=0.4, maintenance_every=8, reserve_tokens=8)
N_REQUESTS, PROMPT_LEN, MAX_NEW = 16, 1024, 32
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


def serve_engine_for(model, params, device, use_gpac: bool, kernel_backend: str):
    ecfg = serve_engine.EngineConfig(
        max_seqs=SERVE["max_seqs"], max_seq_len=SERVE["max_seq_len"],
        pages_per_block=SERVE["pages_per_block"], near_fraction=SERVE["near_fraction"],
        sched=SchedulerConfig(max_seqs=SERVE["max_seqs"],
                              maintenance_every=SERVE["maintenance_every"],
                              use_gpac=use_gpac, reserve_tokens=SERVE["reserve_tokens"]))
    return serve_engine.Engine(model, params, ecfg, device=device,
                               kernel_backend=kernel_backend)


def serve_requests(vocab: int, n: int | None = None) -> list:
    n = N_REQUESTS if n is None else n
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab, PROMPT_LEN).tolist(),
                    max_new=MAX_NEW) for i in range(n)]


def instrument(eng) -> dict:
    """Time each prefill (between synchronisations) and keep the first
    decode step's logits, by wrapping the engine's two calls."""
    rec = dict(prefill_s=[], first_logits=None)
    prefill, decode = eng._prefill_into_slot, eng.decode_fn

    def timed_prefill(req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(req)
        torch.cuda.synchronize()
        rec["prefill_s"].append(time.perf_counter() - t0)

    def kept_decode(p, c, t):
        logits, c = decode(p, c, t)
        if rec["first_logits"] is None:
            rec["first_logits"] = logits.clone()
        return logits, c

    eng._prefill_into_slot, eng.decode_fn = timed_prefill, kept_decode
    return rec


def serve_run(model, params, device, use_gpac: bool, kernel_backend: str) -> dict:
    """The whole batch through one engine; the launch counts are set to 0
    just before and read just after. A step's decode time is its time less
    its prefills'; it includes the GPAC/tier maintenance on its cadence."""
    eng = serve_engine_for(model, params, device, use_gpac, kernel_backend)
    reqs = serve_requests(model.cfg.vocab)
    for r in reqs:
        eng.sched.submit(r)
    rec = instrument(eng)
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
    if not all(len(t) == MAX_NEW and all(0 <= x < model.cfg.vocab for x in t)
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


def serve_kernel_cases(eng, gen: torch.Generator) -> list:
    """The serving path's kernels at its shapes, on the GPAC-on run's final
    cache and placement state: paged_attention on layer 0's pages at the
    full-width decode shape (bf16, the same data in float32, and bf16 at
    ragged lens), hot_count at 4 pages per block, gather_rows on the 8-byte
    placement rows and topk_rows on one daemon's filter row."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    cfg, pcfg = eng.model.cfg, eng.pcfg
    dev = eng.device
    B, KVH, G, hd = SERVE["max_seqs"], cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    kp = eng.cache["layers"]["layer0"]["k_pages"][0]
    vp = eng.cache["layers"]["layer0"]["v_pages"][0]
    btab, lens = eng.cache["btab"], eng.cache["lens"] + 1
    pps, page = btab.shape[1], cfg.page_size
    # ragged: per-sequence lens across the cache's range (on no path)
    ragged = torch.randint(16, SERVE["max_seq_len"] + 1, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    cases = []
    for dtype, lens in ((torch.bfloat16, lens), (torch.float32, lens), (torch.bfloat16, ragged)):
        q = torch.randn((B, KVH, G, hd), generator=gen, device=dev).to(dtype)
        k, v = kp.to(dtype), vp.to(dtype)
        # the yardstick reads K/V gathered into contiguous rows beforehand
        bidx = torch.arange(B, device=dev)[:, None]
        safe = btab.clamp(0, k.shape[2] - 1).long()
        kg = k[bidx, :, safe].transpose(1, 2).reshape(B, KVH, pps * page, hd).contiguous()
        vg = v[bidx, :, safe].transpose(1, 2).reshape(B, KVH, pps * page, hd).contiguous()
        mask = (torch.arange(pps * page, device=dev) < lens[:, None])[:, None, None, :]
        qs = q.reshape(B, KVH * G, 1, hd)
        n_tok = int(lens.clamp(0, pps * page).sum())
        row = hd * q.element_size()
        nbytes = 2 * n_tok * KVH * row + 2 * _nbytes(q) + _nbytes(btab, lens)
        cases.append((
            "paged_attention", f"decode {str(dtype)[6:]} B={B} KVH={KVH} G={G} hd={hd} "
            f"page={page} pps={pps} len={int(lens.min())}-{int(lens.max())}"
            + (" ragged (on no path)" if lens is ragged else ""),
            (q, k, v, btab, lens),
            lambda qs=qs, kg=kg, vg=vg, mask=mask: sdpa(qs, kg, vg, attn_mask=mask,
                                                        enable_gqa=True),
            nbytes, 4 * G * hd * n_tok * KVH, SERVE_TOL[dtype]))
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


def main() -> None:
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
    del churn_trace
    gc.collect()
    torch.cuda.empty_cache()
    for row in kernel_rows:
        row["launches"] = main_launches[row["name"]]
        row["launches_by_path"] = {path: counts[row["name"]] for path, counts in (
            ("engine", main_launches), ("churn", churn_launches),
            ("reference", reference_launches), ("engine_synth", engine_synth_launches),
            ("churn_synth", churn_synth_launches), ("service", service_launches),
            ("pebs", pebs_launches), ("ntier", ntier_launches),
            ("ntier_churn", ntier_churn_launches), ("ntier_service", ntier_service_launches))}

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
    rows = kernel_rows + serve_rows + registry_rows
    # the launch floor: this run's time of K2 on the serve path's 1,632 bytes
    floor = next(r["ms"] for r in serve_rows if r["name"] == "hot_count")
    for row in rows:
        row.update(launch_floor_ms=floor, floor_aware_bound_ms=floor + row["bound_ms"])
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
