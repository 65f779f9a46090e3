"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell, one step of the port is
traced on fake tensors laid out as DTensors over a ``DeviceMesh`` of the
production geometry (256 or 512 ranks of a fake process group): params,
train state, batch and cache placed by ``launch.sharding``'s specs, the
layout the reference hands ``jax.jit`` as ``in_shardings``. Nothing is
allocated and nothing runs on a device; the trace records, for one rank,

  * ``memory_analysis``: the local bytes of the arguments, the outputs and
    the donated state, and the peak of live local bytes made during the
    step (``temp_size_in_bytes``; it includes the outputs the step makes);
  * ``cost_analysis``: ``flops``, the FLOPs of the local matmul-family ops
    that DTensor dispatches to this rank's shards (the ops
    ``torch.utils.flop_counter`` counts), and ``bytes accessed``, each
    local op's input plus output bytes (views and collectives excluded).
    Eager PyTorch fuses nothing, so this is an upper bound on the fused
    traffic the reference's XLA count gives;
  * ``collectives``: result bytes and counts per kind of the collectives
    the step issues (DTensor's redistributions: the gradient reductions,
    the constraints' reshards), as the reference reads HLO result shapes,

into experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.

The fake tensors lie on the CPU, so the step takes the port's portable
paths: ``layers.matmul_f32`` upcasts its bf16 operands (the card sums in
float32 inside cuBLAS instead), and decode's paged attention is the plain
version, as the reference's dry run lowers its GSPMD path. A ``cpu``
``DeviceMesh`` makes DTensor turn a shard-to-shard all-to-all into an
all-gather (its gloo fallback); the trace records the all-to-all NCCL
would issue (:func:`_dtensor_hooks`).

Usage (no GPU needed):
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both]

Run as a program it first makes the default process group a fake one of
the production mesh's size (512 ranks back both meshes: the single-pod
16 x 16 mesh is a sub-mesh of its first 256), before anything else touches
``torch.distributed``, as the reference sets ``XLA_FLAGS`` before JAX loads.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time
import traceback
import weakref

import torch

from repro_torch import configs as config_lib
from repro_torch.configs.base import SHAPE_SPECS
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (DEFAULT_DATA, DEFAULT_MODEL, DEFAULT_PODS, make_dist,
                                     make_production_spmd_mesh)
from repro_torch.models import registry
from repro_torch.train import optimizer, trainer
from repro_torch.train import tree as tr

OUT_DIR = os.path.join("experiments", "dryrun_torch")

# per-arch training recipe (gradient accumulation for the giants; factored
# optimizer where AdamW's f32 moments cannot fit even ZeRO-1-sharded)
TRAIN_RECIPE = {
    "kimi-k2-1t-a32b": dict(micro_batches=8, opt="adafactor"),
    "jamba-1.5-large-398b": dict(micro_batches=8, opt="adafactor"),
    "internlm2-20b": dict(micro_batches=2, opt="adamw"),
    "gemma-7b": dict(micro_batches=2, opt="adamw"),
}


def train_cfg_for(arch: str) -> trainer.TrainConfig:
    r = TRAIN_RECIPE.get(arch, dict(micro_batches=1, opt="adamw"))
    return trainer.TrainConfig(
        micro_batches=r["micro_batches"],
        opt=optimizer.OptConfig(name=r["opt"]),
    )


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {  # the functional collectives' ops -> the reference's HLO kinds
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


# ops that move no data (allocations, metadata-only reshapes)
_NO_TRAFFIC = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                         "new_empty_strided", "_unsafe_view", "lift_fresh"})


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------
def init_fake_world(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (this process is rank 0); nothing is sent anywhere."""
    import torch.distributed as tdist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg (the fake "
            f"process group), which this torch {torch.__version__} lacks") from e
    if tdist.is_initialized():
        if tdist.get_world_size() != world_size or tdist.get_backend() != "fake":
            raise RuntimeError(
                f"a {tdist.get_backend()} process group of {tdist.get_world_size()} ranks "
                f"is up; the dry run needs a fake one of {world_size}")
        return
    tdist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------
def build_cell(arch: str, shape_name: str, mesh, unroll: bool = True,
               cfg=None, variant: str = "baseline"):
    """-> (step fn, tuple of fake DTensor args). The step carries
    ``donate_argnums`` (the state it updates in place, the reference's
    donated buffers).

    ``unroll`` and ``variant='opt'`` (attention causal skip, bf16 SSM state
    expansion) set the config's flags as the reference's do; the port's
    layer loop is Python either way, so ``unroll`` changes only the
    attention's numerics. ``cfg`` overrides the arch config (the
    depth-reduced extrapolation passes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = (cfg or config_lib.get(arch)).replace(unroll=unroll)
    if variant == "opt":
        cfg = cfg.replace(causal_skip=True, ssm_bf16=True)
    model = registry.build(cfg)
    dist = make_dist(mesh)
    specs = registry.input_specs(cfg, shape_name)
    kind = SHAPE_SPECS[shape_name]["kind"]
    fake = FakeTensorMode()
    params_sds = registry.param_shapes(cfg)

    if kind == "train":
        tcfg = train_cfg_for(arch)
        state_sds = trainer.init_train_state(tcfg, params_sds)
        step = trainer.make_train_step(model, tcfg, dist)
        p_spec = sharding.param_specs(cfg, params_sds, dist)
        s_spec = sharding.opt_specs(cfg, state_sds, p_spec, dist)
        b_spec = sharding.batch_specs(specs["batch"], dist)
        args = (sharding.place(params_sds, p_spec, mesh, fake),
                sharding.place(state_sds, s_spec, mesh, fake),
                sharding.place(specs["batch"], b_spec, mesh, fake))
        step.donate_argnums = (0, 1)
        return step, args

    # Inference cells: TP-only params (FSDP would all-gather weights every
    # step). Weights are read-only at inference; the "model" axis alone
    # holds them.
    p_spec = sharding.param_specs(cfg, params_sds, dist, fsdp_threshold=None)
    params = sharding.place(params_sds, p_spec, mesh, fake)
    if kind == "prefill":
        def step(params, batch):
            return model.prefill(params, batch, dist=dist)

        b_spec = sharding.batch_specs(specs["batch"], dist)
        step.donate_argnums = ()
        return step, (params, sharding.place(specs["batch"], b_spec, mesh, fake))

    # decode: serve_step(params, cache, tokens), the paged attention's plain
    # version (the reference lowers its jnp path)
    def step(params, cache, tokens):
        return model.decode(params, cache, tokens, dist=dist, kernel_backend="torch")

    c_spec = sharding.cache_specs(cfg, specs["cache"], dist)
    t_spec = sharding.batch_specs({"tokens": specs["tokens"]}, dist)
    step.donate_argnums = (1,)
    return step, (params, sharding.place(specs["cache"], c_spec, mesh, fake),
                  sharding.place({"tokens": specs["tokens"]}, t_spec, mesh, fake)["tokens"])


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------
def _local(t) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """This rank's bytes of every tensor in a tree (DTensors: the shard)."""
    leaves = tr.leaves(tree) if isinstance(tree, dict) else [tree]
    return sum(_local(t).numel() * _local(t).element_size()
               for t in leaves if isinstance(t, torch.Tensor))


class StepCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the local ops under it: an op on DTensors is passed on to
    DTensor (``NotImplemented``), whose local ops on this rank's shards
    come back here. Records matmul-family FLOPs, bytes in and out,
    collectives by kind (and by kind and mesh axis, ``coll_axes``), and the
    live bytes of the storages the ops make (``peak``: their maximum)."""

    def __init__(self, device_mesh=None):
        super().__init__()
        dm = device_mesh
        self.axis_of = {} if dm is None else {
            dm.get_group(i).group_name: name for i, name in enumerate(dm.mesh_dim_names)}
        self.coll_axes = collections.Counter()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakSet()
        self._quiet = 0  # inside a collective whose parts are not counted

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in torch.utils._pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def collective(self, kind: str, out, axis: str = "?") -> None:
        self.coll_bytes[kind] += sum(t.numel() * t.element_size()
                                     for t in torch.utils._pytree.tree_leaves(out)
                                     if isinstance(t, torch.Tensor))
        self.coll_counts[kind] += 1
        self.coll_axes[kind, axis] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        self._track(out)
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "_dtensor"):
            if name in _KIND:
                group = next((a for a in reversed(args) if isinstance(a, str)), None)
                self.collective(_KIND[name], out, self.axis_of.get(group, "?"))
            elif name not in ("wait_tensor", "broadcast_"):
                raise NotImplementedError(f"dry run: no collective kind for {func}")
            return out
        if func.is_view or name in _NO_TRAFFIC:
            return out
        fl = self.registry.get(func._overloadpacket)
        if fl is not None:
            self.flops += fl(*args, **kwargs, out_val=out)
        outs = [t for t in torch.utils._pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if outs:
            ins = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


@contextlib.contextmanager
def _patched(owner, name: str, wrap):
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def _dtensor_hooks(counter: StepCounter):
    """Two of DTensor's internals, counted as what they stand for:

    * its sharding propagation runs some ops once more on fake tensors of
      the *global* shape, to learn the output's shape: work no rank does,
      so not counted (neither FLOPs nor memory);
    * its shard-to-shard reshard issues an all-to-all on a CUDA mesh and an
      all-gather plus a local chunk on a CPU one: recorded as what NCCL
      would move (the all-to-all's result, this rank's new shard)."""
    from torch.distributed.tensor import _sharding_prop, placement_types

    def quiet(orig):
        def run(*args, **kwargs):
            counter._quiet += 1
            try:
                return orig(*args, **kwargs)
            finally:
                counter._quiet -= 1
        return run

    def alltoall(orig):
        def run(input, gather_dim, shard_dim, mesh, mesh_dim):
            out = quiet(orig)(input, gather_dim, shard_dim, mesh, mesh_dim)
            counter._track(out)
            counter.collective("all-to-all", out, mesh.mesh_dim_names[mesh_dim])
            return out
        return run

    with _patched(_sharding_prop.ShardingPropagator, "_propagate_tensor_meta_non_cached",
                  quiet), \
            _patched(placement_types, "shard_dim_alltoall", alltoall):
        yield


def trace_step(step, args) -> tuple:
    """Run ``step(*args)`` on its fake DTensors under a :class:`StepCounter`
    (plain tensors the step makes are taken as replicated, DTensor's
    implicit replication) -> (outputs, counter)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    leaf = next(t for t in tr.leaves(args[0]) if isinstance(t, DTensor))
    counter = StepCounter(leaf.device_mesh)
    with leaf._local_tensor.fake_mode, implicit_replication(), counter, \
            _dtensor_hooks(counter):
        out = step(*args)
    return out, counter


def lower_stats(arch: str, shape_name: str, mesh, unroll: bool,
                cfg=None, variant: str = "baseline") -> dict:
    """Build and trace one variant; return memory/cost/collective stats.
    ``lower_s`` is the cell's construction, ``compile_s`` the trace. The
    trace counts every micro-batch of a train step; the reference's record
    counts its micro-batch scan body once and the roofline multiplies by
    the micro-batches, so a train cell's ``cost_analysis`` holds the
    traced count over the recipe's micro-batches (the step's is that times
    ``micro_batches``, exactly)."""
    t0 = time.time()
    step, args = build_cell(arch, shape_name, mesh, unroll=unroll, cfg=cfg, variant=variant)
    t_lower = time.time()
    out, c = trace_step(step, args)
    t_compile = time.time()
    train = SHAPE_SPECS[shape_name]["kind"] == "train"
    micro = train_cfg_for(arch).micro_batches if train else 1
    arg_bytes = sum(local_bytes(a) for a in args)
    mem_fields = dict(
        argument_size_in_bytes=arg_bytes,
        output_size_in_bytes=local_bytes({str(i): o for i, o in enumerate(out)}),
        temp_size_in_bytes=c.peak,
        alias_size_in_bytes=sum(local_bytes(args[i]) for i in step.donate_argnums),
    )
    return dict(
        lower_s=round(t_lower - t0, 2),
        compile_s=round(t_compile - t_lower, 2),
        memory_analysis=mem_fields,
        cost_analysis={"bytes accessed": c.bytes / micro, "flops": c.flops / micro},
        collectives={"bytes": dict(c.coll_bytes), "counts": dict(c.coll_counts)},
    )


def _lerp_stats(s1: dict, s2: dict, l1: int, l2: int, target: int) -> dict:
    """Linear depth extrapolation of flops/bytes/collective counts:
    f(L) = f(l1) + (f(l2) - f(l1)) / (l2 - l1) * (L - l1). Exact for uniform
    layer stacks (every super-block identical)."""
    def lerp(a, b):
        return a + (b - a) / (l2 - l1) * (target - l1)

    out = dict(s1)
    out["cost_analysis"] = {
        k: lerp(s1["cost_analysis"].get(k, 0.0), s2["cost_analysis"].get(k, 0.0))
        for k in set(s1["cost_analysis"]) | set(s2["cost_analysis"])}
    out["collectives"] = {
        "bytes": {k: lerp(s1["collectives"]["bytes"][k],
                          s2["collectives"]["bytes"][k])
                  for k in s1["collectives"]["bytes"]},
        "counts": {k: lerp(s1["collectives"]["counts"][k],
                           s2["collectives"]["counts"][k])
                   for k in s1["collectives"]["counts"]},
    }
    return out


# MoE training/prefill cells: the reference's unrolled expert dispatch is
# too heavy for its SPMD partitioner at full depth, so it costs a (g, 2g)
# shallow pair, extrapolates linearly to full depth, and takes the memory
# from a full-depth pass. The port keeps that method (and its record).
def needs_extrapolation(arch: str, shape_name: str) -> bool:
    cfg = config_lib.get(arch)
    return cfg.is_moe and SHAPE_SPECS[shape_name]["kind"] in ("train", "prefill")


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: str = OUT_DIR, unroll: bool = True,
             variant: str = "baseline") -> dict:
    mesh = make_production_spmd_mesh(multi_pod=(mesh_name == "multi"))
    record = dict(arch=arch, shape=shape_name, mesh=mesh_name,
                  n_devices=mesh.size, unroll=unroll, variant=variant,
                  status="error")
    try:
        if unroll and needs_extrapolation(arch, shape_name):
            cfg = config_lib.get(arch)
            g = cfg.group_size
            l1, l2 = g, 2 * g
            full = lower_stats(arch, shape_name, mesh, unroll=False, variant=variant)
            s1 = lower_stats(arch, shape_name, mesh, unroll=True,
                             cfg=cfg.replace(n_layers=l1), variant=variant)
            s2 = lower_stats(arch, shape_name, mesh, unroll=True,
                             cfg=cfg.replace(n_layers=l2), variant=variant)
            stats = _lerp_stats(s1, s2, l1, l2, cfg.n_layers)
            stats["memory_analysis"] = full["memory_analysis"]
            stats["method"] = (
                f"cost: unrolled depth-{l1}/{l2} linear extrapolation to "
                f"{cfg.n_layers}; memory: full-depth scan compile")
            stats["compile_s"] = round(
                full["compile_s"] + s1["compile_s"] + s2["compile_s"], 2)
        else:
            stats = lower_stats(arch, shape_name, mesh, unroll=unroll, variant=variant)
        record.update(status="ok", **stats)
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"(trace {record['compile_s']}s, "
              f"flops={record['cost_analysis'].get('flops', 0):.3e})")
    except Exception as e:  # noqa: BLE001 -- record the failure, keep going
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAIL {e}")
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{mesh_name}.json".replace("/", "_")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(record, f, indent=1)
    return record


def all_cells():
    for arch in config_lib.all_archs():
        for shape_name in config_lib.get(arch).shapes():
            yield arch, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--no-unroll", action="store_true",
                    help="the attention's scanned numerics (unroll=False)")
    ap.add_argument("--variant", default="baseline",
                    choices=("baseline", "opt"),
                    help="'opt' sets causal skip and the bf16 SSM expansion")
    args = ap.parse_args(argv)

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    init_fake_world(DEFAULT_DATA * DEFAULT_MODEL * (DEFAULT_PODS if "multi" in meshes else 1))
    if args.all:
        cells = list(all_cells())
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]
    ok = fail = 0
    for arch, shape_name in cells:
        for m in meshes:
            rec = run_cell(arch, shape_name, m, args.out,
                           unroll=not args.no_unroll, variant=args.variant)
            ok += rec["status"] == "ok"
            fail += rec["status"] != "ok"
    print(f"[dryrun] done: {ok} ok / {fail} failed")
    return 0 if fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
