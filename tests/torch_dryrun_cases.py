"""The port's dry run traced in a process of its own (the fake process group
is per process), for ``tests/test_torch_dryrun.py``:

    python tests/torch_dryrun_cases.py OUT.json

It makes a fake world of the single-pod production mesh's 256 ranks, adds
two small cells to ``SHAPE_SPECS`` (a train and a decode cell whose global
batch divides by the 16 DP ranks), traces ``launch.dryrun.lower_stats`` at
reduced configs on the production mesh, and writes for each cell the
record, the argument bytes that ``launch.sharding``'s specs imply (worked
out here from the spec tree alone) and the collectives by kind and mesh
axis, those issued inside ``moe.apply_moe`` apart. Then a one-rank mesh:
the dry run's FLOPs of a train step and ``torch.utils.flop_counter`` on
the same step run on plain CPU tensors. This module imports the port only,
never JAX.
"""
from __future__ import annotations

import json
import math
import sys

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPE_SPECS
from repro_torch.launch import dryrun, mesh as mesh_lib, sharding
from repro_torch.models import moe as MOE
from repro_torch.models import registry
from repro_torch.train import trainer
from repro_torch.train import tree as tr

CELLS = {  # name -> arch, what replaces its reduced() config, shape, its SHAPE_SPECS entry
    "train": ("qwen2-0.5b", dict(n_layers=1, remat="none"), "test_train",
              dict(seq_len=64, global_batch=16, kind="train")),
    "moe_decode": ("qwen2-moe-a2.7b", {}, "test_decode",
                   dict(seq_len=64, global_batch=16, kind="decode")),
}
ONE_RANK = dict(arch="qwen2-0.5b", shape="test_one", spec=dict(seq_len=40, global_batch=2,
                                                               kind="train"))


def spec_bytes(arch: str, cfg, shape_name: str, mesh) -> int:
    """One rank's bytes of every input of the cell, from the specs: each
    leaf's elements over the sizes of the mesh axes its spec names."""
    dist = mesh_lib.make_dist(mesh)
    specs = registry.input_specs(cfg, shape_name)
    params = registry.param_shapes(cfg)
    kind = SHAPE_SPECS[shape_name]["kind"]
    if kind == "train":
        p_spec = sharding.param_specs(cfg, params, dist)
        state = trainer.init_train_state(dryrun.train_cfg_for(arch), params)
        trees = [(params, p_spec), (state, sharding.opt_specs(cfg, state, p_spec, dist)),
                 (specs["batch"], sharding.batch_specs(specs["batch"], dist))]
    else:
        toks = {"tokens": specs["tokens"]}
        trees = [(params, sharding.param_specs(cfg, params, dist, fsdp_threshold=None)),
                 (specs["cache"], sharding.cache_specs(cfg, specs["cache"], dist)),
                 (toks, sharding.batch_specs(toks, dist))]
    total = 0
    for tree, spec in trees:
        for (_, leaf), (_, sp) in zip(tr.items(tree), tr.items(spec)):
            split = 1
            for ax in sp:
                for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                    split *= mesh.shape[a]
            total += math.prod(leaf.shape) // split * leaf.dtype.itemsize
    return total


def counter():
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return next(m for m in _get_current_dispatch_mode_stack()
                if isinstance(m, dryrun.StepCounter))


def main(out_path: str) -> None:
    dryrun.init_fake_world(256)
    mesh = mesh_lib.make_production_spmd_mesh()
    in_moe = {}
    apply_moe = MOE.apply_moe

    def traced_moe(*a, **k):  # the collectives issued inside apply_moe
        c = counter()
        before = dict(c.coll_axes)
        out = apply_moe(*a, **k)
        for key, n in c.coll_axes.items():
            if n > before.get(key, 0):
                in_moe["/".join(key)] = in_moe.get("/".join(key), 0) + n - before.get(key, 0)
        return out

    MOE.apply_moe = traced_moe
    out = {}
    for name, (arch, rep, shape, spec) in CELLS.items():
        SHAPE_SPECS[shape] = spec
        cfg = configs.reduced(arch).replace(**rep)
        in_moe.clear()
        axes = {}
        orig_trace = dryrun.trace_step

        def trace(step, args):
            res, c = orig_trace(step, args)
            axes.update({"/".join(k): v for k, v in c.coll_axes.items()})
            return res, c

        dryrun.trace_step = trace
        try:
            rec = dryrun.lower_stats(arch, shape, mesh, unroll=True, cfg=cfg)
        finally:
            dryrun.trace_step = orig_trace
        out[name] = dict(record=rec, spec_bytes=spec_bytes(arch, cfg, shape, mesh),
                         axes=axes, in_moe=dict(in_moe), n_devices=mesh.size)
    MOE.apply_moe = apply_moe

    # one rank: the dry run's count against FlopCounterMode on plain tensors
    SHAPE_SPECS[ONE_RANK["shape"]] = ONE_RANK["spec"]
    cfg = configs.reduced(ONE_RANK["arch"]).replace(n_layers=1, remat="none", unroll=True,
                                                    causal_skip=True)
    one = mesh_lib.spmd_mesh(1, 1)
    rec = dryrun.lower_stats(ONE_RANK["arch"], ONE_RANK["shape"], one, unroll=True, cfg=cfg,
                             variant="opt")
    model = registry.build(cfg)
    params = model.init(seed=0, device="cpu")
    tcfg = dryrun.train_cfg_for(ONE_RANK["arch"])
    state = trainer.init_train_state(tcfg, params)
    B, S = ONE_RANK["spec"]["global_batch"], ONE_RANK["spec"]["seq_len"]
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=g, dtype=torch.int32)
             for k in ("tokens", "labels")}
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        trainer.make_train_step(model, tcfg)(params, state, batch)
    out["one_rank"] = dict(record=rec, flop_counter=fc.get_total_flops())
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
