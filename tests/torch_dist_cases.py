"""Cases of the port's data-parallel training, and the rank worker that runs
them.

The tests feed the same global batches (made here with numpy) to the JAX
package's one-device train step and to the port's data-parallel step. The
port's side runs as the ranks of a job that
``repro_torch.launch.multihost.launch`` starts, on the CPU over gloo:

    python tests/torch_dist_cases.py OUT_DIR

Every rank of a 4-rank job runs every case of ``CASES`` on its mesh (the
job's 4 ranks as ``data`` 4 unless the case names another geometry), and
ranks 0 and 1 run the ``TWO_RANK`` cases once more on a 2-rank mesh over a
subgroup of the job. Then the checkpoint case (4 ranks write, ranks 0 and 1
resume) and ``launch.train --mesh single``. Rank 0 of each mesh saves its
gradients, params, train state and metrics after every step to
``OUT_DIR/<case>_n<ranks>.npz``; every rank saves SHA-256 digests of them,
its collective record and its MoE drops to ``OUT_DIR/rank<r>.json``. This
module imports the port only, never JAX.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import sys

import numpy as np

B, S, STEPS, LR = 8, 16, 3, 1e-2
RANKS = 4
# name -> arch, what replaces its reduced() config (float32 always), the
# optimizer, micro-batches, compression, the mesh (data, model, pods)
CASES = {
    "dense": dict(arch="qwen2-0.5b", opt="adamw"),
    # capacity factor 1: 128 (token, choice) pairs a micro-batch on 6 experts
    # of capacity 21 (5 per rank at 4 ranks), so the reference drops some
    "moe": dict(arch="qwen2-moe-a2.7b", rep=dict(capacity_factor=1.0), opt="adafactor",
                micro=2, compress=True),
    "masked": dict(arch="qwen2-0.5b", opt="adamw", masked=True),
    "vl": dict(arch="qwen2-vl-2b", opt="adamw"),
    "whisper": dict(arch="whisper-tiny", opt="adafactor"),
    "pods": dict(arch="qwen2-0.5b", opt="adamw", mesh=(2, 1, 2)),
    "model2": dict(arch="qwen2-moe-a2.7b", rep=dict(capacity_factor=1.0), opt="adafactor",
                   micro=2, compress=True, mesh=(2, 2, None)),
}
TWO_RANK = ("dense", "moe")
CKPT = dict(arch="qwen2-0.5b", steps=4, save_every=2)
LAUNCH_ARGS = ("--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--mesh", "single",
               "--steps", "3", "--seq-len", "16", "--global-batch", "8", "--save-every", "2",
               "--log-every", "1")


def case(name: str) -> dict:
    c = dict(rep={}, micro=1, compress=False, masked=False, mesh=(RANKS, 1, None))
    c.update(CASES[name])
    return c


def batches(cfg, name: str) -> list:
    """The case's STEPS global batches: the token pipeline's, with M-RoPE
    positions or frames where the config has them; "masked" masks every
    label of rows 0-1 (all of rank 0's at 4 ranks), half of row 4's and a
    few of row 7's."""
    from repro_torch.data import pipeline

    spec = pipeline.DataSpec(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=11)
    r = np.random.default_rng(12)
    out, st = [], pipeline.DataState()
    for _ in range(STEPS):
        b, st = pipeline.next_batch(spec, st)
        if cfg.mrope:
            b["positions"] = r.integers(0, 40, (3, B, S)).astype(np.int32)
        if cfg.encdec:
            b["frames"] = r.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
        if case(name)["masked"]:
            b["labels"][0:2] = -1
            b["labels"][4, ::2] = -1
            b["labels"][7, :3] = -1
        out.append(b)
    return out


def build(name: str):
    """(the port's float32 model, its TrainConfig) of a case."""
    import torch

    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.train import optimizer, trainer

    c = case(name)
    cfg = configs.reduced(c["arch"]).replace(dtype=torch.float32, **c["rep"])
    tcfg = trainer.TrainConfig(micro_batches=c["micro"], compress_grads=c["compress"],
                               opt=optimizer.OptConfig(name=c["opt"], lr=LR, warmup_steps=0,
                                                       total_steps=10))
    return registry.build(cfg), tcfg


def digest(tree) -> str:
    """SHA-256 of every leaf's path and bytes."""
    import torch

    from repro_torch.train import tree as tr

    h = hashlib.sha256()
    for k, v in tr.items(tree):
        h.update(k.encode())
        h.update(v.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def flat(tree, prefix: str) -> dict:
    from repro_torch.train import tree as tr

    return {f"{prefix}/{k}": v.detach().numpy().copy() for k, v in tr.items(tree)}


def count_drops(model, tcfg, params, batch, dist) -> int:
    """This rank's dropped (token, choice) pairs in one forward of the
    step's micro-batches (``dispatch_slots``' kept mask)."""
    import torch

    from repro_torch.models import moe
    from repro_torch.train import trainer

    dropped, inner = [], moe.dispatch_slots

    def counting(*a, **kw):
        out = inner(*a, **kw)
        dropped.append(int((~out[2]).sum()))
        return out

    moe.dispatch_slots = counting
    try:
        local = trainer.rank_batch(batch, tcfg.micro_batches, dist)
        micro = trainer._split_micro(local, tcfg.micro_batches)
        with torch.no_grad():
            for i in range(tcfg.micro_batches):
                model.loss_fn(params, {k: v[i] for k, v in micro.items()}, dist)
    finally:
        moe.dispatch_slots = inner
    return sum(dropped)


@contextlib.contextmanager
def received_grads(tcfg, into: list):
    """Copies of the gradients ``trainer.make_train_step`` hands on after
    its reduce (to the compression, else to the optimizer), appended to
    ``into``."""
    from repro_torch.train import compression, optimizer
    from repro_torch.train import tree as tr

    mod, name = (compression, "compress_grads_") if tcfg.compress_grads else (optimizer,
                                                                             "update")
    inner = getattr(mod, name)

    def spy(*args, **kw):
        into.append(tr.map(lambda g: g.detach().clone(), args[0 if mod is compression else 1]))
        return inner(*args, **kw)

    setattr(mod, name, spy)
    try:
        yield
    finally:
        setattr(mod, name, inner)


def run_case(name: str, dist, out_dir: str, record: dict) -> None:
    """STEPS steps of a case from the port's init (seed 0) on ``dist``."""
    from repro_torch.core import sharding
    from repro_torch.train import trainer

    model, tcfg = build(name)
    params = model.init(seed=0, device="cpu")
    state = trainer.init_train_state(tcfg, params)
    step = trainer.make_train_step(model, tcfg, dist)
    saved, mine = {}, {"digests": [], "calls": [], "bytes": []}
    for k, b in enumerate(batches(model.cfg, name), 1):
        batch = trainer.batch_to(b, "cpu")
        if k == 1 and model.cfg.is_moe:
            mine["drops"] = count_drops(model, tcfg, params, batch, dist)
        sharding.reset_collective_bytes()
        got = []
        with received_grads(tcfg, got):
            params, state, mets = step(params, state, batch)
        grads, = got
        mine["calls"].append(sharding.collective_calls())
        mine["bytes"].append(sharding.collective_bytes_total())
        mets = {m: v.reshape(1) for m, v in mets.items()}
        mine["digests"].append(digest({"grads": grads, "params": params, "state": state,
                                       "mets": mets}))
        if dist.mesh.rank == 0:
            for prefix, tree in (("grads", grads), ("params", params), ("state", state),
                                 ("mets", mets)):
                saved.update(flat(tree, f"step{k}/{prefix}"))
    n = dist.mesh.size
    if dist.mesh.rank == 0:
        np.savez(os.path.join(out_dir, f"{name}_n{n}.npz"), **saved)
    record[f"{name}_n{n}"] = mine


def ckpt_spec(cfg):
    from repro_torch.data import pipeline

    return pipeline.DataSpec(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=13)


def ckpt_model():
    import torch

    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.train import optimizer, trainer

    cfg = configs.reduced(CKPT["arch"]).replace(dtype=torch.float32)
    tcfg = trainer.TrainConfig(opt=optimizer.OptConfig(lr=LR, warmup_steps=0, total_steps=10))
    return registry.build(cfg), tcfg


def restore(ckpt_dir: str, model, tcfg, step: int) -> tuple:
    """(params, train state, data state) of the checkpoint at ``step``."""
    import torch

    from repro_torch.data import pipeline
    from repro_torch.train import checkpoint, trainer

    fresh = model.init(seed=1, device="cpu")
    like = {"params": fresh, "train_state": trainer.init_train_state(tcfg, fresh),
            "data_step": torch.tensor(0)}
    got, man = checkpoint.restore(ckpt_dir, like, step=step)
    assert man["step"] == step
    return got["params"], got["train_state"], pipeline.DataState(step=int(got["data_step"]))


def two_rank_mesh(mesh):
    """A ``data`` 2 x ``model`` 1 mesh over job ranks 0 and 1, made from
    subgroups that every rank creates (None on the other ranks)."""
    import torch.distributed as tdist

    from repro_torch.launch import mesh as mesh_mod

    pair = tdist.new_group([0, 1])
    alone = [tdist.new_group([r]) for r in range(RANKS)]
    me = mesh.rank
    if me >= 2:
        return None
    return mesh_mod.TrainMesh(
        axis_names=("data", "model"), shape=dict(data=2, model=1), coords=dict(data=me, model=0),
        rank=me, size=2, device=mesh.device, backend=mesh.backend,
        groups={("data",): pair, ("model",): alone[me], ("data", "model"): pair})


def main(out_dir: str) -> None:
    import torch
    import torch.distributed as tdist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import multihost
    from repro_torch.launch import train as launch_train
    from repro_torch.train import fault, trainer

    torch.set_num_threads(1)  # several ranks share this machine's cores
    info = multihost.initialize()
    me = info.process_id
    meshes = {}
    for name in CASES:
        geom = case(name)["mesh"]
        if geom not in meshes:
            meshes[geom] = mesh_mod.train_mesh(*geom[:2], pods=geom[2], device="cpu")
    pair = two_rank_mesh(meshes[(RANKS, 1, None)])  # None on ranks 2, 3
    record = {}
    for name in CASES:
        run_case(name, mesh_mod.make_dist(meshes[case(name)["mesh"]]), out_dir, record)
        if pair is not None and name in TWO_RANK:
            run_case(name, mesh_mod.make_dist(pair), out_dir, record)

    # a checkpoint written by 4 ranks, resumed on 2 (the test resumes it in one process)
    model, tcfg = ckpt_model()
    ckpt_dir = os.path.join(out_dir, "ckpt")
    sup = fault.Supervisor(ckpt_dir, save_every=CKPT["save_every"], keep=5)
    d4 = mesh_mod.make_dist(meshes[(RANKS, 1, None)])
    params, _, data, hist = trainer.train_loop(model, tcfg, ckpt_spec(model.cfg), CKPT["steps"],
                                               supervisor=sup, device="cpu", dist=d4)
    record["ckpt_n4"] = dict(losses=[h["loss"] for h in hist], data_step=data.step,
                             digest=digest(params))
    if pair is not None:
        p, s, data = restore(ckpt_dir, model, tcfg, CKPT["save_every"])
        record["ckpt_resumed_n2"] = dict(data_step_restored=data.step)
        params, _, data, hist = trainer.train_loop(
            model, tcfg, ckpt_spec(model.cfg), CKPT["steps"], params=p, train_state=s,
            data_state=data, dist=mesh_mod.make_dist(pair))
        record["ckpt_resumed_n2"].update(losses=[h["loss"] for h in hist], data_step=data.step,
                                         digest=digest(params))

    # launch.train --mesh single on a 2 x 2 production mesh
    mesh_mod.DEFAULT_DATA, mesh_mod.DEFAULT_MODEL = 2, 2
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        loss = launch_train.main([*LAUNCH_ARGS, "--ckpt-dir", os.path.join(out_dir, "launch")])
    record["launch"] = dict(loss=loss, log=log.getvalue())
    with open(os.path.join(out_dir, f"rank{me}.json"), "w") as f:
        json.dump(record, f)
    tdist.barrier()
    tdist.destroy_process_group()
    print(f"rank {me} of {info.num_processes}: data-parallel cases done")


if __name__ == "__main__":
    main(sys.argv[1])
