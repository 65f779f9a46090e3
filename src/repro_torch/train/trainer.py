"""The training step and loop (port of ``repro.train.trainer``): gradient
accumulation over micro-batches, optional int8 gradient compression with
error feedback, AdamW / Adafactor, metrics.

``make_train_step`` returns ``(params, train_state, batch) -> (params,
train_state, metrics)``. Gradients come from autograd on detached views of
the params; the params and the train state are then updated in place and
returned. With n micro-batches the gradients are summed in float32 and
divided by n, the loss likewise, and the metrics hold no ``ce`` / ``aux``,
as in the reference.

Data parallelism (``dist`` with a mesh, ``launch.mesh.make_dist``) computes
the reference's one-device step over the **global** batch. The step takes
the global batch; each DP rank keeps its rows (``pipeline.dp_rows``: its
share of every micro-batch) and runs the model with ``dist``, whose loss is
the rank's share of the global one (``models.transformer.loss_fn``). The
gradients, cast to float32, are summed over the DP group in flat buckets
and rounded to the dtype the one-device step would hand on (the params'
for one micro-batch, float32 for more); the loss and its metrics are
summed likewise. So the sum is not rounded just once: with one
micro-batch, autograd has already rounded each rank's share to the
params' dtype, and the float32 sum is rounded again, where the one-device
step rounds its gradient over the global batch once. In float32 that is
float32's summation order; in bf16 it moves a gradient by bf16's.
Compression (on the reduced gradient, its error state replicated) and the
optimizer then run on every rank alike: every rank holds the whole params
and state, bit-identical to every other. Ranks
along the ``"model"`` axis compute the same values as their DP peer;
splitting work over it (experts, heads, ff, vocab) is ROADMAP item 15d.
With ``NO_DIST`` nothing is exchanged, and a one-rank mesh gives the
no-mesh result bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import pipeline
from repro_torch.kernels import runtime
from repro_torch.models.dist import NO_DIST, Dist
from repro_torch.models.registry import Model
from repro_torch.train import compression, optimizer
from repro_torch.train import tree as tr


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    micro_batches: int = 1  # gradient-accumulation factor
    compress_grads: bool = False  # int8 + error feedback on the gradients
    opt: optimizer.OptConfig = dataclasses.field(default_factory=optimizer.OptConfig)


def init_train_state(tcfg: TrainConfig, params) -> dict:
    state = {"opt": optimizer.init(tcfg.opt, params)}
    if tcfg.compress_grads:
        state["err"] = compression.init_error(params)
    return state


def _split_micro(batch: dict, n: int) -> dict:
    """(B, ...) -> (n, B/n, ...); M-RoPE ``positions`` (3, B, S) -> (n, 3,
    B/n, S)."""
    def split(key, x):
        if key == "positions":
            return x.reshape(x.shape[0], n, -1, *x.shape[2:]).transpose(0, 1)
        return x.reshape(n, -1, *x.shape[1:])

    return {k: split(k, v) for k, v in batch.items()}


BUCKET = 1 << 26  # float32 values a gradient bucket holds (256 MB)


def _grads(model: Model, params, batch: dict, dist: Dist = NO_DIST) -> tuple:
    """(loss, metrics, grads in the params' dtypes): autograd through the
    model's loss on detached views of the params (a param the loss does not
    reach gets zeros, as ``jax.grad`` gives)."""
    paths, leaves = zip(*((p, v.detach().requires_grad_()) for p, v in tr.items(params)))
    with torch.enable_grad():
        loss, mets = model.loss_fn(tr.unflatten(paths, leaves), batch, dist)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in mets.items()}, tr.unflatten(paths, grads)


def rank_batch(batch: dict, n_micro: int, dist: Dist) -> dict:
    """This DP rank's rows of a global batch (``pipeline.dp_rows``): M-RoPE
    ``positions`` (3, B, S) on axis 1, the rest on axis 0."""
    if dist.dp_size() == 1:
        return batch
    B = batch["tokens"].shape[0]
    rows = torch.from_numpy(pipeline.dp_rows(B, n_micro, dist.dp_rank(), dist.dp_size()))
    return {k: v.index_select(1 if k == "positions" else 0, rows.to(v.device))
            for k, v in batch.items()}


def reduce_grads_(grads, dist: Dist) -> None:
    """Sum the gradients over the DP group in place: float32 copies in flat
    buckets of at most BUCKET values (a large leaf spans several), each
    summed by one ``all_reduce``, then written back, rounded to each leaf's
    dtype (a bf16 leaf's shares were rounded by autograd already). A leaf
    keeps its layout (a strided gradient goes through a contiguous copy):
    the optimizer's norms sum in layout order."""
    pending, size, strided = [], 0, []

    def flush():
        nonlocal pending, size
        flat = torch.cat([g.reshape(-1)[a:b].float() for g, a, b in pending])
        dist.all_reduce_([flat], "grads")
        at = 0
        for g, a, b in pending:
            g.view(-1)[a:b].copy_(flat[at:at + b - a])
            at += b - a
        pending, size = [], 0

    for g in tr.leaves(grads):
        if not g.is_contiguous():
            strided.append((g, g.contiguous()))
            g = strided[-1][1]
        for a in range(0, g.numel(), BUCKET):
            b = min(a + BUCKET, g.numel())
            if size + b - a > BUCKET:
                flush()
            pending.append((g, a, b))
            size += b - a
    if pending:
        flush()
    for g, dense in strided:
        g.copy_(dense)


def step_grads(model: Model, tcfg: TrainConfig, params, batch: dict,
               dist: Dist = NO_DIST) -> tuple:
    """(loss, metrics, gradients) of one step over the global ``batch``, as
    the optimizer receives them: micro-batches accumulated, and under a
    mesh this rank's rows taken and every sum taken over the DP ranks."""
    n_micro = tcfg.micro_batches
    batch = rank_batch(batch, n_micro, dist)
    if n_micro == 1:
        loss, mets, grads = _grads(model, params, batch, dist)
    else:
        micro = _split_micro(batch, n_micro)
        grads = tr.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        for i in range(n_micro):
            mb_loss, _, g = _grads(model, params, {k: v[i] for k, v in micro.items()}, dist)
            for (_, acc), (_, gi) in zip(tr.items(grads), tr.items(g)):
                acc.add_(gi)
            del g
            loss = loss + mb_loss
        for acc in tr.leaves(grads):
            acc.div_(n_micro)
        loss = loss / n_micro
        mets = {}
    if dist.mesh is not None:
        reduce_grads_(grads, dist)
        names = sorted(mets)
        total = dist.psum(torch.stack([loss, *(mets[k] for k in names)]), "loss")
        loss, mets = total[0], {k: total[1 + i] for i, k in enumerate(names)}
    return loss, mets, grads


def make_train_step(model: Model, tcfg: TrainConfig, dist: Dist = NO_DIST):
    """The step over the global batch; ``dist`` as the module says."""
    def train_step(params, train_state: dict, batch: dict):
        loss, mets, grads = step_grads(model, tcfg, params, batch, dist)
        if tcfg.compress_grads:  # the gradients are this step's own: compress in place
            compression.compress_grads_(grads, train_state["err"])
        params, train_state["opt"], opt_mets = optimizer.update(
            tcfg.opt, grads, train_state["opt"], params)
        return params, train_state, {"loss": loss, **opt_mets, **mets}

    return train_step


def batch_to(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def train_loop(model: Model, tcfg: TrainConfig, data_spec, steps: int, params=None,
               train_state=None, data_state=None, supervisor=None, seed: int = 0,
               device=None, dist: Dist = NO_DIST) -> tuple:
    """The loop from the train state's step up to ``steps``: -> (params,
    train_state, data_state, history of float metrics), with the
    ``supervisor``'s checkpoints written by the time it returns. Runs on
    ``device`` (CUDA unless named; the given params' device when there are
    params, the mesh's under ``dist``); fresh params come from
    ``model.init(seed, device)``, the same on every rank. Under a mesh every
    rank calls it alike and takes its rows of each global batch."""
    if params is None:
        dev = dist.mesh.device if dist.mesh is not None else runtime.resolve_device(device)
        params = model.init(seed=seed, device=dev)
    dev = tr.leaves(params)[0].device
    train_state = train_state or init_train_state(tcfg, params)
    data_state = data_state or pipeline.DataState()
    step_fn = make_train_step(model, tcfg, dist)
    history, writing = [], []
    start = int(train_state["opt"]["step"])
    for _ in range(start, steps):
        batch, data_state = pipeline.next_batch(data_spec, data_state)
        params, train_state, mets = step_fn(params, train_state, batch_to(batch, dev))
        history.append({k: float(v) for k, v in mets.items()})
        if supervisor is not None:
            writing.append(supervisor.maybe_save(
                int(train_state["opt"]["step"]),
                {"params": params, "train_state": train_state,
                 "data_step": torch.tensor(data_state.step)}, dist=dist))
    for t in writing:  # the checkpoints are on disk when the loop returns
        if t is not None:
            t.join()
    return params, train_state, data_state, history
