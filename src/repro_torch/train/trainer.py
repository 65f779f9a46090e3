"""The training step and loop (port of ``repro.train.trainer``): gradient
accumulation over micro-batches, optional int8 gradient compression with
error feedback, AdamW / Adafactor, metrics.

``make_train_step`` returns ``(params, train_state, batch) -> (params,
train_state, metrics)``. Gradients come from autograd on detached views of
the params; the params and the train state are then updated in place and
returned. With n micro-batches the gradients are summed in float32 and
divided by n, the loss likewise, and the metrics hold no ``ce`` / ``aux``,
as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import runtime
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


def _grads(model: Model, params, batch: dict) -> tuple:
    """(loss, metrics, grads in the params' dtypes): autograd through the
    model's loss on detached views of the params (a param the loss does not
    reach gets zeros, as ``jax.grad`` gives)."""
    paths, leaves = zip(*((p, v.detach().requires_grad_()) for p, v in tr.items(params)))
    with torch.enable_grad():
        loss, mets = model.loss_fn(tr.unflatten(paths, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in mets.items()}, tr.unflatten(paths, grads)


def make_train_step(model: Model, tcfg: TrainConfig):
    n_micro = tcfg.micro_batches

    def train_step(params, train_state: dict, batch: dict):
        if n_micro == 1:
            loss, mets, grads = _grads(model, params, batch)
        else:
            micro = _split_micro(batch, n_micro)
            grads = tr.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(n_micro):
                mb_loss, _, g = _grads(model, params, {k: v[i] for k, v in micro.items()})
                for (_, acc), (_, gi) in zip(tr.items(grads), tr.items(g)):
                    acc.add_(gi)
                del g
                loss = loss + mb_loss
            for acc in tr.leaves(grads):
                acc.div_(n_micro)
            loss = loss / n_micro
            mets = {}
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
               device=None) -> tuple:
    """Single-process loop from the train state's step up to ``steps``:
    -> (params, train_state, data_state, history of float metrics), with
    the ``supervisor``'s checkpoints written by the time it returns. Runs
    on ``device`` (CUDA unless named; the given params' device when there
    are params); fresh params come from ``model.init(seed, device)``."""
    from repro_torch.data import pipeline

    if params is None:
        params = model.init(seed=seed, device=runtime.resolve_device(device))
    dev = tr.leaves(params)[0].device
    train_state = train_state or init_train_state(tcfg, params)
    data_state = data_state or pipeline.DataState()
    step_fn = make_train_step(model, tcfg)
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
                 "data_step": torch.tensor(data_state.step)}))
    for t in writing:  # the checkpoints are on disk when the loop returns
        if t is not None:
            t.join()
    return params, train_state, data_state, history
