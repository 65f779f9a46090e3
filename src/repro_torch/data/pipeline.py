"""Deterministic, resumable, shard-aware token pipeline (port of
``repro.data.pipeline``; numpy only, batch for batch the reference's).

A seeded synthetic corpus: Zipfian unigram draws in which every other
``ngram``-token block repeats the one before it (structure a model can
learn, so the loss falls), packed into fixed (B, S) batches. The state is
one integer (``step``): checkpointing it and restoring anywhere reproduces
the sample sequence, on any number of data-parallel ranks (each slices its
rows of the global batch; :func:`dp_rows` says which under micro-batches).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataSpec:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    ngram: int = 8  # repeated-structure length (gives the model signal)


@dataclasses.dataclass
class DataState:
    step: int = 0


def _batch_rng(spec: DataSpec, step: int) -> np.random.Generator:
    return np.random.default_rng((spec.seed, step))


def next_batch(spec: DataSpec, state: DataState, dp_rank: int = 0, dp_size: int = 1) -> tuple:
    """-> ({"tokens", "labels"} int32 (B / dp_size, S), the next state);
    labels are the next tokens."""
    rng = _batch_rng(spec, state.step)
    B, S = spec.global_batch, spec.seq_len
    toks = (rng.zipf(spec.zipf_a, size=(B, S + 1)) - 1) % spec.vocab
    n = spec.ngram
    for b in range((S + 1) // (2 * n)):
        lo = b * 2 * n
        toks[:, lo + n:lo + 2 * n] = toks[:, lo:lo + n]
    toks = toks.astype(np.int32)
    assert B % dp_size == 0, (B, dp_size)
    rows = slice(dp_rank * (B // dp_size), (dp_rank + 1) * (B // dp_size))
    batch = {"tokens": toks[rows, :S], "labels": toks[rows, 1:S + 1]}
    return batch, DataState(step=state.step + 1)


def dp_rows(global_batch: int, n_micro: int, dp_rank: int, dp_size: int) -> np.ndarray:
    """The global batch's rows that data-parallel rank ``dp_rank`` of
    ``dp_size`` takes under ``n_micro`` micro-batches, micro-batch by
    micro-batch: micro-batch i is the reference's (rows ``[i B/n, (i+1)
    B/n)``, ``trainer._split_micro``), and the rank takes its contiguous
    share of it, ``i B/n + r B/(n dp)`` on. With ``n_micro`` 1 these are
    :func:`next_batch`'s rows for the rank. Raises unless ``n_micro x
    dp_size`` divides the batch."""
    if global_batch % (n_micro * dp_size):
        raise ValueError(f"a global batch of {global_batch} rows does not split into "
                         f"{n_micro} micro-batches x {dp_size} data-parallel ranks")
    micro, share = global_batch // n_micro, global_batch // (n_micro * dp_size)
    return np.concatenate([np.arange(i * micro + dp_rank * share,
                                     i * micro + (dp_rank + 1) * share)
                           for i in range(n_micro)])


def batches(spec: DataSpec, state: DataState, n: int, **kw):
    for _ in range(n):
        b, state = next_batch(spec, state, **kw)
        yield b, state
