"""Atomic, resumable checkpoints of trees of tensors (port of
``repro.train.checkpoint``).

Layout, the reference's:

    <dir>/step_000000123/
        manifest.json      # step, extra, and each leaf's file, shape, dtype
        <leaf-path>.npy    # one file per leaf, "/" in the path as "__"
    <dir>/LATEST           # the newest step directory's name

The step directory is written under ``.tmp`` and published with
``os.replace``, then ``LATEST`` likewise: a crash mid-save leaves the last
checkpoint and its pointer whole. A bfloat16 leaf is stored as its uint16
bit pattern with ``"bfloat16"`` in the manifest (numpy has no bfloat16 and
the port needs no ``ml_dtypes``), so a round trip is exact for every dtype.

``save(..., background=True)`` copies every leaf to host memory before it
returns and writes the files on a thread: the optimizer updates tensors in
place, so a thread reading them on the device would race it.

Under data parallelism every rank holds the whole state: only the
coordinator saves (``fault.Supervisor``), and any number of ranks, or one
process, restores the same files.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.train import tree as tr


def _host(leaf) -> tuple:
    """(a host copy of a leaf as numpy, its dtype's name); a tensor is
    copied even on the CPU."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         background: bool = False):
    """Snapshot ``tree`` (params, train state, data step) at ``step``;
    returns the writing thread when ``background``, else None."""
    leaves = {path: _host(leaf) for path, leaf in tr.items(tree)}

    def write():
        step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
        tmp = step_dir + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for key, (arr, dtype) in leaves.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.replace(tmp, step_dir)  # atomic publish of the step directory
        latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(step_dir))
        os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))  # atomic

    os.makedirs(ckpt_dir, exist_ok=True)
    if background:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(ckpt_dir: str) -> int | None:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip().split("_")[-1])


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, like_tree, step: int | None = None, device=None) -> tuple:
    """(the checkpoint in ``like_tree``'s structure, its manifest). Each
    leaf must have the like leaf's shape (else ValueError), takes its dtype
    and lands on ``device``, or where the like leaf lies."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    paths, values = [], []
    for key, like in tr.items(like_tree):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _load(os.path.join(step_dir, meta["file"]), meta["dtype"])
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != expected "
                             f"{tuple(like.shape)}")
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        dtype = like.dtype if isinstance(like, torch.Tensor) else t.dtype
        paths.append(key)
        values.append(t.to(device=dev, dtype=dtype))
    return tr.unflatten(paths, values), manifest


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Keep only the newest ``keep`` step directories."""
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
