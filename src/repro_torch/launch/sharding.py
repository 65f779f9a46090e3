"""Partition specs for params / optimizer state / batches / caches (port of
``repro.launch.sharding``): pure functions on shapes, rule for rule the
reference's, over the port's trees (nested dicts; paths joined with "/").

Policy (DESIGN.md §5):
  * TP over "model": attention heads (iff n_heads % tp == 0, respecting head
    boundaries), KV heads likewise, d_ff, vocab, MoE experts (padded), mamba/
    xLSTM inner dims.
  * DP over ("pod","data"): batch rows, token dims of activations.
  * FSDP: any param leaf bigger than ``fsdp_threshold`` bytes additionally
    shards its largest still-unsharded divisible dim over the DP axes
    (ZeRO-3-style weight sharding).
  * ZeRO-1 (:func:`opt_specs`): optimizer state follows the param spec +
    the same FSDP rule at threshold 0 (always shard something if divisible).
  * Divisibility fallback everywhere: an axis that does not divide a dim is
    dropped (15-head attention replicates, batch=1 decode replicates).

No trainer lays its tensors out by these specs yet: data-parallel training
holds every param and the whole optimizer state on every rank (the
reference's training launcher applies no specs either). The dry run does
(:func:`place`: DTensors over the mesh's ``DeviceMesh``, the reference's
``in_shardings``). :func:`opt_specs`
copies the reference's path handling as it is: its ``^(m|v|f|err)/``
matches the error state's ``err/...`` leaves but never the moments'
``opt/m|v|f/...``, so the leading group axis is left out only for the error
state's stacked leaves.

A leaf is anything with ``shape`` and ``dtype`` (a tensor on the ``meta``
device, ``models.registry.Spec``, a numpy array).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.dist import Dist, NamedSharding, P, placements
from repro_torch.train import tree as tr

FSDP_THRESHOLD = 8 * 1024 * 1024  # bytes; leaves above this get FSDP


def _itemsize(dtype) -> int:
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def _map_paths(fn, tree) -> dict:
    """``fn(path, leaf)`` over every leaf, as a tree of the same structure."""
    paths, values = zip(*((p, fn(p, leaf)) for p, leaf in tr.items(tree)))
    return tr.unflatten(list(paths), list(values))


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
def _base_param_spec(cfg: ArchConfig, path: str, shape: tuple,
                     dist: Dist) -> list:
    """TP spec for the *trailing* dims (callers left-pad for the stacked
    group axis). Returns a list of axis names / None."""
    tp = dist.tp
    n = dist.axis_size(tp)
    heads_ok = cfg.n_heads % n == 0
    kv_ok = cfg.n_kv_heads % n == 0
    r = len(shape)
    spec = [None] * r

    def last(*axes):
        for i, a in enumerate(axes):
            spec[r - len(axes) + i] = a
        return spec

    if re.search(r"embed/tok$", path):
        return last(tp, None)  # (vocab, d)
    if re.search(r"embed/unembed$", path):
        return last(None, tp)  # (d, vocab)
    if re.search(r"embed/pos_(dec|enc)$", path):
        return spec
    if re.search(r"(norm\w*|final_norm)/(scale|bias)$", path):
        return spec
    if re.search(r"attn/wq$", path):
        return last(None, tp if heads_ok else None)
    if re.search(r"attn/w[kv]$", path):
        return last(None, tp if kv_ok else None)
    if re.search(r"attn/wo$", path):
        return last(tp if heads_ok else None, None)
    if re.search(r"attn/bq$", path):
        return last(tp if heads_ok else None)
    if re.search(r"attn/b[kv]$", path):
        return last(tp if kv_ok else None)
    if re.search(r"(xattn)/wq$", path):
        return last(None, tp if heads_ok else None)
    if re.search(r"(xattn)/w[kv]$", path):
        return last(None, tp if kv_ok else None)
    if re.search(r"(xattn)/wo$", path):
        return last(tp if heads_ok else None, None)
    if re.search(r"(xattn)/b[qkv]$", path):
        return spec
    if re.search(r"ffn/(wi_gate|wi_up|wi)$", path):
        return last(None, tp)  # (d, ff)
    if re.search(r"ffn/wo$", path):
        return last(tp, None)  # (ff, d)
    if re.search(r"ffn/router$", path):
        return last(None, tp)  # (d, E_pad)
    if re.search(r"ffn/experts/(wi_gate|wi_up|wo)$", path):
        return last(tp, None, None)  # (E_pad, d, ff) -- EP
    if re.search(r"ffn/shared/(wi_gate|wi_up|wi)$", path):
        return last(None, tp)
    if re.search(r"ffn/shared/wo$", path):
        return last(tp, None)
    if re.search(r"mamba/in_proj$", path):
        return last(None, tp)  # (d, 2*di)
    if re.search(r"mamba/conv_[wb]$", path):
        return last(tp) if len(shape) == 1 else last(None, tp)
    if re.search(r"mamba/x_proj$", path):
        return last(tp, None)  # (di, dr+2ds)
    if re.search(r"mamba/dt_proj$", path):
        return last(None, tp)  # (dr, di)
    if re.search(r"mamba/(dt_bias|D)$", path):
        return last(tp)
    if re.search(r"mamba/A_log$", path):
        return last(tp, None)  # (di, ds)
    if re.search(r"mamba/out_proj$", path):
        return last(tp, None)  # (di, d)
    if re.search(r"(mlstm|slstm)/up_proj$", path):
        return last(None, tp)  # (d, 2*di)
    if re.search(r"mlstm/w[qkv]$", path):
        return last(None, tp, None)  # (H, hd, hd): shard hd_in
    if re.search(r"mlstm/w_if$", path):
        return last(tp, None)  # (di, 2H)
    if re.search(r"mlstm/b_if$", path):
        return spec
    if re.search(r"slstm/w_gates$", path):
        return last(None, None, tp, None)  # (4, H, hd, hd)
    if re.search(r"slstm/r_gates$", path):
        return last(None, tp)  # (4, di)
    if re.search(r"slstm/b_gates$", path):
        return spec
    if re.search(r"(mlstm|slstm)/down_proj$", path):
        return last(tp, None)
    return spec  # default replicate


def _fsdp_extend(spec: list, shape: tuple, dist: Dist, threshold: int | None,
                 itemsize: int = 2) -> list:
    """Shard the largest unsharded divisible dim over the DP axes when the
    leaf exceeds ``threshold`` bytes. ``threshold=None`` disables FSDP
    (inference cells: read-only weights live TP-only)."""
    if threshold is None:
        return spec
    size = int(np.prod(shape)) * itemsize
    if size <= threshold:
        return spec
    dp = dist.dp if isinstance(dist.dp, tuple) else (dist.dp,)
    n_dp = dist.axis_size(dp)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None and shape[i] % n_dp == 0:
            spec[i] = dp
            return spec
    return spec


def param_specs(cfg: ArchConfig, params_shapes, dist: Dist,
                fsdp_threshold: int | None = FSDP_THRESHOLD):
    """Tree of :class:`P` matching ``params_shapes``. Handles the stacked
    group axis."""
    def assign(pstr, leaf):
        shape = tuple(leaf.shape)
        stacked = pstr.startswith("groups/") or "/layers/" in pstr
        core_shape = shape[1:] if stacked else shape
        spec = _base_param_spec(cfg, pstr, core_shape, dist)
        if stacked:
            spec = [None] + spec
        spec = _fsdp_extend(spec, shape, dist, fsdp_threshold, _itemsize(leaf.dtype))
        return dist.fit_spec(shape, P(*spec))

    return _map_paths(assign, params_shapes)


def opt_specs(cfg: ArchConfig, opt_shapes, p_specs, dist: Dist):
    """ZeRO-1: optimizer state follows the param spec, then always tries to
    shard one more dim over DP (threshold 0). Scalars replicate.
    ``p_specs`` is unused, as in the reference."""
    def assign(pstr, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        # find the param this moment mirrors: same trailing path under m/v/f
        m = re.match(r"^(m|v|f|err)/(.*)$", pstr)
        core = m.group(2) if m else pstr
        core = re.sub(r"/(vr|vc|v)$", "", core)
        stacked = core.startswith("groups/")
        core_shape = shape[1:] if stacked else shape
        spec = _base_param_spec(cfg, core, core_shape, dist)
        if stacked:
            spec = [None] + spec
        spec = spec[: len(shape)]  # adafactor factored dims may be shorter
        spec += [None] * (len(shape) - len(spec))
        spec = _fsdp_extend(spec, shape, dist, threshold=0, itemsize=4)
        return dist.fit_spec(shape, P(*spec))

    return _map_paths(assign, opt_shapes)


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------
def batch_specs(batch_shapes, dist: Dist):
    def assign(pstr, leaf):
        shape = tuple(leaf.shape)
        if pstr == "positions":  # (3, B, S)
            return dist.fit_spec(shape, P(None, dist.dp, None))
        return dist.fit_spec(shape, P(dist.dp, *([None] * (len(shape) - 1))))

    return _map_paths(assign, batch_shapes)


def cache_specs(cfg: ArchConfig, cache_shapes, dist: Dist):
    """Decode-cache specs: batch over DP; KV heads over model if divisible,
    else the page-token dim over model; mixer states shard their inner dim."""
    tp = dist.tp
    n = dist.axis_size(tp)
    kv_ok = cfg.n_kv_heads % n == 0

    def assign(pstr, leaf):
        shape = tuple(leaf.shape)
        if pstr in ("btab", "lens"):
            return dist.fit_spec(shape, P(dist.dp))
        if re.search(r"(k|v)_pages$", pstr):  # (G, B, KVH, n_pool, page, hd)
            kv_axis = tp if kv_ok else None
            page_axis = None if kv_ok else tp
            return dist.fit_spec(
                shape, P(None, dist.dp, kv_axis, None, page_axis, None))
        if re.search(r"enc_[kv]$", pstr):  # (G, B, F, KVH, hd)
            kv_axis = tp if kv_ok else None
            hd_axis = None if kv_ok else tp
            return dist.fit_spec(shape, P(None, dist.dp, None, kv_axis, hd_axis))
        if re.search(r"/h$", pstr):  # mamba h (G, B, di, ds)
            return dist.fit_spec(shape, P(None, dist.dp, tp, None))
        if re.search(r"/conv_tail$", pstr):  # (G, B, dc-1, di)
            return dist.fit_spec(shape, P(None, dist.dp, None, tp))
        if re.search(r"/C$", pstr):  # mlstm (G, B, H, hd, hd)
            return dist.fit_spec(shape, P(None, dist.dp, None, tp, None))
        if re.search(r"/(n|m|c)$", pstr):  # (G, B, H, hd) or (G, B, di)
            spec = [None, dist.dp] + [None] * (len(shape) - 2)
            if len(shape) >= 3:
                spec[-1] = tp
            return dist.fit_spec(shape, P(*spec))
        # fallback: batch over DP on dim 1 (stacked) if present
        spec = [None] * len(shape)
        if len(shape) >= 2:
            spec[1] = dist.dp
        return dist.fit_spec(shape, P(*spec))

    return _map_paths(assign, cache_shapes)


def to_shardings(mesh, spec_tree):
    """Each spec of a tree on ``mesh`` (the reference's ``NamedSharding``
    tree); the trainer places nothing by it yet."""
    return tr.map(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# DTensor layouts (the dry run's ``in_shardings``)
# ---------------------------------------------------------------------------
def to_placements(mesh, spec_tree):
    """Each spec of a tree as DTensor placements over ``mesh.device_mesh``
    (``models.dist.placements``: a tuple entry shards its dim over several
    mesh axes, the first the outermost)."""
    return tr.map(lambda s: placements(mesh, s), spec_tree)


def place(tree, spec_tree, mesh, fake_mode):
    """A tree of shapes (``meta`` tensors, ``registry.Spec``) as DTensors
    laid out by the matching spec tree over ``mesh``, each rank's shard a
    fake tensor of ``fake_mode`` on the CPU: nothing is allocated. The
    specs are fitted (every sharded dim divides)."""
    from torch.distributed.tensor import DTensor

    dm = mesh.device_mesh

    def one(leaf, pl):
        local = list(leaf.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                local[p.dim] //= dm.size(i)
        with fake_mode:
            t = torch.empty(local, dtype=leaf.dtype)
        glob = torch.empty(leaf.shape, device="meta")
        return DTensor.from_local(t, dm, pl, run_check=False, shape=glob.shape,
                                  stride=glob.stride())

    return tr.map(one, tree, to_placements(mesh, spec_tree))
