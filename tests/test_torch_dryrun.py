"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.roofline.analysis``) against the JAX package's, on the CPU.

The analytic parts equal the reference's: ``model_flops``,
``time_scan_correction`` and ``micro_batches_of`` for every arch and shape,
``TRAIN_RECIPE``, ``COLLECTIVES``, ``_lerp_stats``, and ``analyze_cell`` on
the reference's own synthetic record (tests/test_sharding_specs.py), whose
terms are the same counts over the H100's constants instead of the TPU's.

The traced part runs in a process of its own (``tests/torch_dryrun_cases.py``:
the fake process group of 256 ranks is per process), at reduced configs on
the single-pod production mesh: the record has the reference's keys, the
argument bytes are the local-shard bytes the sharding specs imply, a train
cell reduces its gradients over the data axis, the MoE decode cell's
expert dispatch issues model-axis collectives at its EP constraint, and at
a one-rank mesh the counted FLOPs equal ``torch.utils.flop_counter`` on the
same step run on plain tensors.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import SHAPE_SPECS as JSHAPES  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
RECORD_KEYS = {"lower_s", "compile_s", "memory_analysis", "cost_analysis", "collectives"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes"}


def _jdryrun():
    """The reference's dry-run module, imported without letting its
    ``XLA_FLAGS`` (512 host devices) leak into processes started later."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd

    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jd


def _synthetic() -> dict:
    """The reference's own roofline record (test_sharding_specs.py)."""
    return dict(
        arch="gemma-7b", shape="train_4k", mesh="single", n_devices=256,
        cost_analysis={"flops": 1e15, "bytes accessed": 1e12},
        collectives={"bytes": {"all-reduce": 1e10, "all-gather": 0,
                               "reduce-scatter": 0, "all-to-all": 0,
                               "collective-permute": 0},
                     "counts": {}},
        memory_analysis={},
    )


def test_analytic_flops_match_reference():
    """model_flops, time_scan_correction and micro_batches_of for every
    arch and each of its shapes, and the shape table itself."""
    assert set(configs.all_archs()) == set(jconfigs.all_archs())
    assert {k: dict(v) for k, v in dryrun.SHAPE_SPECS.items()} == \
        {k: dict(v) for k, v in JSHAPES.items()}
    for arch in configs.all_archs():
        assert configs.get(arch).shapes() == jconfigs.get(arch).shapes()
        for shape in configs.get(arch).shapes():
            assert analysis.model_flops(arch, shape) == janalysis.model_flops(arch, shape)
            assert analysis.time_scan_correction(arch, shape) == \
                janalysis.time_scan_correction(arch, shape)
            assert analysis.micro_batches_of(arch, shape) == \
                janalysis.micro_batches_of(arch, shape)


def test_analyze_cell_matches_reference_on_its_record():
    """The same per-device counts, micro-batches and 6ND ratio; each term
    is its count over the H100 SXM5's peak bf16 rate, HBM rate and NVLink
    rate."""
    got, want = analysis.analyze_cell(_synthetic()), janalysis.analyze_cell(_synthetic())
    for k in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device",
              "micro_batches", "useful_flops_ratio", "model_flops_global", "n_devices"):
        assert got[k] == want[k], k
    assert got["micro_batches"] == 2
    np.testing.assert_allclose(got["t_compute_s"], 2e15 / 989e12)
    np.testing.assert_allclose(got["t_memory_s"], 2e12 / 3.35e12)
    np.testing.assert_allclose(got["t_collective_s"], 2 * 1e10 / 450e9)
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert got["dominant"] == "compute"
    assert analysis.RING == janalysis.RING


def test_recipes_collectives_and_lerp_match_reference():
    """TRAIN_RECIPE and its TrainConfigs, COLLECTIVES (kinds and order),
    and _lerp_stats on the same two records."""
    jd = _jdryrun()
    assert dryrun.TRAIN_RECIPE == jd.TRAIN_RECIPE
    assert dryrun.COLLECTIVES == jd.COLLECTIVES
    for arch in configs.all_archs():
        a, b = dryrun.train_cfg_for(arch), jd.train_cfg_for(arch)
        assert (a.micro_batches, a.opt.name) == (b.micro_batches, b.opt.name)
    kinds = dryrun.COLLECTIVES

    def rec(scale):
        return dict(cost_analysis={"flops": 3e12 * scale, "bytes accessed": 7e9 * scale},
                    collectives={"bytes": {k: (i + 1) * 1e6 * scale for i, k in enumerate(kinds)},
                                 "counts": {k: (i + 2) * scale for i, k in enumerate(kinds)}},
                    memory_analysis={"temp_size_in_bytes": 5})

    for l1, l2, target in ((1, 2, 24), (8, 16, 72)):
        assert dryrun._lerp_stats(rec(1), rec(1.75), l1, l2, target) == \
            jd._lerp_stats(rec(1), rec(1.75), l1, l2, target)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The traced cells, from one run of the worker process."""
    out = tmp_path_factory.mktemp("dryrun") / "cells.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(HERE, "torch_dryrun_cases.py"), str(out)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", ["train", "moe_decode"])
def test_traced_record_has_reference_schema_and_spec_bytes(traced, cell):
    """The reference's record keys, on the 256-rank mesh; the argument
    bytes are exactly the local shards the sharding specs imply; every
    collective kind is one of the reference's."""
    c = traced[cell]
    rec = c["record"]
    assert c["n_devices"] == 256
    assert RECORD_KEYS <= set(rec) and MEMORY_KEYS == set(rec["memory_analysis"])
    assert set(rec["cost_analysis"]) == {"flops", "bytes accessed"}
    assert rec["cost_analysis"]["flops"] > 0 and rec["cost_analysis"]["bytes accessed"] > 0
    assert set(rec["collectives"]["bytes"]) == set(rec["collectives"]["counts"]) == \
        set(dryrun.COLLECTIVES)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == c["spec_bytes"]
    assert 0 < rec["memory_analysis"]["alias_size_in_bytes"] <= \
        rec["memory_analysis"]["argument_size_in_bytes"]


def test_train_cell_reduces_gradients_over_data(traced):
    """The DP gradient reduction: reduce-scatters (ZeRO-1 state) and
    all-reduces over the data axis."""
    axes = traced["train"]["axes"]
    assert axes.get("reduce-scatter/data", 0) > 0 and axes.get("all-reduce/data", 0) > 0


def test_moe_decode_issues_model_axis_collective_at_ep_constraint(traced):
    """The expert buffer's EP layout: apply_moe issues collectives over the
    model axis."""
    in_moe = traced["moe_decode"]["in_moe"]
    assert sum(n for k, n in in_moe.items() if k.endswith("/model")) > 0


def test_one_rank_flops_equal_flop_counter(traced):
    """At one rank the local ops are the step's: the dry run's FLOPs equal
    ``FlopCounterMode`` on the plain train step, and nothing is exchanged."""
    rec = traced["one_rank"]["record"]
    assert rec["cost_analysis"]["flops"] == traced["one_rank"]["flop_counter"] > 0
    assert sum(rec["collectives"]["counts"].values()) == 0
