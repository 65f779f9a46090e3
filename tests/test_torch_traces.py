"""The port's numpy trace generators against the JAX package's, bit for bit:
``repro_torch.data.traces`` is a copy, so every workload must generate the
same accesses from the same spec and seed."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import traces as jtraces  # noqa: E402
from repro_torch.data import traces  # noqa: E402


@pytest.mark.parametrize("workload", sorted(jtraces.workloads()))
def test_trace_generators_match(workload):
    assert traces.workloads() == jtraces.workloads()
    spec = dict(n_logical=777, hp_ratio=16, n_windows=5, accesses_per_window=300, seed=4)
    ref = jtraces.generate(jtraces.TraceSpec(workload, **spec))
    got = traces.generate(traces.TraceSpec(workload, **spec))
    assert ref.dtype == got.dtype and ref.shape == got.shape
    assert np.array_equal(ref, got), workload


def test_paper_constants_match():
    assert traces.PAPER_RSS_GB == jtraces.PAPER_RSS_GB
    assert traces.PAPER_CL == jtraces.PAPER_CL
