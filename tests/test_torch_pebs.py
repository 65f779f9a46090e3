"""The port's PEBS telemetry against the JAX reference, bit for bit, on the
CPU: ``repro_torch.data.prng.binomial`` against ``jax.random.binomial`` (the
inversion and BTRS loops, in both threefry bit layouts, called eagerly and
inside ``jax.jit`` with a constant ``p``), XLA's float32 log over its whole
range, ``hot_mask_pebs`` and the engine's drivers with ``backend="pebs"``.

The engine's ``pebs`` backend draws in jax's current default layout
(``jax_threefry_partitionable`` True), so the JAX runs here set that flag
for their duration. Three ragged guests of a few hundred pages replay
traces dense enough that the hottest pages' counts take the BTRS branch.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import address_space as jasp  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import gpac as jgpac  # noqa: E402
from repro.core import telemetry as jtel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine, faults, gpac, telemetry  # noqa: E402
from repro_torch.data import prng  # noqa: E402

GRID = np.concatenate([np.arange(201, dtype=np.float32), np.float32([1e4])])
PROBS = (0.01, 0.25, 0.5, 0.7)
GUESTS = (  # (n_logical, cl, gpa_slack, workload, seed)
    (256, 4, 0.5, "redis", 0),
    (320, 8, 0.25, "masim", 1),
    (200, None, 1.0, "hash", 2),
)
HOST = dict(hp_ratio=16, near_fraction=0.4, base_elems=2, cl=6)
N_WINDOWS, APW = 6, 1024


@contextlib.contextmanager
def jax_layout(partitionable: bool):
    old = bool(jax.config.jax_threefry_partitionable)
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def same(a, b, what: str = "") -> None:
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), what


def same_tree(ref: dict, got: dict, what: str = "") -> None:
    assert set(ref) == set(got), (what, sorted(ref), sorted(got))
    for k in ref:
        if isinstance(ref[k], dict):
            same_tree(ref[k], got[k], f"{what}{k}.")
        else:
            same(ref[k], got[k], what + k)


def jstate_np(state) -> dict:
    d = {f.name: np.asarray(getattr(state, f.name))
         for f in dataclasses.fields(state) if f.name != "stats"}
    d["stats"] = {k: np.asarray(v) for k, v in state.stats.items()}
    return d


def jstate(d: dict):
    from repro.core.types import TieredState as JState

    kw = {k: jnp.asarray(v) for k, v in d.items() if k != "stats"}
    kw["stats"] = {k: jnp.asarray(v) for k, v in d["stats"].items()}
    return JState(**kw)


def jchurn_np(cs) -> dict:
    d = {k: np.asarray(getattr(cs, k)) for k in interop.CHURN_FIELDS}
    d["state"] = jstate_np(cs.state)
    return d


# ---- binomial ----------------------------------------------------------------
@pytest.mark.parametrize("partitionable", [True, False])
def test_binomial_matches_jax(partitionable):
    """Counts 0-200 and 1e4 (zero counts, the inversion, BTRS) at four p,
    p >= 0.5 reflected, called eagerly (p traced); and jitted with the
    engine's constant p 0.25 (XLA folds log1p(-q) and the setup's
    constants)."""
    with jax_layout(partitionable):
        jit = jax.jit(lambda key, c: jax.random.binomial(key, c, 0.25))
        for seed in (0, 7, 2**31 - 1):
            jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")
            for p in PROBS:
                got = prng.binomial(k, torch.from_numpy(GRID), p,
                                    partitionable=partitionable)
                same(jax.random.binomial(jk, GRID, p), got, f"seed {seed} p {p}")
                if p == 0.25:
                    same(jit(jk, GRID), got, f"jit seed {seed}")


def test_binomial_edges():
    """NaN, negative and infinite counts, p of 0 and 1 and invalid p,
    per-element p, a broadcast ``shape`` and a float16 result. (An infinite
    count at p 0 or 1 never leaves the reference's BTRS loop: its setup is
    NaN.)"""
    jk, k = jax.random.PRNGKey(3), prng.PRNGKey(3, device="cpu")
    counts = np.float32([np.nan, -1.0, -np.inf, np.inf, 0.0, 3.7, 60.0, 1e4, 2.5e5])
    for p in (0.0, 0.3, 0.5, 1.0, -0.1, np.nan):
        c = counts[np.isfinite(counts) | (p not in (0.0, 1.0))]
        same(jax.random.binomial(jk, c, p), prng.binomial(k, torch.from_numpy(c), p),
             f"p {p}")
    probs = np.float32([0.1, 0.9, 0.5, 0.25, 0.75, 0.01, 0.99, 0.6, 0.4])
    same(jax.random.binomial(jk, counts, probs),
         prng.binomial(k, torch.from_numpy(counts), torch.from_numpy(probs)), "p per element")
    row = np.float32([0.0, 7.0, 45.0, 120.0, 900.0])
    same(jax.random.binomial(jk, row, 0.25, shape=(3, 5), dtype=jnp.float16),
         prng.binomial(k, torch.from_numpy(row), 0.25, shape=(3, 5), dtype=torch.float16),
         "shape, float16")
    with pytest.raises(ValueError, match="does not broadcast"):
        prng.binomial(k, torch.from_numpy(row), 0.25, shape=(3, 4))


def test_btrs_results_depend_on_the_loop_length():
    """The reference's BTRS loop overwrites an accepted proposal with every
    later acceptance and runs until every element has accepted once, the
    inversion elements' placeholders included; so adding inversion elements
    changes BTRS results. The port follows both draws."""
    c = np.full(500, 150, np.float32)
    c2 = np.concatenate([c, np.zeros(50_000, np.float32)])
    jk, k = jax.random.PRNGKey(0), prng.PRNGKey(0, device="cpu")
    st: dict = {}
    alone = prng.binomial(k, torch.from_numpy(c), 0.25)
    mixed = prng.binomial(k, torch.from_numpy(c2), 0.25, stats=st)
    same(jax.random.binomial(jk, c, 0.25), alone, "alone")
    same(jax.random.binomial(jk, c2, 0.25), mixed, "mixed")
    assert (alone != mixed[:500]).sum() > 0
    assert st["inversion_elements"] == 50_000 and st["btrs_elements"] == 500
    assert st["btrs_iters"] >= 1 and st["inversion_iters"] >= 1
    assert st["placeholder_proposals"] >= 50_000


def test_xla_log_over_the_whole_range():
    """XLA's float32 log at +-0, subnormals (flushed: -inf), the least
    normal, values above 1 up to the largest float, inf, negatives and NaN
    (NaN where XLA's is; its payload is not held)."""
    x = np.float32([0.0, -0.0, 1e-45, 3e-42, 1.1754942e-38, 1.1754944e-38, 2e-38, 1e-20,
                    0.5, 0.7071067, 0.99999994, 1.0, 1.0000001, 1.5, 2.0, 10.0, 1234.5,
                    3e9, 1.7e38, 3.4028235e38, np.inf, -1.0, -np.inf, np.nan])
    rng = np.random.default_rng(0)
    more = rng.uniform(0.0, 200.0, 20_000).astype(np.float32)
    for z in (x, more, (more * 1e-38).astype(np.float32)):
        ref = np.asarray(jax.jit(jnp.log)(z))
        got = prng._log_x(torch.from_numpy(z).to(torch.float64)).to(torch.float32).numpy()
        nan = np.isnan(ref)
        assert np.array_equal(nan, np.isnan(got))
        same(ref[~nan], got[~nan])


# ---- the PEBS backend --------------------------------------------------------
class _Ref:
    """The fleet, its starting state after two ipt windows (so that counts and
    histories are set) and its traces."""

    def __init__(self):
        jg = [jengine.GuestSpec(n, cl=cl, gpa_slack=s, workload=w, seed=sd)
              for n, cl, s, w, sd in GUESTS]
        g = [engine.GuestSpec(n, cl=cl, gpa_slack=s, workload=w, seed=sd)
             for n, cl, s, w, sd in GUESTS]
        self.jspec, st = jengine.build(jg, jengine.HostSpec(**HOST))
        self.spec, _ = engine.build(g, engine.HostSpec(**HOST), device="cpu")
        cfg = self.jspec.cfg
        fill = (np.arange(cfg.n_logical * cfg.base_elems, dtype=np.float32)
                .reshape(cfg.n_logical, cfg.base_elems) + 0.5)
        st = jax.jit(jasp.write_logical, static_argnums=0)(
            cfg, st, np.arange(cfg.n_logical, dtype=np.int32), fill)
        self.s0 = jstate_np(st)
        self.traces = jengine.guest_traces(self.jspec, N_WINDOWS, APW)
        acc = self.jspec.localize(jnp.asarray(self.traces[:, 0])).reshape(-1)
        self.counted = jstate_np(  # one window's accesses recorded, epoch 0
            jax.jit(jasp.record_accesses, static_argnums=0)(cfg, st, acc))

    def port_state(self, d=None):
        return interop.state_from_numpy(self.s0 if d is None else d, device="cpu")


@pytest.fixture(scope="module")
def ref():
    with jax_layout(True):
        yield _Ref()


def test_hot_mask_pebs(ref):
    """The default key (fold_in of the epoch), an explicit key, three rates
    and two thresholds; through ``hot_mask`` and a ragged GPAC pass."""
    cfg, jcfg = ref.spec.cfg, ref.jspec.cfg
    counts = ref.counted["guest_counts"]
    assert (counts * 0.25 > 10).sum() > 0 and (counts > 0).sum() > 50  # both branches
    with jax_layout(True):
        for epoch in (0, 5):
            d = dict(ref.counted, epoch=np.int32(epoch))
            same(jtel.hot_mask(jcfg, jstate(d), "pebs"),
                 telemetry.hot_mask(cfg, ref.port_state(d), "pebs"), f"epoch {epoch}")
        jk, k = jax.random.PRNGKey(11), prng.PRNGKey(11, device="cpu")
        for rate in (0.1, 0.25, 0.6):
            for thr in (1, 8):
                jc, c = (dataclasses.replace(x, hot_threshold=thr) for x in (jcfg, cfg))
                same(jtel.hot_mask_pebs(jc, jstate(ref.counted), key=jk, rate=rate),
                     telemetry.hot_mask_pebs(c, ref.port_state(ref.counted), key=k,
                                             rate=rate), f"rate {rate} thr {thr}")
        jst = jax.jit(jgpac.gpac_maintenance_ragged, static_argnums=(0, 2, 3))(
            ref.jspec, jstate(ref.counted), "pebs", 3)
        st = gpac.gpac_maintenance_ragged(ref.spec, ref.port_state(ref.counted), "pebs", 3)
    same_tree(jstate_np(jst), interop.state_to_numpy(st))
    assert int(np.asarray(jst.stats["consolidation_calls"])) > 0


def test_run_pebs_matches_reference(ref):
    """run over an ArrayTrace and a SynthTrace, and run_series."""
    policy = "memtierd"
    kw = dict(policy=policy, backend="pebs", max_batches=3, budget=8, windows_per_step=2)
    with jax_layout(True):
        for src, psrc in ((ref.traces, ref.traces),
                          (jengine.SynthTrace(N_WINDOWS, APW),
                           engine.SynthTrace(N_WINDOWS, APW, partitionable=True))):
            jst, jser = jengine.run(ref.jspec, jstate(ref.s0), src, **kw)
            st, ser = engine.run(ref.spec, ref.port_state(), psrc, device="cpu", **kw)
            same_tree(jstate_np(jst), interop.state_to_numpy(st), f"{policy} ")
            same_tree(jser, ser, f"{policy} series.")
        jst, jser = jengine.run_series(ref.jspec, jstate(ref.s0), ref.traces, **kw)
    st, ser = engine.run_series(ref.spec, ref.port_state(), ref.traces, device="cpu", **kw)
    same_tree(jstate_np(jst), interop.state_to_numpy(st))
    same_tree(jser, ser)


def test_run_reference_pebs(ref):
    kw = dict(policy="autonuma", backend="pebs", max_batches=3, budget=8)
    with jax_layout(True):
        jst, jser = jengine.run_reference(ref.jspec, jstate(ref.s0), ref.traces[:, :3], **kw)
    st, ser = engine.run_reference(ref.spec, ref.port_state(), ref.traces[:, :3],
                                   device="cpu", **kw)
    same_tree(jstate_np(jst), interop.state_to_numpy(st))
    same_tree(jser, ser)


def test_run_churn_and_step_churn_pebs(ref):
    """run_churn under a crash, a shrink and a dropout, over an ArrayTrace
    and a SynthTrace; a step_churn loop over the same windows."""
    events = [("crash", 1, 2), ("shrink", 2, 3), ("dropout", 3), ("restart", 4, 2)]
    jsched, sched = jfaults.FaultSchedule(3), faults.FaultSchedule(3)
    for kind, *args in events:
        getattr(jsched, kind)(*args)
        getattr(sched, kind)(*args)
    kw = dict(backend="pebs", max_batches=3, budget=8)
    refs = []
    with jax_layout(True):
        for src, psrc in ((ref.traces, ref.traces),
                          (jengine.SynthTrace(N_WINDOWS, APW),
                           engine.SynthTrace(N_WINDOWS, APW, partitionable=True))):
            jcs, jser = jengine.run_churn(ref.jspec, jengine.init_churn(ref.jspec, jstate(ref.s0)),
                                          src, faults=jsched, windows_per_step=3, **kw)
            cs, ser = engine.run_churn(
                ref.spec, engine.init_churn(ref.spec, ref.port_state(), device="cpu"), psrc,
                faults=sched, windows_per_step=3, device="cpu", **kw)
            same_tree(jchurn_np(jcs), interop.churn_to_numpy(cs))
            same_tree(jser, ser)
            refs.append((jchurn_np(jcs), jser))
    cs = engine.init_churn(ref.spec, ref.port_state(), device="cpu")
    rows = sched.tables(N_WINDOWS, ref.spec.cfg.n_near)
    outs = []
    for w in range(N_WINDOWS):
        row = dict(crash=rows.crash[w], restart=rows.restart[w],
                   near_cap=int(rows.near_cap[w]), drop=bool(rows.drop[w]))
        cs, out = engine.step(ref.spec, cs, torch.from_numpy(ref.traces[:, w]),
                              faults_row=row, **kw)
        outs.append(out)
    jcs, jser = refs[0]  # the reference's run_churn does not depend on its chunking
    same_tree(jcs, interop.churn_to_numpy(cs))
    same_tree(jser, {k: np.stack([o[k] for o in outs]) for k in outs[0]})
