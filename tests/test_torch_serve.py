"""The port's serving path against the JAX package, on the CPU: the
scheduler, the one-daemon GPAC pass (``select_batches``,
``consolidate_batches`` with ``hp_range``, ``gpac_maintenance`` with
``allow`` and ``hp_range``) and ``Engine.run`` end to end, on the reduced
qwen2 in float32 with 8-token pages (the fixture of
``tests/test_serve_engine.py``), from the same weights.

Placement states, token streams and ``stats()`` must be identical. The
engine's telemetry quantises float32 attention mass into counts of 0.02;
the end-to-end test also shows that no mass lay within the two packages'
float32 difference of a quantum boundary, so that equal counts are not luck.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import address_space as jasp  # noqa: E402
from repro.core import consolidator as jcons  # noqa: E402
from repro.core import filter as jfilter  # noqa: E402
from repro.core import gpac as jgpac  # noqa: E402
from repro.core import telemetry as jtel  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.core import consolidator, filter as pfilter, gpac, types  # noqa: E402
from repro_torch.core import engine as core_engine  # noqa: E402
from repro_torch.kernels import registry as kregistry  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import engine, scheduler  # noqa: E402

QUANTUM = 0.02  # Engine._record_mass


def jax_state_to_numpy(state) -> dict:
    d = {f.name: np.asarray(getattr(state, f.name))
         for f in dataclasses.fields(state) if f.name != "stats"}
    d["stats"] = {k: np.asarray(v) for k, v in state.stats.items()}
    return d


def assert_same_state(want: dict, got: dict) -> None:
    for k in want:
        if k == "stats":
            for s in want[k]:
                assert want[k][s].dtype == got[k][s].dtype and np.array_equal(
                    want[k][s], got[k][s]), f"stats.{s}"
        else:
            assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
            assert np.array_equal(want[k], got[k]), k


# --------------------------------------------------------------------------
# the scheduler
# --------------------------------------------------------------------------
def test_scheduler_matches_reference():
    reqs = lambda mod: [mod.Request(rid=i, prompt=list(range(5 + i)), max_new=3)  # noqa: E731
                        for i in range(5)]
    trace = []
    for mod in (jsched, scheduler):
        s = mod.Scheduler(mod.SchedulerConfig(max_seqs=2, reserve_tokens=2, maintenance_every=3))
        rs = reqs(mod)
        for r in rs:
            s.submit(r)
        log = [[r.rid for r in s.admit(16)]]
        s.finish(rs[0])
        log += [[r.rid for r in s.admit(16)], [s.should_maintain() for _ in range(7)],
                sorted(s.running), s.free_slots, s.has_work]
        with pytest.raises(ValueError, match="capacity"):
            s.finish(rs[1])
            s.admit(8)
        trace.append(log)
    assert trace[0] == trace[1]


# --------------------------------------------------------------------------
# one daemon's GPAC pass
# --------------------------------------------------------------------------
SEGS, PPS, SEG_HP, HP = 3, 24, 18, 2  # the engine's layout: one segment per sequence


@pytest.fixture(scope="module")
def daemon_state():
    """The serving engine's placement geometry (3 sequences of 24 logical
    pages, 2 pages per block), identity-mapped per segment, with two windows
    of weighted accesses: (JAX cfg, port cfg, JAX state)."""
    kw = dict(n_logical=SEGS * PPS, hp_ratio=HP, n_gpa_hp=SEGS * SEG_HP, n_near=21,
              base_elems=2, cl=2, ipt_min_hits=1)
    jcfg, cfg = jtypes.GpacConfig(**kw), types.GpacConfig(**kw)
    gpt = np.concatenate([b * SEG_HP * HP + np.arange(PPS) for b in range(SEGS)])
    rmap = np.full(jcfg.n_gpa, -1)
    rmap[gpt] = np.arange(jcfg.n_logical)
    st = dataclasses.replace(jtypes.init_state(jcfg), gpt=jnp.asarray(gpt, jnp.int32),
                             rmap=jnp.asarray(rmap, jnp.int32))
    r = np.random.default_rng(21)
    for _ in range(2):
        ids = r.choice(jcfg.n_logical, size=30, replace=False).astype(np.int32)
        cnt = r.integers(1, 40, size=30).astype(np.int32)
        st = jasp.record_accesses(jcfg, st, jnp.asarray(ids), jnp.asarray(cnt))
        st = jtel.end_window(jcfg, st)
    ids = r.choice(jcfg.n_logical, size=25, replace=False).astype(np.int32)
    st = jasp.record_accesses(jcfg, st, jnp.asarray(ids), jnp.asarray(np.full(25, 3, np.int32)))
    return jcfg, cfg, st


def _segment(b):
    allow = (np.arange(SEGS * PPS) >= b * PPS) & (np.arange(SEGS * PPS) < (b + 1) * PPS)
    return allow, (b * SEG_HP, (b + 1) * SEG_HP)


@pytest.mark.parametrize("b,cl", [(None, None), (1, 2)])
def test_select_and_consolidate_batches_match_reference(daemon_state, b, cl):
    jcfg, cfg, jst = daemon_state
    allow, hp_range = _segment(b) if b is not None else (None, None)
    hot = jtel.hot_mask(jcfg, jst, "ipt")
    jb, jc = jfilter.select_batches(jcfg, jst, hot, 3, cl,
                                    None if allow is None else jnp.asarray(allow))
    st = interop.state_from_numpy(jax_state_to_numpy(jst), device="cpu")
    pb, pc = pfilter.select_batches(cfg, st, torch.from_numpy(np.array(hot)), 3, cl,
                                    None if allow is None else torch.from_numpy(allow))
    assert np.array_equal(np.asarray(jb), pb.numpy()) and pb.dtype == torch.int32
    assert np.array_equal(np.asarray(jc), pc.numpy()) and pc.dtype == torch.int32
    assert (pc > 0).any()
    want = jcons.consolidate_batches(jcfg, jst, jb, hp_range)
    got = consolidator.consolidate_batches(cfg, st, pb, hp_range)
    assert_same_state(jax_state_to_numpy(want), interop.state_to_numpy(got))
    assert int(got.stats["consolidated_pages"]) > 0


@pytest.mark.parametrize("b", [0, 2])
def test_gpac_maintenance_matches_reference(daemon_state, b):
    jcfg, cfg, jst = daemon_state
    allow, hp_range = _segment(b)
    want = jgpac.gpac_maintenance(jcfg, jst, "ipt", 2, allow=jnp.asarray(allow),
                                  hp_range=hp_range)
    st = interop.state_from_numpy(jax_state_to_numpy(jst), device="cpu")
    got = gpac.gpac_maintenance(cfg, st, "ipt", 2, allow=torch.from_numpy(allow),
                                hp_range=hp_range)
    assert_same_state(jax_state_to_numpy(want), interop.state_to_numpy(got))


# --------------------------------------------------------------------------
# the engine end to end
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.reduced("qwen2-0.5b").replace(dtype=jnp.float32, page_size=8)
    cfg = configs.reduced("qwen2-0.5b").replace(dtype=torch.float32, page_size=8)
    jmodel = jregistry.build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(7))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, registry.build(cfg), params


def make_engine(mod, model, params, use_gpac=True, **kw):
    """tests/test_serve_engine.py's engine from package ``mod``, with 4
    pages per block, the launcher's: then GPAC finds scattered hot pages in
    these runs (with 2, every live block is dense)."""
    ecfg = mod.EngineConfig(
        max_seqs=3, max_seq_len=64, pages_per_block=4, near_fraction=0.4,
        sched=mod.SchedulerConfig(max_seqs=3, maintenance_every=4, use_gpac=use_gpac,
                                  reserve_tokens=8))
    return mod.Engine(model, params, ecfg, **kw)


def prompts(mod, vocab, n, length, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, length).tolist(), max_new=10)
            for i in range(n)]


def serve(eng, reqs):
    """Run every request; returns the token streams and the masses that
    ``_record_mass`` was handed, step by step."""
    masses = []
    record = eng._record_mass

    def spy(mass, *a, **k):
        masses.append(np.array(mass))
        return record(mass, *a, **k)

    eng._record_mass = spy
    for r in reqs:
        eng.sched.submit(r)
    eng.run(max_steps=200)
    return [r.out for r in reqs], masses


@pytest.fixture(scope="module")
def engine_runs(models):
    jmodel, jparams, model, params = models
    runs = {}
    for name, mod, eng in (
            ("jax", jengine, make_engine(jengine, jmodel, jparams)),
            ("port", engine, make_engine(engine, model, params, device="cpu"))):
        mod_sched = jsched if mod is jengine else scheduler
        toks, masses = serve(eng, prompts(mod_sched, model.cfg.vocab, 5, 40, seed=2))
        st = eng.pstate
        runs[name] = dict(tokens=toks, masses=masses, stats=eng.stats(),
                          state=(jax_state_to_numpy(st) if mod is jengine
                                 else interop.state_to_numpy(st)),
                          btab=np.asarray(eng._model_btab_from_gpt()))
    return runs


def test_engine_run_matches_reference(engine_runs):
    want, got = engine_runs["jax"], engine_runs["port"]
    assert got["tokens"] == want["tokens"]
    assert all(len(t) == 10 for t in got["tokens"])
    assert got["stats"] == want["stats"]
    assert want["stats"]["consolidated_pages"] > 0 and want["stats"]["promoted_blocks"] > 0
    assert_same_state(want["state"], got["state"])
    assert np.array_equal(got["btab"], want["btab"])
    # equal counts are not luck: the float32 masses differ by less than
    # their least distance from a quantum boundary
    x_got = np.stack(got["masses"]) / QUANTUM
    x_want = np.stack(want["masses"]) / QUANTUM
    err = np.abs(x_got - x_want).max()
    live = x_want >= 0.5  # below 1 the count is 0 on both sides of any error
    margin = np.abs(x_want[live] - np.round(x_want[live])).min()
    assert err < 1e-4 < margin, (err, margin)


def test_port_gpac_on_and_off_give_the_same_tokens(models, engine_runs):
    _, _, model, params = models
    eng = make_engine(engine, model, params, use_gpac=False, device="cpu")
    toks, _ = serve(eng, prompts(scheduler, model.cfg.vocab, 5, 40, seed=2))
    assert toks == engine_runs["port"]["tokens"]
    assert eng.stats()["consolidated_pages"] == 0


def test_consolidation_with_skewed_mass_keeps_the_logical_kv(models):
    """Paper-shaped skewed mass (one hot page per block), forced maintenance:
    pages move, and the model's logical KV view stays bit for bit."""
    _, _, model, params = models
    eng = make_engine(engine, model, params, device="cpu")
    for r in prompts(scheduler, model.cfg.vocab, 3, 40, seed=2):
        eng.sched.submit(r)
    for _ in range(3):
        eng.step()

    def logical_k():
        k = eng.cache["layers"]["layer0"]["k_pages"][0]
        btab = eng.cache["btab"].long()
        return k[torch.arange(3)[:, None], :, btab].clone()

    before = logical_k()
    mass = np.zeros((eng.ecfg.max_seqs, eng.n_pool), np.float32)
    mass[:, ::eng.pcfg.hp_ratio] = 1.0
    for _ in range(3):
        eng._record_mass(mass)
        eng.maintenance()
    assert eng.stats()["consolidated_pages"] > 0
    assert torch.equal(before, logical_k())
    gpt = eng.pstate.gpt.numpy()
    assert len(np.unique(gpt)) == eng.pcfg.n_logical
    btab = eng._model_btab_from_gpt()
    assert (btab >= 0).all() and (btab < eng.n_phys).all()


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def test_entry_points_refuse_cpu_fallback(models, monkeypatch):
    _, _, model, params = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(engine, model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 16)
    fleet, _ = core_engine.build([core_engine.GuestSpec(64)], core_engine.HostSpec(hp_ratio=16, cl=8),
                                 device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.TieringService(fleet)


def test_launch_serve_runs_on_the_cpu(capsys):
    before = kregistry.launch_counts()
    stats = launch_serve.main(["--device", "cpu", "--reduced", "--requests", "3",
                               "--max-new", "5", "--prompt-len", "30"])
    out = capsys.readouterr().out
    assert "[serve] qwen2-0.5b-reduced: 3 requests, 15 tokens" in out and "on cpu" in out
    assert set(stats) >= {"hit_rate", "consolidated_pages", "near_capacity_used"}
    assert kregistry.launch_counts() == before  # CPU tensors launch nothing
