"""The port's host-partitioned near tier (``engine.run_sharded(
host_sharded=True)``, ``tiering``'s sharded ticks, the sharded
``compressed`` tick, ``consolidator.consolidate_rounds_local``) held to the
JAX package.

The scenarios of ``torch_sharding_cases`` run at 1 rank in this process and
at 2 and 4 ranks (one rank with no guest and an empty host range) in the
one 4-rank job of the test run, started by ``multihost.launch``; every
rank's result must equal
the JAX package's ``run`` bit for bit (its one-device ``run_sharded``,
bytes per site included, for ``host_memtierd``), with one exchange per
stride group and one rebuild per chunk. The arbitration's edge layouts (an
n_near no rank count divides, a range with no near block, empty and one-block
ranges, cross-range score ties) are emulated in one process, as
``tests/test_host_partition_edges.py`` does for the reference, and held to
the replicated tick.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import test_host_partition_edges as edges  # noqa: E402
import torch_sharding_cases as C  # noqa: E402
from test_torch_sharding import (  # noqa: E402
    check_case, jax_tree, ranked_results)

from repro_torch import interop  # noqa: E402
from repro_torch.core import sharding, tiering  # noqa: E402
from repro_torch.core import tiers as ptiers  # noqa: E402
from repro_torch.core.types import GpacConfig, allocated_hp_mask  # noqa: E402


@pytest.fixture(scope="module")
def j():
    import jax

    from repro.core import engine, faults, sharding as jsharding, tiering as jtiering, tiers

    return types.SimpleNamespace(jax=jax, engine=engine, faults=faults,
                                 sharding=jsharding, tiering=jtiering, tiers=tiers)


@pytest.fixture(scope="module")
def mesh1():
    mesh = sharding.guest_mesh(1, device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranked(tmp_path_factory, j):
    return ranked_results(tmp_path_factory, j)[1]["host"]


def n_groups(name: str) -> tuple[int, int]:
    """(exchanges, rebuilds) a scenario must issue."""
    c = C.case(name)
    wps = c["wps"] or C.N_WINDOWS
    return C.N_WINDOWS // c["stride"], C.N_WINDOWS // wps


@pytest.mark.parametrize("name", C.GROUPS["host"])
def test_host_sharded_run_matches_reference(j, mesh1, ranked, name):
    exchanges, rebuilds = n_groups(name)
    check_case(j, mesh1, ranked, name,
               {"host_exchange": exchanges, "host_chunk_exit": rebuilds})


def test_host_tables_match_reference(j):
    """``host_partition``, ``host_tables`` and both byte counts at every
    mesh size, no devices needed."""
    from repro_torch.core import engine

    for c in (C.case("host_memtierd"), C.case("host_compressed_synth_stride2")):
        spec, _ = C.build(engine, c, tiers_mod=ptiers, device="cpu")
        jspec, _ = C.build(j.engine, c, tiers_mod=j.tiers)
        assert sharding.host_state_bytes(spec.cfg) == j.sharding.host_state_bytes(jspec.cfg)
        for n in (1, 2, 3, 4):
            part, tables = sharding.host_tables(spec, n)
            jpart, jtables = j.sharding.host_tables(jspec, n)
            assert dataclasses_equal(part, jpart)
            np.testing.assert_array_equal(part.hp_ids(), jpart.hp_ids())
            assert set(tables) == set(jtables)
            for k in tables:
                np.testing.assert_array_equal(tables[k], jtables[k])
                assert tables[k].dtype == jtables[k].dtype
            assert (sharding.host_state_bytes_sharded(spec.cfg, part)
                    == j.sharding.host_state_bytes_sharded(jspec.cfg, jpart))


def dataclasses_equal(a, b) -> bool:
    return (a.hp_lo, a.hp_hi, a.h_loc) == (tuple(b.hp_lo), tuple(b.hp_hi), b.h_loc)


# --------------------------------------------------------------------------
# the arbitration over explicit layouts, one process
# --------------------------------------------------------------------------
def port_state(jstate):
    return interop.state_from_numpy(jax_tree(jstate), device="cpu")


def port_cfg(jcfg) -> GpacConfig:
    return GpacConfig(n_logical=jcfg.n_logical, hp_ratio=jcfg.hp_ratio,
                      n_gpa_hp=jcfg.n_gpa_hp, n_near=jcfg.n_near,
                      base_elems=jcfg.base_elems, cl=jcfg.cl)


def emulate(cfg, state, policy, bounds, budget, tiers=None):
    """The port's sharded tick over an explicit range layout, the exchange
    emulated by stacking the per-range nominations and summing the sums;
    every range must arbitrate to the same replicated stats."""
    prepare, apply = tiering.sharded_tick_fns(policy)
    kw = {} if tiers is None else dict(tiers=tiers)
    h_loc = max(1, max(hi - lo for lo, hi in bounds))
    alloc = allocated_hp_mask(cfg, state)
    Ls, payloads = [], []
    for lo, hi in bounds:
        ids = torch.full((h_loc,), -1, dtype=torch.int32)
        ids[: hi - lo] = torch.arange(lo, hi, dtype=torch.int32)
        v, t = ids >= 0, ids.clamp(min=0).long()
        L = dict(hp_ids=ids, hp_lo=lo, hp_hi=hi,
                 bt=torch.where(v, state.block_table[t], cfg.n_gpa_hp),
                 hc=torch.where(v, state.host_counts[t], 0),
                 hh=torch.where(v, state.host_hist[t], 0).to(torch.uint8),
                 lt=torch.where(v, state.last_touch_epoch[t], 0),
                 alloc=torch.where(v, alloc[t], False))
        Ls.append(L)
        payloads.append(prepare(cfg, L, budget, **kw))
    merged = dict(
        cands={n: {f: torch.stack([p["cands"][n][f] for p in payloads]) for f in c}
               for n, c in payloads[0]["cands"].items()},
        sums={k: sum(p["sums"][k] for p in payloads) for k in payloads[0]["sums"]})
    bt = state.block_table.clone()
    deltas = []
    for L, (lo, hi) in zip(Ls, bounds):
        bt_new, delta, _ = apply(cfg, L, merged, budget, **kw)
        bt[lo:hi] = bt_new[: hi - lo]
        deltas.append({k: int(x) for k, x in delta.items()})
    assert all(d == deltas[0] for d in deltas), deltas
    return bt.numpy(), deltas[0]


def check_layout(jcfg, jstate, policy, bounds, budget=8):
    """The port's emulation = the port's replicated tick (held to the
    reference's replicated tick by ``test_torch_engine.py`` and
    ``test_torch_tiers.py``)."""
    cfg = port_cfg(jcfg)
    state = port_state(jstate)
    bt, delta = emulate(cfg, state, policy, bounds, budget)
    ref = tiering.tick(cfg, port_state(jstate), policy, budget=budget)
    np.testing.assert_array_equal(bt, ref.block_table.numpy(), err_msg=f"{policy} {bounds}")
    assert delta == {k: int(ref.stats[k]) - int(state.stats[k]) for k in delta}


@pytest.mark.parametrize("policy", edges.POLICIES)
def test_arbitration_edge_layouts(policy):
    """n_near 7 (no rank count of 2-4 divides it), a range with no near
    block, empty and one-block ranges, cross-range and mass score ties."""
    import dataclasses

    import jax.numpy as jnp

    jcfg = edges.make_cfg()
    rng = np.random.default_rng(edges.POLICIES.index(policy))

    def check(jstate, bounds, budget=8):
        check_layout(jcfg, jstate, policy, bounds, budget)

    for parts in (1, 2, 3, 4):
        check(edges.random_state(jcfg, rng), edges.even_bounds(jcfg.n_gpa_hp, parts))
    ident = edges.random_state(jcfg, rng, scramble=False)
    check(ident, [(0, jcfg.n_near), (jcfg.n_near, jcfg.n_gpa_hp)])
    check(edges.random_state(jcfg, rng),
          [(0, 0), (0, 1), (1, jcfg.n_gpa_hp), (jcfg.n_gpa_hp, jcfg.n_gpa_hp)])
    for budget in (1, jcfg.n_gpa_hp + 50):
        check(edges.random_state(jcfg, rng), edges.even_bounds(jcfg.n_gpa_hp, 3), budget)
    for fill in (0, 3):
        s = edges.random_state(jcfg, rng)
        s = dataclasses.replace(
            s, host_counts=jnp.full((jcfg.n_gpa_hp,), fill, jnp.int32),
            host_hist=jnp.zeros((jcfg.n_gpa_hp,), jnp.uint8),
            last_touch_epoch=jnp.zeros((jcfg.n_gpa_hp,), jnp.int32))
        check(s, edges.even_bounds(jcfg.n_gpa_hp, 4))
    # two equal hot scores in different ranges compete for one near slot
    tcfg = edges.make_cfg(n_gpa_hp=12, n_near=4)
    counts = np.zeros(12, np.int32)
    counts[[5, 9]] = 3
    s = dataclasses.replace(edges.init_state(tcfg), host_counts=jnp.asarray(counts))
    check_layout(tcfg, s, policy, [(0, 4), (4, 8), (8, 12)], budget=1)


def test_compressed_tick_edge_layouts(j):
    """The sharded ``compressed`` tick on three tiers over uneven, empty and
    one-block ranges = the replicated ``compressed`` tick of both
    packages; the builtin ticks refuse a 3-tier vector."""
    jcfg = edges.make_cfg(n_gpa_hp=23, n_near=4)
    cfg = port_cfg(jcfg)
    specs = ptiers.compressed_specs(*C.TIERS)
    tv = ptiers.resolve(specs, n_slots=cfg.n_slots, total_need=16)
    jtv = j.tiers.resolve(j.tiers.compressed_specs(*C.TIERS), n_slots=cfg.n_slots,
                          total_need=16)
    assert tv.boundaries == jtv.boundaries
    rng = np.random.default_rng(5)
    for bounds in (edges.even_bounds(23, 3), [(0, 0), (0, 1), (1, 23), (23, 23)]):
        jstate = edges.random_state(jcfg, rng)
        state = port_state(jstate)
        bt, delta = emulate(cfg, state, "compressed", bounds, 6, tiers=tv)
        ref = tiering.tick(cfg, port_state(jstate), "compressed", budget=6, tiers=tv)
        jref = j.tiering.tick(jcfg, jstate, "compressed", budget=6, tiers=jtv)
        np.testing.assert_array_equal(bt, ref.block_table.numpy())
        np.testing.assert_array_equal(bt, np.asarray(jref.block_table))
        assert delta == {k: int(jref.stats[k]) - int(jstate.stats[k]) for k in delta}
    with pytest.raises(ValueError, match="2-tier"):
        emulate(cfg, port_state(jstate), "memtierd", [(0, 23)], 6, tiers=tv)


def test_host_sharded_validation(mesh1):
    """The host-partitioned run refuses what it cannot run, as the reference
    does: a collector without a host-sharded form, a policy without a
    sharded tick, a stride that does not tile the run or the chunk, a state
    off an arbitration boundary."""
    from repro_torch.core import engine

    c = C.case("host_memtierd")

    def go(**kw):
        spec, state = C.build(engine, c, tiers_mod=ptiers, device="cpu")
        args = dict(mesh=mesh1, device="cpu")
        args.update(kw)
        traces = args.pop("traces", engine.guest_traces(spec, C.N_WINDOWS, C.K))
        if "epoch" in args:
            state.epoch = torch.tensor(args.pop("epoch"), dtype=torch.int32)
        return engine.run_sharded(spec, state, traces, **args)

    engine.register_collector("_test_no_host_form", lambda spec, state, window: {})
    try:
        with pytest.raises(ValueError, match="host-sharded"):
            go(collect=("hits", "_test_no_host_form"))
    finally:
        engine._COLLECTORS.pop("_test_no_host_form")
    with pytest.raises(ValueError, match="host-partitioned tick"):
        go(policy="hybridtier")
    with pytest.raises(ValueError, match="n_windows"):
        go(arbitration_stride=4)
    with pytest.raises(ValueError, match="chunk size"):
        go(arbitration_stride=2, windows_per_step=3, strict_wps=True)
    with pytest.raises(ValueError, match="boundary"):
        go(arbitration_stride=2, epoch=1)
    _, series = go(collect=())
    assert series == {}
