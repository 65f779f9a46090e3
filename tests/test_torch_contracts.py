"""The port's invariant-contract registry (``repro_torch.contracts``, DESIGN.md
§15) against the JAX package's, on the CPU.

Every contract runs over the reference harness's own hypothesis draws
(``strategies.contract_draws()``, turned into the port's ``ContractDraw``
field by field) at the reference's ``max_examples``, with ``device="cpu"``;
without hypothesis over ``fallback_draws()``. The JAX side runs only where
parity needs it: the registry's metadata, the draws and ``build_engine``.
Three planted faults show that a contract fails when its invariant breaks.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

try:
    from hypothesis import HealthCheck, given, settings
    import strategies
except ImportError:  # pragma: no cover - exercised only without hypothesis
    strategies = None

import torch_jax_core  # noqa: E402
from repro import contracts as jcontracts  # noqa: E402
from repro.contracts import draws as jdraws  # noqa: E402
from repro.core import tiering as jtiering  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.contracts import (  # noqa: E402
    all_contracts,
    contract_names,
    get_contract,
)
from repro_torch.contracts import draws, invariants  # noqa: E402
from repro_torch.contracts import registry as creg  # noqa: E402
from repro_torch.core import engine, tiering  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_rank_group():
    """The contracts' ``guest_mesh(1)`` joins a one-rank gloo group once;
    it is left at the module's end."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def port_draw(d) -> draws.ContractDraw:
    """The reference's draw as the port's, field by field."""
    fields = {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}
    fields["guests"] = tuple(
        draws.GuestDraw(**{f.name: getattr(g, f.name) for f in dataclasses.fields(g)})
        for g in d.guests)
    return draws.ContractDraw(**fields)


# --------------------------------------------------------------------------
# the property harness: one node per registered contract
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", contract_names())
def test_contract_property(name, request):
    c = get_contract(name)
    assert request.node.nodeid == c.harness_id

    if strategies is None:  # no hypothesis: run the fixed draws
        for draw in draws.fallback_draws():
            c.check_fn(draw, device="cpu")
        return

    @given(strategies.contract_draws())
    @settings(
        max_examples=c.max_examples,
        deadline=None,
        derandomize=True,
        suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
    )
    def run_property(draw):
        c.check_fn(port_draw(draw), device="cpu")

    run_property()


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------
def test_registry_metadata_matches_reference():
    assert contract_names() == jcontracts.contract_names()
    assert len(contract_names()) == 10
    for c in all_contracts():
        ref = jcontracts.get_contract(c.name)
        assert (c.design_section, c.drivers, c.max_examples, c.description) == (
            ref.design_section, ref.drivers, ref.max_examples, ref.description), c.name


def _defined_names(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    return {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def test_registry_idiom_and_references(monkeypatch):
    # harness ids name this file's property nodes; every pin a port test
    # that exists
    here = _defined_names(pathlib.Path(__file__))
    assert "test_contract_property" in here
    for c in all_contracts():
        assert c.harness_id == (
            f"tests/test_torch_contracts.py::test_contract_property[{c.name}]")
        assert c.pins, c.name
        for pin in c.pins:
            rel, _, node = pin.partition("::")
            assert rel.startswith("tests/test_torch_"), pin
            assert (ROOT / rel).exists(), f"{c.name}: {pin} dangling"
            if node:
                assert node in _defined_names(ROOT / rel), f"{c.name}: {pin} dangling"

    monkeypatch.setattr(creg, "_CONTRACTS", dict(creg._CONTRACTS))
    creg.register_contract("INV-TEST-DUP", "§0", ("run",), lambda d: None, description="x")
    with pytest.raises(ValueError, match="already registered"):
        creg.register_contract("INV-TEST-DUP", "§0", ("run",), lambda d: None,
                               description="x")
    with pytest.raises(ValueError, match="INV-CHURN-NOOP-EXACT"):
        get_contract("INV-NO-SUCH-THING")
    for bad in ("inv-lower-case", "INV-", "CHURN-NOOP", "INV-ONEPART"):
        with pytest.raises(ValueError, match="must match"):
            creg.register_contract(bad, "§0", ("run",), lambda d: None, description="x")
    with pytest.raises(ValueError, match="drivers"):
        creg.register_contract("INV-TEST-NODRIVER", "§0", (), lambda d: None,
                               description="x")

    def undocumented(d):
        pass

    with pytest.raises(ValueError, match="description"):
        creg.register_contract("INV-TEST-NODESC", "§0", ("run",), undocumented)

    @creg.register_contract("INV-TEST-DECOR", "§0", ("run",))
    def check_something(draw, device=None):
        """A docstring description."""

    assert get_contract("INV-TEST-DECOR").check_fn is check_something
    assert get_contract("INV-TEST-DECOR").description == "A docstring description."


# --------------------------------------------------------------------------
# the draws
# --------------------------------------------------------------------------
def test_draw_fields_and_policies_match_reference():
    for port_cls, ref_cls in ((draws.GuestDraw, jdraws.GuestDraw),
                              (draws.ContractDraw, jdraws.ContractDraw)):
        assert ([(f.name, f.type) for f in dataclasses.fields(port_cls)]
                == [(f.name, f.type) for f in dataclasses.fields(ref_cls)])
    assert draws.fallback_draws() == tuple(port_draw(d) for d in jdraws.fallback_draws())
    assert [d.n_guests for d in draws.fallback_draws()] == [2, 1]
    assert tiering.POLICIES == jtiering.POLICIES
    assert tiering.policies() == jtiering.policies()


def test_build_engine_matches_reference():
    for d in draws.fallback_draws():
        with torch_jax_core.jitted_service():
            jspec, jstate = jdraws.build_engine(d)
        spec, state = draws.build_engine(d, device="cpu")
        assert spec.cfg.n_logical == jspec.cfg.n_logical
        assert (spec.cfg.hp_ratio, spec.cfg.n_gpa_hp, spec.cfg.n_near,
                spec.cfg.base_elems, spec.cfg.cl) == (
            jspec.cfg.hp_ratio, jspec.cfg.n_gpa_hp, jspec.cfg.n_near,
            jspec.cfg.base_elems, jspec.cfg.cl)
        assert spec.logical_offsets == jspec.logical_offsets
        assert spec.hp_offsets == jspec.hp_offsets
        got = interop.state_to_numpy(state)
        want = {f.name: np.asarray(getattr(jstate, f.name))
                for f in dataclasses.fields(jstate) if f.name != "stats"}
        want["stats"] = {k: np.asarray(v) for k, v in jstate.stats.items()}
        invariants.assert_states_equal(want, got, "build_engine")
        src = draws.trace_source(d, spec)
        assert isinstance(src, engine.SynthTrace if d.synth else engine.ArrayTrace)
        if not d.synth:
            jsrc = jdraws.trace_source(d, jspec)
            invariants.assert_series_equal(
                {"t": np.asarray(jsrc.traces)}, {"t": src.traces}, "trace_source")


# --------------------------------------------------------------------------
# planted faults: each breaks one invariant, and its contract must fail
# --------------------------------------------------------------------------
_RANK_SELECT = tiering.rank_select


def _ties_to_highest(c: dict, b: int) -> dict:
    """``rank_select`` with its tie order reversed (ties to the highest
    id)."""
    flipped = dict(c, id=torch.where(c["id"] >= 0, (2**30) - c["id"], c["id"]))
    out = _RANK_SELECT(flipped, b)
    out["id"] = torch.where(out["id"] >= 0, (2**30) - out["id"], out["id"])
    return out


def _plant_rank_select(monkeypatch):
    monkeypatch.setattr(tiering, "rank_select", _ties_to_highest)


def _plant_inactive_lane(monkeypatch):
    window = engine._churn_window

    def lane_0_down(spec, cs, *a, **k):
        active = cs.active.clone()
        active[0] = False
        return window(spec, dataclasses.replace(cs, active=active), *a, **k)

    monkeypatch.setattr(engine, "_churn_window", lane_0_down)


def _plant_flipped_bit(monkeypatch):
    run = engine.run

    def run_flipping_auto(*a, **k):
        state, series = run(*a, **k)
        if k.get("kernel_backend") == "auto":
            state.guest_counts[0] ^= 1
        return state, series

    monkeypatch.setattr(engine, "run", run_flipping_auto)


@pytest.mark.parametrize("name, plant", [
    ("INV-ARBITRATION-TIEBREAK", _plant_rank_select),
    ("INV-CHURN-NOOP-EXACT", _plant_inactive_lane),
    ("INV-KERNEL-BACKEND-EXACT", _plant_flipped_bit),
], ids=["rank_select-ties-reversed", "churn-lane-inactive", "auto-bit-flipped"])
def test_planted_fault_fails_its_contract(name, plant, monkeypatch):
    c = get_contract(name)
    for draw in draws.fallback_draws():  # sound before the fault
        c.check_fn(draw, device="cpu")
    plant(monkeypatch)
    with pytest.raises(AssertionError):
        for draw in draws.fallback_draws():
            c.check_fn(draw, device="cpu")
