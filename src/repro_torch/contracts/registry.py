"""Named invariant contracts (port of ``repro.contracts.registry``, DESIGN.md
§15).

A *contract* is one of the engine's bit-for-bit or safety invariants as a
registered object: a stable ``INV-*`` name, the DESIGN.md section that
states it, the drivers it covers, and a ``check_fn(draw, device=None)``
that raises ``AssertionError`` on violation for any concrete parameter draw
(``contracts.draws.ContractDraw``). The registry follows the port's other
registries: duplicates raise, unknown names raise listing the live set.

``tests/test_torch_contracts.py`` runs every registered contract over the
reference harness's hypothesis draws on the CPU, and ``chip_smoke.py``'s
``contracts`` phase runs them on the card through the hand kernels.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable

_NAME_RE = re.compile(r"^INV-[A-Z0-9]+(?:-[A-Z0-9]+)+$")


@dataclasses.dataclass(frozen=True)
class Contract:
    """One named invariant: where it is stated, what it covers, how it is
    checked.

    ``check_fn(draw, device=None)`` takes a ``ContractDraw`` and the device
    to run on (CUDA unless named) and raises ``AssertionError`` on
    violation. ``pins`` are the port's bespoke tests that also enforce the
    invariant. ``max_examples`` is the number of draws the harness runs:
    engine-level contracts take fewer than tick-level ones (the reference's
    budgets, set by its per-geometry compiles).
    """

    name: str
    design_section: str
    drivers: tuple[str, ...]
    check_fn: Callable
    description: str
    pins: tuple[str, ...] = ()
    max_examples: int = 10

    @property
    def harness_id(self) -> str:
        """The property-test node that runs this contract on the CPU."""
        return f"tests/test_torch_contracts.py::test_contract_property[{self.name}]"


_CONTRACTS: dict[str, Contract] = {}


def register_contract(
    name: str,
    design_section: str,
    drivers: tuple[str, ...],
    check_fn: Callable | None = None,
    *,
    description: str = "",
    pins: tuple[str, ...] = (),
    max_examples: int = 10,
):
    """Register an invariant contract; usable as a decorator::

        @register_contract("INV-MY-PIN", "§9", drivers=("run",))
        def check_my_pin(draw, device=None): ...

    Names must match ``INV-[A-Z0-9-]+``. Duplicates raise. The description
    defaults to the first line of the check_fn's docstring.
    """
    if check_fn is None:
        return lambda f: register_contract(
            name, design_section, drivers, f,
            description=description, pins=pins, max_examples=max_examples,
        )
    if not _NAME_RE.match(name):
        raise ValueError(
            f"contract name {name!r} must match {_NAME_RE.pattern}"
        )
    if name in _CONTRACTS:
        raise ValueError(f"contract {name!r} already registered")
    if not drivers:
        raise ValueError(f"contract {name!r} must name the drivers it covers")
    doc_lines = (check_fn.__doc__ or "").strip().splitlines()
    desc = description or (doc_lines[0] if doc_lines else "")
    if not desc:
        raise ValueError(f"contract {name!r} needs a description or docstring")
    _CONTRACTS[name] = Contract(
        name=name,
        design_section=design_section,
        drivers=tuple(drivers),
        check_fn=check_fn,
        description=desc,
        pins=tuple(pins),
        max_examples=max_examples,
    )
    return check_fn


def get_contract(name: str) -> Contract:
    try:
        return _CONTRACTS[name]
    except KeyError:
        raise ValueError(
            f"unknown contract {name!r} (have {contract_names()})"
        ) from None


def contract_names() -> tuple[str, ...]:
    """Names of all registered contracts, sorted."""
    return tuple(sorted(_CONTRACTS))


def all_contracts() -> tuple[Contract, ...]:
    return tuple(_CONTRACTS[n] for n in contract_names())
