"""Invariant contract registry (port of ``repro.contracts``, DESIGN.md §15).

Importing this package registers the builtin contracts, as
``repro_torch.core.tiering`` registers its builtin policies: the test
harness, ``chip_smoke.py`` and user code all see the same live set.
"""
from repro_torch.contracts.registry import (
    Contract,
    all_contracts,
    contract_names,
    get_contract,
    register_contract,
)
from repro_torch.contracts.draws import ContractDraw, GuestDraw, build_engine
from repro_torch.contracts import invariants as _invariants  # noqa: F401  (registers)

__all__ = [
    "Contract",
    "ContractDraw",
    "GuestDraw",
    "all_contracts",
    "build_engine",
    "contract_names",
    "get_contract",
    "register_contract",
]
