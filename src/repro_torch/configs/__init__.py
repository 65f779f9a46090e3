"""Architecture configs (port of ``repro.configs``).

``get(name)`` returns the published config (CLI id or module name),
``reduced(name)`` the small same-family variant for CPU tests.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPE_SPECS, SHAPES, ArchConfig  # noqa: F401

# the reference's CLI ids, in its order
CLI_IDS = (
    "qwen2-vl-2b",
    "jamba-1.5-large-398b",
    "kimi-k2-1t-a32b",
    "qwen2-moe-a2.7b",
    "internlm2-20b",
    "gemma-7b",
    "smollm-360m",
    "qwen2-0.5b",
    "whisper-tiny",
    "xlstm-1.3b",
)
_MODULES = {cli: cli.replace("-", "_").replace(".", "_") for cli in CLI_IDS}
_MODULES.update({v: v for v in list(_MODULES.values())})  # module-style names too


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(set(_MODULES))}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ArchConfig:
    """The published config."""
    return _module(name).CONFIG


def reduced(name: str) -> ArchConfig:
    """Small same-family config for CPU tests."""
    return _module(name).reduced()


def all_archs() -> tuple:
    return CLI_IDS
