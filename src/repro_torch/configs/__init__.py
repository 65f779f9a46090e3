"""Architecture configs (port of ``repro.configs``).

``get(name)`` returns the published config, ``reduced(name)`` the small
same-family variant for CPU tests. Only ``qwen2-0.5b`` is ported; every
other arch id of the reference raises.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig  # noqa: F401

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
_PORTED = {"qwen2-0.5b": "qwen2_0_5b", "qwen2_0_5b": "qwen2_0_5b"}
_MODULE_NAMES = {cli.replace("-", "_").replace(".", "_") for cli in CLI_IDS}


def _module(name: str):
    if name in _PORTED:
        return importlib.import_module(f"repro_torch.configs.{_PORTED[name]}")
    if name in CLI_IDS or name in _MODULE_NAMES:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP queue 1, item "
            "15: the model-layer stack; only qwen2-0.5b, the dense family, runs)")
    raise KeyError(f"unknown arch {name!r}; have {sorted(CLI_IDS)}")


def get(name: str) -> ArchConfig:
    """The published config."""
    return _module(name).CONFIG


def reduced(name: str) -> ArchConfig:
    """Small same-family config for CPU tests."""
    return _module(name).reduced()


def all_archs() -> tuple:
    return CLI_IDS
