"""The port's kernel registry: one table of kernels, each a hand-written
CUDA kernel's wrapper beside its plain PyTorch version.

Mirrors ``repro.kernels.registry`` (duplicates raise, unknown names raise
listing the live set). Core modules pass the engine's ``kernel_backend``
knob to :func:`dispatch` and never compare backend strings themselves:

* ``"auto"``  -- the wrapper, which goes by the device of the tensors it is
  handed: a CPU tensor runs the plain version, a CUDA tensor launches the
  kernel or raises. It never takes the plain version on a CUDA tensor.
* ``"torch"`` -- the plain version on any device (the role JAX's ``"xla"``
  plays): the reference run that ``chip_smoke.py`` holds the kernels to.

Each wrapper adds one to its launch count where it launches its kernel and
nowhere else, so a run can show that it went through the kernels.

An entry may carry an ``oracle`` (an independent numpy implementation, for
the tests) and an ``example(device)`` that returns ``(args, kwargs)`` on that
device, drawn from the same ``np.random.default_rng(0)`` numbers as the JAX
entry's example, so that both registries see the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

BACKENDS = ("auto", "torch")


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel: ``kernel`` is the wrapper (launches on CUDA
    tensors, runs ``plain`` on CPU tensors), ``plain`` the PyTorch version,
    ``oracle`` (optional) a numpy version and ``example`` (optional) a
    callable ``example(device) -> (args, kwargs)``."""

    name: str
    kernel: Callable
    plain: Callable
    oracle: Callable | None = None
    example: Callable | None = None
    description: str = ""


_KERNELS: dict[str, KernelSpec] = {}
_LAUNCHES: dict[str, int] = {}


def register_kernel(
    name: str, kernel: Callable, plain: Callable, *,
    oracle: Callable | None = None, example: Callable | None = None,
    description: str = "",
) -> KernelSpec:
    """Register a kernel under a unique name; duplicates raise."""
    if name in _KERNELS:
        raise ValueError(f"kernel {name!r} already registered")
    spec = KernelSpec(name=name, kernel=kernel, plain=plain, oracle=oracle,
                      example=example, description=description)
    _KERNELS[name] = spec
    _LAUNCHES[name] = 0
    return spec


def get_kernel(name: str) -> KernelSpec:
    try:
        return _KERNELS[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel {name!r} (have {kernel_names()})") from None


def kernel_names() -> tuple[str, ...]:
    return tuple(sorted(_KERNELS))


def all_kernels() -> tuple[KernelSpec, ...]:
    return tuple(_KERNELS[n] for n in kernel_names())


def resolve_backend(choice: str) -> str:
    if choice not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {choice!r} (have {BACKENDS})")
    return choice


def dispatch(name: str, choice: str, *args, **kwargs):
    """Run the named kernel: its wrapper (``"auto"``) or its plain version
    (``"torch"``)."""
    spec = get_kernel(name)
    if resolve_backend(choice) == "torch":
        return spec.plain(*args, **kwargs)
    return spec.kernel(*args, **kwargs)


def count_launch(name: str) -> None:
    """Called by a wrapper right where it launches its kernel."""
    _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
