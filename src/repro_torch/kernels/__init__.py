"""Hand-written CUDA kernels (``csrc/``) behind the port's kernel registry.

Each subpackage's ``ops.py`` holds a kernel's wrapper, its plain PyTorch
version and its registry entry; importing this package fills the registry
and builds nothing.
"""
from repro_torch.kernels import registry  # noqa: F401
from repro_torch.kernels import (  # noqa: F401  (registration side effects)
    consolidate,
    flash_attention,
    histogram,
    hotness_scan,
    paged_attention,
    tiered_lookup,
    topk,
)
