from repro_torch.kernels.consolidate.ops import consolidate_region, scatter_region  # noqa: F401
