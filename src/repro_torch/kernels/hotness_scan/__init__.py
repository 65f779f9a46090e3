from repro_torch.kernels.hotness_scan.ops import hot_count  # noqa: F401
