from repro_torch.kernels.histogram.ops import bincount  # noqa: F401
