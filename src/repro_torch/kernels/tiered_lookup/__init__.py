from repro_torch.kernels.tiered_lookup.ops import gather_rows, tiered_lookup  # noqa: F401
