from repro_torch.kernels.tiered_lookup.ops import gather_rows  # noqa: F401
