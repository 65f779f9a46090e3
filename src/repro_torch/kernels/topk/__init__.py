from repro_torch.kernels.topk.ops import topk_rows  # noqa: F401
