from repro_torch.kernels.flash_attention.ops import gqa_attention  # noqa: F401
