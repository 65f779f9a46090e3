"""Tiered memory substrate over the GPAC core (port of ``repro.memory``):
the embedding store, the paged KV cache and the MoE expert store."""
from repro_torch.memory import embedding, kvcache, moe_store  # noqa: F401
