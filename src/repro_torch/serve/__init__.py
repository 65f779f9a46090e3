"""Serving: the request scheduler and the continuous-batching engine over the GPAC-tiered paged KV cache (port of ``repro.serve``)."""
