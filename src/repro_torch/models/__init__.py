"""Model layers, the dense transformer and the model registry (port of ``repro.models``)."""
