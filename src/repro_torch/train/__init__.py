"""Training (port of ``repro.train``): optimizers, int8 gradient
compression, the train step and loop, checkpoints, fault policies."""
