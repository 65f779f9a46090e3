"""PyTorch/CUDA port of the GPAC memory-tiering engine (``repro``'s JAX
package stays the reference). Layout mirrors ``src/repro``: ``core/`` the
engine's modules, ``kernels/`` the hand-written CUDA kernels with their plain
PyTorch versions, ``data/`` the numpy trace generators, ``csrc/`` the CUDA
sources. Importing it builds nothing; the kernels build at first launch."""
