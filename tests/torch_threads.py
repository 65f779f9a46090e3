"""One intra-op thread for torch, in every test process that imports the
port's tests (each ``tests/test_torch_*.py`` imports this module).

Tier-1 runs in several xdist workers on a few cores. torch's default
intra-op pool, one thread per core in each worker, oversubscribes them and
slows every worker, the one that runs the long JAX tests too. The port's
test tensors are small: one thread costs them nothing."""
import torch

torch.set_num_threads(1)
