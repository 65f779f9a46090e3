"""Workload trace generators (numpy) and on-device synthesis (JAX's threefry streams in torch)."""
