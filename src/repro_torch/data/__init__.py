"""Workload trace generators (numpy)."""
