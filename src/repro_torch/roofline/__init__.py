"""Roofline analysis over the port's dry-run records."""
