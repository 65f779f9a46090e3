"""The port's static analysis (DESIGN.md §15): ``analysis.lint``, the AST
lints and their allowlist (``python -m repro_torch.analysis.lint``)."""
