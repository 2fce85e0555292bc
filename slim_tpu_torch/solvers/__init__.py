"""Model estimation solvers."""
