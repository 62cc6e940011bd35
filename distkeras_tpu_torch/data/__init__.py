"""Columnar host data (a copy of the JAX package's numpy-only Dataset)."""
