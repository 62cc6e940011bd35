"""Layers, the Sequential container and the model zoo."""
