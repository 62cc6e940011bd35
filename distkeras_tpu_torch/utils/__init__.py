"""Device contract and the JAX weight bridge."""
