"""Early-exit configuration vocabulary (own copy of the JAX package's)."""
