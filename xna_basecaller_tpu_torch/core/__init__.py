"""Configuration and alphabet (copies of the JAX package's)."""
