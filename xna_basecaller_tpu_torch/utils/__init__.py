"""Loading, weights and host utilities."""
