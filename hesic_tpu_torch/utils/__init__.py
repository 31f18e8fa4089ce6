"""Utilities: weight transfer from the JAX package's parameter trees."""
