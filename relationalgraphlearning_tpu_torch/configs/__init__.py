"""Configuration dataclasses (a copy of the JAX package's)."""
