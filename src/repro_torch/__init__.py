"""PyTorch/CUDA port of the FAMOUS serving system (see README.md).

The JAX package ``repro`` stays the reference; this package imports
neither ``jax`` nor ``repro``.
"""
