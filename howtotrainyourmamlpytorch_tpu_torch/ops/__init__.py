"""Tensor ops of the port (NCHW), one module per JAX ``ops`` module."""
