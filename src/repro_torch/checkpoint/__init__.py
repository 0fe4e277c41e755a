"""Crash-consistent, LZ4-compressed checkpoints of trees of tensors
(`checkpoint.py`; the JAX package's format, so either package restores the
other's)."""
