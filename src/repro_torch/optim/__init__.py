"""Gradient compression at the host boundary (`grad_compress.py`)."""
