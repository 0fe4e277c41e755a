"""Optimizers: AdamW and its schedules (`adamw.py`), and gradient
compression at the host boundary (`grad_compress.py`)."""
