"""Deterministic token pipeline over LZ4-framed shards (`pipeline.py`)."""
