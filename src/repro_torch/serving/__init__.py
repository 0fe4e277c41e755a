"""The serving loop (`ServingEngine`, `Request`) and KV-cache offload through
the LZ4 engines (`engine.py`)."""
