"""KV-cache offload through the LZ4 engines (`engine.py`; the serving loop
itself waits for the models, ROADMAP A9)."""
