"""Input bytes compressed in the window per second of the window (GB = 1e9 bytes)."""


def read(window: dict) -> float:
    return window["bytes_in"] / window["seconds"] / 1e9
