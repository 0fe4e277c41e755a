"""Bytes decoded onto the card in the window per second of the window (GB = 1e9 bytes)."""


def read(window: dict) -> float:
    return window["bytes_out"] / window["seconds"] / 1e9
