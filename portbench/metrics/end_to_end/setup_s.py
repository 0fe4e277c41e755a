"""Seconds from the start of the benchmark's process to the window's opening:
imports and device init, the object, the driver's set-up, the warm-up call."""


def read(window: dict) -> float:
    return window["setup_s"]
