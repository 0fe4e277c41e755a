"""Input bytes over frame bytes, summed over the window's calls: what the caller stores."""


def read(window: dict) -> float:
    return window["bytes_in"] / window["bytes_out"]
