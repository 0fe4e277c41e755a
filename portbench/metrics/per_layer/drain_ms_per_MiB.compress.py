"""Milliseconds per MiB in spent in span ``compress.drain``: fetching each
coded block's payload from the card."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "compress.drain" not in spans or not ctx["span_bytes_in"]:
        return None
    return spans["compress.drain"]["seconds"] * 1e3 / (ctx["span_bytes_in"] / MIB)
