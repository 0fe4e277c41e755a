"""Milliseconds per MiB out spent in span ``decode.verify``: fetching and
comparing the CRC-32s computed on the card."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "decode.verify" not in spans or not ctx["span_bytes_out"]:
        return None
    return spans["decode.verify"]["seconds"] * 1e3 / (ctx["span_bytes_out"] / MIB)
