"""Host milliseconds per MiB out spent in span ``decode.raw``: each raw
block's CRC-32 on the host and its upload to the device, inside
``decode.split``."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "decode.raw" not in spans or not ctx["span_bytes_out"]:
        return None
    return spans["decode.raw"]["seconds"] * 1e3 / (ctx["span_bytes_out"] / MIB)
