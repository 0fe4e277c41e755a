"""Host milliseconds per MiB out spent in span ``decode.stack``: the host
arrays of one micro-batch (its payloads stacked, their sizes and
output bounds)."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "decode.stack" not in spans or not ctx["span_bytes_out"]:
        return None
    return spans["decode.stack"]["seconds"] * 1e3 / (ctx["span_bytes_out"] / MIB)
