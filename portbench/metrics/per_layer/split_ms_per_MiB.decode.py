"""Host milliseconds per MiB out spent in span ``decode.split``: slicing the
frame's payloads, once a call, before the first dispatch (a raw block
is checked and placed inside it)."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "decode.split" not in spans or not ctx["span_bytes_out"]:
        return None
    return spans["decode.split"]["seconds"] * 1e3 / (ctx["span_bytes_out"] / MIB)
