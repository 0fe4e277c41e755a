"""Host milliseconds per MiB in spent in span ``compress.split``: the list
of a call's 64 KiB chunks of the object (`LZ4Engine._payload_iter`)."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "compress.split" not in spans or not ctx["span_bytes_in"]:
        return None
    return spans["compress.split"]["seconds"] * 1e3 / (ctx["span_bytes_in"] / MIB)
