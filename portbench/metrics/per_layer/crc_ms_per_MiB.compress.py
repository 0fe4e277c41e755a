"""Host milliseconds per MiB in spent in span ``compress.crc``: the CRC-32
of each block for the frame's table, on the host."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "compress.crc" not in spans or not ctx["span_bytes_in"]:
        return None
    return spans["compress.crc"]["seconds"] * 1e3 / (ctx["span_bytes_in"] / MIB)
