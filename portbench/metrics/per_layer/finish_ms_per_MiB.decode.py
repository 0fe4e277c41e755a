"""Host milliseconds per MiB out spent in span ``decode.finish``: each
block's status read and its result recorded, once a micro-batch."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "decode.finish" not in spans or not ctx["span_bytes_out"]:
        return None
    return spans["decode.finish"]["seconds"] * 1e3 / (ctx["span_bytes_out"] / MIB)
