"""Host milliseconds per MiB out spent in span ``decode.upload``: the three
uploads of one micro-batch's host arrays, inside ``decode.plan_device``."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "decode.upload" not in spans or not ctx["span_bytes_out"]:
        return None
    return spans["decode.upload"]["seconds"] * 1e3 / (ctx["span_bytes_out"] / MIB)
