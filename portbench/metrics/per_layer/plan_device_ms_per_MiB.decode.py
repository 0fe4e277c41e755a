"""Host milliseconds per MiB out spent in span ``decode.plan_device``: the
uploads and the launches of `plan_decode` for one micro-batch."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "decode.plan_device" not in spans or not ctx["span_bytes_out"]:
        return None
    return spans["decode.plan_device"]["seconds"] * 1e3 / (ctx["span_bytes_out"] / MIB)
