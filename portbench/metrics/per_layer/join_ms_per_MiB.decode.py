"""Host milliseconds per MiB out spent in span ``decode.join``: the decoded
blocks joined into one tensor on the card (`_join_device`), once a call."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "decode.join" not in spans or not ctx["span_bytes_out"]:
        return None
    return spans["decode.join"]["seconds"] * 1e3 / (ctx["span_bytes_out"] / MIB)
