"""Host milliseconds per MiB in spent in span ``compress.dispatch``: the
upload and the launches of one micro-batch's kernels and stock ops."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "compress.dispatch" not in spans or not ctx["span_bytes_in"]:
        return None
    return spans["compress.dispatch"]["seconds"] * 1e3 / (ctx["span_bytes_in"] / MIB)
