"""Milliseconds per MiB out spent in span ``decode.wait``: the status fetch
that waits for a micro-batch's kernels, device time that
``host_loop_ms_per_MiB.decode`` counts as the host's."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "decode.wait" not in spans or not ctx["span_bytes_out"]:
        return None
    return spans["decode.wait"]["seconds"] * 1e3 / (ctx["span_bytes_out"] / MIB)
