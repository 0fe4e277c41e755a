"""Host milliseconds per MiB in of `LZ4Engine.compress` outside dispatch and
the wait on the device: span ``compress.total`` less ``compress.dispatch``
and ``compress.wait`` (slicing, padding, CRC-32, payload fetch, frame)."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "compress.total" not in spans or not ctx["span_bytes_in"]:
        return None
    s = spans["compress.total"]["seconds"] - sum(
        spans.get(k, {}).get("seconds", 0.0)
        for k in ("compress.dispatch", "compress.wait"))
    return s * 1e3 / (ctx["span_bytes_in"] / MIB)
