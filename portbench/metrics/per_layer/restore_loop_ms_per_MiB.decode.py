"""Host milliseconds per MiB out of `serving.restore_cache` outside the
decode engine's calls: span ``serving.restore`` less ``decode.total`` (each
leaf's frame table read, its view and the tree rebuilt)."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "serving.restore" not in spans or not ctx["span_bytes_out"]:
        return None
    s = spans["serving.restore"]["seconds"] - spans.get(
        "decode.total", {}).get("seconds", 0.0)
    return s * 1e3 / (ctx["span_bytes_out"] / MIB)
