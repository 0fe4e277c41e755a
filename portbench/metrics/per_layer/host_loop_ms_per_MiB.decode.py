"""Host milliseconds per MiB out of `LZ4DecodeEngine.decode_to_device`
outside the device planning and the checks: span ``decode.total`` less
``decode.plan_device`` and ``decode.verify`` (the frame table, stacking the
payloads, the per-dispatch status fetch, the join)."""

MIB = 1 << 20


def read(ctx: dict) -> float | None:
    spans = ctx["spans"]
    if "decode.total" not in spans or not ctx["span_bytes_out"]:
        return None
    s = spans["decode.total"]["seconds"] - sum(
        spans.get(k, {}).get("seconds", 0.0)
        for k in ("decode.plan_device", "decode.verify"))
    return s * 1e3 / (ctx["span_bytes_out"] / MIB)
