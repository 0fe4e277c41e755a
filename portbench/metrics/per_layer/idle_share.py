"""Share, in %, of the profiled calls' wall time in which no operation ran
on the device.  One reader for each name it is split into by the rate it
moves (idle_share.compress, idle_share.decode)."""


def read(ctx: dict) -> float | None:
    prof = ctx["profile"]
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
