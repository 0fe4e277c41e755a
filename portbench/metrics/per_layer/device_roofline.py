"""Share, in %, of the device busy time that the least time of the
operation would fill: each input byte read once and each output byte written
once, over the card's memory bandwidth (peaks.json), divided by the device
busy time of the profiled calls, whatever kernels do the work.  One reader
for each name it is split into by the rate it moves
(device_roofline.compress, device_roofline.decode)."""


def read(ctx: dict) -> float | None:
    prof, peaks = ctx["profile"], ctx["peaks"]
    if not prof or not peaks or prof["busy_s"] <= 0:
        return None
    least = (prof["bytes_in"] + prof["bytes_out"]) / peaks["hbm_bytes_per_s"]
    return 100.0 * least / prof["busy_s"]
