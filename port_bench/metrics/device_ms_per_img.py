"""device_ms_per_img: device milliseconds a photo, the engine's CUDA-event
compute seconds over its rows in the window (the economics counters). On a
card the table does not know, or off the card, nothing."""


def read(ctx):
    e = ctx.econ_delta()
    if ctx.peak is None or e["rows"] <= 0:
        return None
    return e["device_s"] * 1e3 / e["rows"]
