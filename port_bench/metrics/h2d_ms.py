"""h2d_ms: device milliseconds of a batch's host-to-device copy, whether
the previous batch's replay hid it or not: the H2D seconds the engine's
``/stats → engine → device_idle`` counters gained in the window (CUDA
events on the copy stream) over the batches they timed. Nothing where the
program has no such counters or timed no batch."""


def read(ctx):
    try:
        d0, d1 = ctx.stats0["engine"]["device_idle"], ctx.stats1["engine"]["device_idle"]
        h2d_s = d1["h2d_s"] - d0["h2d_s"]
        timed = d1["batches_timed"] - d0["batches_timed"]
    except (KeyError, TypeError):
        return None
    return h2d_s * 1e3 / timed if timed > 0 else None
