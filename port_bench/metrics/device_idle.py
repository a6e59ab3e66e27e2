"""device_idle: the share of the traced slice of the window, in %, in
which no operation ran on the device (the profiler's kernel, copy and
memset timeline). Nothing without a trace that holds a device operation."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_us <= 0 or t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
