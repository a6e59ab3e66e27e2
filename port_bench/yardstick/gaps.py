"""The share of a cell's window in which a compute stream of the card sat
idle between two batches for one cause, in %, read from the engine's
``/stats → engine → device_idle`` counters (CUDA events on the host's
clock, each gap split by the host stage that held the next batch): the
cause's seconds gained in the window, summed over the replicas, over the
replicas and the window's seconds. The readers ``metrics/idle_<cause>.py``
call it. Nothing where the program has no such counters or timed no
batch."""


def idle_share(ctx, cause: str):
    try:
        d0, d1 = ctx.stats0["engine"]["device_idle"], ctx.stats1["engine"]["device_idle"]
        idle_s = d1["idle_s"][cause] - d0["idle_s"][cause]
        timed = d1["batches_timed"] - d0["batches_timed"]
        replicas = len(d1["replicas"])
    except (KeyError, TypeError):
        return None
    if timed <= 0 or replicas <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * idle_s / replicas / ctx.window_s
