"""decode_cpu_ms: CPU milliseconds of the decoding thread for one photo,
beside ``decode_ms``'s wall: the ``image_decode`` span stage's ``cpu_ms``
(``time.thread_time()`` deltas of the thread that probed and decoded)
gained over the window, over the engine's decodes. CPU near the wall is a
slower core; CPU well under it, a thread that waited. Nothing where the
program does not record the stage's CPU time."""


def read(ctx):
    try:
        s0 = ctx.stats0["tracing"]["stages"].get("image_decode", {"cpu_ms": 0.0})
        cpu_ms = ctx.stats1["tracing"]["stages"]["image_decode"]["cpu_ms"] - s0["cpu_ms"]
    except (KeyError, TypeError):
        return None
    n = ctx.decodes_delta()
    return cpu_ms / n if n > 0 else None
