"""decode_ms: host milliseconds to decode one photo, the mean of the
``image_decode`` span stage over the window (the stage sums a request's
photos; the engine's decode counters count them)."""


def read(ctx):
    _, total_ms = ctx.stage_delta("image_decode")
    n = ctx.decodes_delta()
    return total_ms / n if n > 0 else None
