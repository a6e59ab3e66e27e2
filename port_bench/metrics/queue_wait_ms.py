"""queue_wait_ms: the 95th percentile, in ms, of the ``queue_wait`` span
stage (a photo's commit to its batch's launch; a request's slowest photo)
over the window, from the stage histogram's deltas."""


def read(ctx):
    q = ctx.stage_quantile("queue_wait", 0.95)
    return q * 1e3 if q is not None else None
