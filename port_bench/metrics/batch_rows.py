"""batch_rows: photos a sealed batch carried over the window, the engine's
images over its batches."""


def read(ctx):
    batches = ctx.engine_delta("batches")
    return ctx.engine_delta("images") / batches if batches > 0 else None
