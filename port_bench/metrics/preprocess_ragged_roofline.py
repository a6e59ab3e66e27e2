"""preprocess_ragged_roofline: the ragged preprocess kernel's share of its
roofline, in %: the least time for the bytes one call must move
(``costs.preprocess_ragged_bytes`` for the window's mean call: its photos'
valid bytes, a meta row and an output row a batch row) at the card's HBM
rate, over the kernel's mean device time a launch in the profiler's trace.
Nothing without a trace that holds a launch."""

from yardstick.costs import preprocess_ragged_bytes


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    durations = ctx.trace.kernel_durations_us(r"preprocess_ragged")
    batches = ctx.engine_delta("batches")
    e = ctx.econ_delta()
    if not durations or batches <= 0:
        return None
    rows, rows_dispatched = e["rows"] / batches, e["rows_dispatched"] / batches
    out_h, out_w = ctx.out_hw
    elt = 4 if ctx.cell.config["dtype"] == "float32" else 2
    nbytes = preprocess_ragged_bytes(ctx.valid_bytes_per_photo * rows, rows_dispatched,
                                     out_h, out_w, elt)
    least_us = nbytes / ctx.peak["hbm_bytes_per_s"] * 1e6
    return 100.0 * least_us / (sum(durations) / len(durations))
