"""mfu: the whole step's share of the card's peak, in %: the analytic
FLOPs of the photos answered in the window (the benchmark's own count)
over the window's seconds times the card's peak in the served dtype
(``costs.PEAKS``; float32 on the CUDA cores, TF32 off)."""


def read(ctx):
    if ctx.peak is None or ctx.window_s <= 0 or ctx.photos_answered <= 0:
        return None
    flops = ctx.photos_answered * ctx.flops_per_image
    return 100.0 * flops / (ctx.window_s * ctx.peak[ctx.cell.config["dtype"]])
