"""idle_h2d: the share of the window, in %, in which a compute stream of the
card sat idle between two batches because the batch's host-to-device copy
ran on the device
(``yardstick/gaps.py``)."""

from yardstick.gaps import idle_share


def read(ctx):
    return idle_share(ctx, "h2d")
