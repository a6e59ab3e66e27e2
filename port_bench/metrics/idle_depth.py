"""idle_depth: the share of the window, in %, in which a compute stream of
the card sat idle between two batches because the batch could seal but the
sealer held it at the pipeline-depth cap (a slot held by a batch not yet
fetched), or had not yet woken
(``yardstick/gaps.py``)."""

from yardstick.gaps import idle_share


def read(ctx):
    return idle_share(ctx, "depth")
