"""idle_assembly: the share of the window, in %, in which a compute stream of
the card sat idle between two batches because the next batch's rows were
still being leased, decoded or committed, or its window was open
(``yardstick/gaps.py``)."""

from yardstick.gaps import idle_share


def read(ctx):
    return idle_share(ctx, "assembly")
