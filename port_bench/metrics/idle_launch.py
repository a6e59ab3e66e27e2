"""idle_launch: the share of the window, in %, in which a compute stream of
the card sat idle between two batches because the sealed batch waited in
the launch queue and the launch thread issued its copy
(``yardstick/gaps.py``)."""

from yardstick.gaps import idle_share


def read(ctx):
    return idle_share(ctx, "launch")
