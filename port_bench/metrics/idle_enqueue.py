"""idle_enqueue: the share of the window, in %, in which a compute stream of
the card sat idle between two batches because the copy was done and the
host issued the replay (the replica's lock and the static input's copy, up
to the replay's start)
(``yardstick/gaps.py``)."""

from yardstick.gaps import idle_share


def read(ctx):
    return idle_share(ctx, "enqueue")
