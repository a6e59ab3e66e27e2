"""p95_ms.host: the 95th percentile, in ms, of every call sent in the
window, from the client's send to the answer's last byte (a failed call
counts as missing any limit), as the clients' own clock reads it. In a
closed loop that holds the server at its capacity, the tail follows the
rate (the calls in flight over the rate) and the host's stages that set
it, so it is read beside ``img_per_s`` rather than held to a bound."""

from yardstick.loadgen import percentile


def read(ctx):
    p95 = percentile(ctx.latencies_ms, 95)
    return p95 if p95 is not None and p95 != float("inf") else None
