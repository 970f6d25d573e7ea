"""95th percentile (nearest rank) of the window's batch latencies, from
admission until the batch's answers are on the host, in ms."""
import math


def read(ev):
    b = sorted(ev["batch_s"])
    if not b:
        return None
    return b[math.ceil(0.95 * len(b)) - 1] * 1e3
