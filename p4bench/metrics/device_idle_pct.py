"""Share of the profiled window in which no kernel or copy ran on the
device."""


def read(ev):
    p = ev["profile"]
    if p is None:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
