"""Host us a transaction outside the classify, packet-build, dispatch and
drain spans: the window's time less theirs (the cold and warm paths,
locks, 2PC, the WAL, the warm path's synchronous drain, the loop)."""

SPANS = ("classify", "packet_build", "dispatch", "drain")


def read(ev):
    rest = ev["window_s"] - sum(ev["spans"].get(s, 0.0) for s in SPANS)
    return rest / ev["txns"] * 1e6
