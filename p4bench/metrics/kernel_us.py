"""Device us a launch of the program's switch kernels in the profiled
window (rows of the routes the window's dispatches took)."""
from p4bench.harness import routes_of


def read(ev):
    p = ev["profile"]
    if p is None:
        return None
    rows = [(t, c) for t, k, c in p["rows"] if routes_of(k, p["records"])]
    n = sum(c for _, c in rows)
    return sum(t for t, _ in rows) / n if n else None
