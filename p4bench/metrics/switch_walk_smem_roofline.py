"""Share of its roofline of the single-CTA walk kernel in the profiled
window: the bytes its dispatches' inputs need (``roofline/
switch_walk_smem.py``) over the device's bandwidth, against its device
time."""
from p4bench.harness import peak, roofline_bytes

ROUTE = "switch_walk_smem"


def read(ev):
    p = ev["profile"]
    if p is None:
        return None
    recs = [r for r in p["records"]
            if any(x.split(".")[0] == ROUTE for x in r["routes"])]
    rows = [(t, c) for t, k, c in p["rows"] if f"{ROUTE}_kernel" in k]
    bw = peak(ev["device_kind"], "hbm_bytes_per_s")
    if not recs or sum(c for _, c in rows) != len(recs) or not bw:
        return None
    bound_s = sum(roofline_bytes(ROUTE, r) for r in recs) / bw
    return 100.0 * bound_s / (sum(t for t, _ in rows) * 1e-6)
