"""Host us a transaction in the cluster's ``_run_warm`` (the cold part
under 2PL, the switch sub-transaction, the 2PC decision and the WAL)."""


def read(ev):
    if not ev["calls"].get("warm"):
        return None
    return ev["spans"]["warm"] / ev["txns"] * 1e6
