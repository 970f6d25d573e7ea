"""Transactions sent to the switch (hot admissions and warm sub-
transactions, the cluster's counters) per engine dispatch."""


def read(ev):
    c = ev["counters"]
    if not c["dispatches"]:
        return None
    return c["switch_txns"] / c["dispatches"]
