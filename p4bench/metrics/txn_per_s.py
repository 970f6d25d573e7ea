"""Transactions acknowledged with their answers on the host over the
whole window (the final drain inside it), per second of the window."""


def read(ev):
    return ev["txns"] / ev["window_s"]
