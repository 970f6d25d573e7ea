"""Host us a transaction in the program's ``drain`` span (the async hot
path's result plane: wait, D2H, scatter to clients and WAL)."""


def read(ev):
    if not ev["calls"].get("drain"):
        return None
    return ev["spans"]["drain"] / ev["txns"] * 1e6
