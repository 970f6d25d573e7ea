"""Host us a transaction in the program's ``classify`` span."""


def read(ev):
    if not ev["calls"].get("classify"):
        return None
    return ev["spans"]["classify"] / ev["txns"] * 1e6
