"""Host us a call of the switch engine's ``execute_batch``."""


def read(ev):
    n = ev["calls"].get("dispatch")
    if not n:
        return None
    return ev["spans"]["dispatch"] / n * 1e6
