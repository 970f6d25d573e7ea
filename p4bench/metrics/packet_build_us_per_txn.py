"""Host us a transaction in ``build_packets``, every call the cluster
makes (hot groups and warm sub-transactions)."""


def read(ev):
    if not ev["calls"].get("packet_build"):
        return None
    return ev["spans"]["packet_build"] / ev["txns"] * 1e6
