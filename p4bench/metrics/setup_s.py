"""Seconds from the process's start to the first timed batch: imports,
the card, the program's kernels (built on a checkout's first run), the
traffic, the loaded tables, the hot index, the cluster and the warm-up."""


def read(ev):
    return ev["setup_s"]
