"""PyTorch/CUDA port of the P4DB reproduction (``repro``).

Layout mirrors ``repro``: ``core`` (packets, layout, hot index, switch
engine), ``db`` (cluster, WAL, faults, conflicts, txns), ``kernels``
(hand-written CUDA kernels with their plain PyTorch versions), ``obs``
(telemetry), ``workloads`` and ``convert`` (state carried over from the
reference).  Imports torch and numpy only, never jax or ``repro``.
"""
