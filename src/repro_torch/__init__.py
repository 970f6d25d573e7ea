"""PyTorch/CUDA port of the P4DB reproduction (``repro``).

Layout mirrors ``repro``: ``core`` (packets, layout, hot index, switch
engine), ``db`` (cluster, WAL, faults, conflicts, txns), ``kernels``
(hand-written CUDA kernels with their plain PyTorch versions), ``obs``
(telemetry), ``sim``, ``workloads``, the model zoo's MoE path
(``models``, ``optim``, ``data``, ``ckpt``, ``parallel``, ``launch``)
and ``convert`` (state carried over from the reference).  Imports torch
and numpy only, never jax or ``repro``.
"""
