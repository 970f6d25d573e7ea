"""The benchmark of the PyTorch/CUDA P4DB port (``repro_torch``): one
command, ``python3 p4bench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``, driven by the cells, configurations, traffic mixes
and per-layer metrics named in ``BENCHMARK.json`` and found here by name."""
