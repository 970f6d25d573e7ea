"""Shared setup of the port's benchmarks and examples (copies of
``benchmarks/common.py``)."""
