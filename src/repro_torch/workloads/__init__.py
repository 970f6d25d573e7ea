"""Workload generators (copies of ``repro.workloads``)."""
