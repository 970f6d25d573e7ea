"""Execution plans (counterpart of ``repro/parallel``, single device)."""
