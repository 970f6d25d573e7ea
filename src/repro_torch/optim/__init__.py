"""Optimizer and gradient compression (counterparts of ``repro/optim``)."""
