"""The model zoo's MoE path in PyTorch (counterparts of ``repro/models``):
parameters, layers, MoE routing, the LM with its loss, and decode."""
