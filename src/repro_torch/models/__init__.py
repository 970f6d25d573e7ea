"""The model zoo's MoE serving path in PyTorch (counterparts of
``repro/models``): parameters, layers, MoE routing, the LM and decode."""
