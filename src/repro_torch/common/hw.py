"""Target hardware constants: one NVIDIA H100 SXM (NVIDIA's H100 Tensor
Core GPU datasheet, SXM column; dense rates, without sparsity, at the
full 700 W power limit)."""
PEAK_FLOPS_BF16 = 989e12       # tensor cores, per card
HBM_BW = 3.35e12               # bytes/s per card
NVLINK_LINK_BW = 900e9 / 18    # bytes/s per NVLink 4 link (18 per card)
