"""The switch engines of ``auto`` mode (serial, staged, affine): CUDA
source, launchers, plain versions, ops."""
