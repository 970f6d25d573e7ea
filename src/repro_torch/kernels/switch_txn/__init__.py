"""The switch-transaction kernels: CUDA source, build, launchers, ops."""
