"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``),
their wrappers and their plain PyTorch versions."""
