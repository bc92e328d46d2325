"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``) and
their plain PyTorch versions."""
