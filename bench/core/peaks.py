"""The card's peaks, frozen here so that no change to the program moves
the yardstick.

NVIDIA H100 SXM5 data sheet (the values ``repro_torch/roofline/hw.py``
holds): 989 TFLOP/s dense bf16 on the tensor cores (1,979 "with
sparsity"), 3.35 TB/s of HBM3.  Both assume the full 700 W power limit;
each result line carries the card's own limit beside its numbers.
"""
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
