"""NVIDIA H100 SXM5 hardware constants (the port's target card).

Sources: NVIDIA H100 Tensor Core GPU data sheet (SXM5 column) for the
card; NVIDIA DGX H100 / HGX H100 system specifications for the node.
``chip_smoke.py`` holds the same three card rates (its bounds); a CPU test
keeps the two in step.
"""

#: dense bf16 tensor-core peak (data sheet: 1,979 TFLOP/s "with sparsity",
#: half of it dense)
PEAK_FLOPS_BF16 = 989e12
#: fp32 outside the tensor cores (data sheet: FP32 67 TFLOP/s)
PEAK_FLOPS_FP32 = 67e12
#: HBM3 bandwidth (data sheet: 3.35 TB/s)
HBM_BW = 3.35e12
#: HBM capacity (data sheet: 80 GB)
HBM_BYTES = 80e9

#: GPUs per node joined all to all by NVLink through NVSwitch (DGX H100)
GPUS_PER_NODE = 8
#: NVLink 4 bandwidth per GPU, one direction (data sheet: 900 GB/s, the
#: two directions together) — the ring's rate within a node
NVLINK_BW = 450e9
#: InfiniBand per GPU across nodes, one direction (DGX H100: one 400 Gb/s
#: NDR ConnectX-7 port per GPU) — the ring's rate over the "pod" axis or
#: any group wider than a node
IB_BW = 50e9
