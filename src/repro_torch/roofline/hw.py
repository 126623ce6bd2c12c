"""NVIDIA H100 SXM5 80 GB hardware constants, the port's roofline target.

Source: NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: dense BF16
tensor-core peak 989.4 TFLOP/s (1,979 with sparsity), HBM3 3.35 TB/s,
NVLink 900 GB/s (both directions, so 450 GB/s each way), 80 GB of HBM.
The card the smoke (``chip_smoke.py``) runs on reports itself, through
``nvidia-smi --query-gpu=name,power.limit``, as "NVIDIA H100 80GB HBM3,
700.00 W"; a card set below 700 W runs slower under load than these
peaks.  Carries no TPU number (the reference's ``roofline/hw.py`` holds
the TPU v5e's).
"""

PEAK_FLOPS_BF16 = 989.4e12      # per card, dense bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s per card
NVLINK_BW = 450e9               # bytes/s per card, one direction
HBM_BYTES = 80 * 10 ** 9        # 80 GB per card
