"""The card's peak rates: NVIDIA H100 SXM5 80GB HBM3, data sheet figures.

The bounds the port's timings are held against (``obs/kernel_timing.py``,
the kernel table in PERF.md, ``chip_smoke.py``'s ``bound``) are the larger
of two least times: the bytes a kernel must move over the memory rate, and
its operations over the peak rate of their type. These are the data
sheet's peaks for the SXM5 part at its 700 W limit; a card set to a lower
power limit runs below them under load.
"""
from __future__ import annotations

# HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores: 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz
FP32_FLOP_PER_S = 67e12
# bfloat16 on the tensor cores, dense
BF16_FLOP_PER_S = 989e12
# device memory
HBM_CAPACITY_BYTES = 80 * 2**30
