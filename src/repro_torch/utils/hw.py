"""The card's peak rates: NVIDIA H100 SXM5 80GB HBM3, data sheet figures.

The bounds the port's timings are held against (``obs/kernel_timing.py``,
the kernel table in PERF.md, ``chip_smoke.py``'s ``bound``) are the larger
of two least times: the bytes a kernel must move over the memory rate, and
its operations over the peak rate of their type. These are the data
sheet's peaks for the SXM5 part at its 700 W limit, not measurements; a
card set to a lower power limit runs below them under load.

``roofline_seconds`` is the counterpart of ``repro/utils/hw.py:317-329``
(the production dry-run's three terms, ``launch/dryrun.py``) with these
peaks in place of the TPU's. Its collective term divides by one NVLink-4
link in one direction (``NVLINK_BYTES_PER_S_PER_LINK``), the conservative
one-link figure, as the reference divides by one ICI link; ``links=
NVLINK_LINKS`` gives the card's whole NVLink rate within an 8-card node.
A 256- or 512-rank mesh spans 32 or 64 such nodes, whose traffic between
nodes runs over the network at about 50 GB/s a card (400 Gb/s), about two
links' worth: the one-link figure stays a lower bound on the time there
too.
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
# NVLink 4: 900 GB/s both directions over 18 links, 25 GB/s a link and
# direction
NVLINK_BYTES_PER_S_PER_LINK = 25e9
NVLINK_LINKS = 18


def roofline_seconds(flops: float, hbm_bytes: float, coll_bytes: float,
                     chips: int, links: int = 1):
    """The three roofline terms in seconds: ``flops`` over the bfloat16
    tensor-core peak, ``hbm_bytes`` over the HBM rate and ``coll_bytes``
    over ``links`` NVLink links (one direction each), each rate times
    ``chips``. The counts are totals over ``chips`` cards; the dry-run
    counts one rank's share and passes ``chips=1``."""
    return {
        "compute_s": flops / (chips * BF16_FLOP_PER_S),
        "memory_s": hbm_bytes / (chips * HBM_BYTES_PER_S),
        "collective_s": coll_bytes / (chips * NVLINK_BYTES_PER_S_PER_LINK
                                      * links),
    }
