"""model_ms_per_round (ms/round): device time of every kernel that is not
a ZO kernel (the cohort's forwards: GEMMs, RMSNorm, attention, the scan,
elementwise work) over the rounds."""
from fedbench import counts


def read(w):
    t = sum(d for n, _, d in w.kernels
            if not counts.is_kind(n, counts.ZO_KERNELS))
    if w.rounds < 1 or t == 0:
        return None
    return t / 1e6 / w.rounds
