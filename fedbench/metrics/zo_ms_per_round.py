"""zo_ms_per_round (ms/round): device time of the ZO kernels (zo_walk,
zo_replay, the direction norms, aircomp_reduce) over the rounds."""
from fedbench import counts


def read(w):
    t = sum(d for n, _, d in w.kernels if counts.is_kind(n, counts.ZO_KERNELS))
    if w.rounds < 1 or t == 0:
        return None
    return t / 1e6 / w.rounds
