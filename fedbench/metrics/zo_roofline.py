"""zo_roofline (%): the ZO kernels' least time a round
(``counts.zo_bound_s``, from the algorithm's shapes) over their measured
device time a round."""
from fedbench import counts


def read(w):
    t = sum(d for n, _, d in w.kernels if counts.is_kind(n, counts.ZO_KERNELS))
    if w.rounds < 1 or t == 0:
        return None
    d = counts.param_count(w.family, w.cfg)
    return 100.0 * w.rounds * counts.zo_bound_s(w.traffic, d) / (t / 1e9)
