"""lm_kernel_roofline (%): the RMSNorm and attention launches' least time
a round (``counts.lm_kernel_bound_s``, at the cohort's shapes) over their
measured device time a round."""
from fedbench import counts


def read(w):
    t = sum(d for n, _, d in w.kernels if counts.is_kind(n, counts.LM_KERNELS))
    if w.rounds < 1 or t == 0:
        return None
    bound = counts.lm_kernel_bound_s(w.family, w.cfg, w.traffic)
    return 100.0 * w.rounds * bound / (t / 1e9)
