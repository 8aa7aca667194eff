"""round_mfu (%): the window's model FLOPs over what the card's float32
peak gives in the window. FLOPs are the forwards' (H·(b2 + 1) cohort
forwards a round, each the configuration's ``forward_flops`` of every
client's rows); ZO kernel work is not model work."""
from fedbench import counts


def read(w):
    if w.rounds < 1 or w.window_s <= 0:
        return None
    flops = w.rounds * counts.flops_per_round(w.family, w.cfg, w.traffic)
    return 100.0 * flops / (w.window_s * counts.FP32_FLOP_PER_S)
