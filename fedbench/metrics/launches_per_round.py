"""launches_per_round (launches/round): device kernels in the traced
window over the rounds it ran (copies and fills not counted)."""


def read(w):
    if w.rounds < 1 or not w.kernels:
        return None
    return len(w.kernels) / w.rounds
