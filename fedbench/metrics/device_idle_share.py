"""device_idle_share (%): the share of the window in which no device
operation ran, 1 − (union of the device's intervals / window)."""


def read(w):
    if w.window_s <= 0 or w.busy_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
