"""device_idle: the share of the traced window in which no kernel, copy
or set ran on the card, in percent."""


def read(r, records):
    if r.busy_s <= 0 or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
