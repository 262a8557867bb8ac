"""Share of the traced window, in %, in which no kernel, copy or memset
ran on the card."""


def read(rec):
    if rec.busy_s <= 0 or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
