"""device_idle_pct: the share of the traced window with no operation on
the card (the union of the device records' intervals), in percent."""


def read(trace):
    if trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
