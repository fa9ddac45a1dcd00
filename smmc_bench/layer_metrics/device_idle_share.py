"""Device: 1 - (the union of every device operation's interval in the
traced window) / (the window)."""

from smmc_bench.metrics import device_window


def read(rec):
    if not rec.traced:
        return None
    window, busy = device_window(rec)
    return 1.0 - busy / window
