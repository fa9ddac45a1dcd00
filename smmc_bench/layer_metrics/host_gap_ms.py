"""Host chunk loop, merge and host analytics: the traced window's wall
less its device-busy union, over the queries completed, in
milliseconds."""

from smmc_bench.metrics import device_window


def read(rec):
    if not rec.traced or rec.n_queries == 0:
        return None
    window, busy = device_window(rec)
    return (window - busy) * 1e3 / rec.n_queries
