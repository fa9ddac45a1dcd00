"""Kernels: the least time the window's queries need on one H100
(``work/``: their operations and bytes at the published peaks), over
the device time of every kernel in the traced window, in percent."""


def read(rec):
    if not rec.traced:
        return None
    lo, hi = rec.trace_window_us
    kernel_us = sum(e - s for _, cat, s, e in rec.device_ops
                    if cat == "kernel" and s >= lo and e <= hi)
    if kernel_us <= 0 or rec.n_queries == 0:
        return None
    return 100.0 * rec.n_queries * rec.least_s_per_query / (kernel_us * 1e-6)
