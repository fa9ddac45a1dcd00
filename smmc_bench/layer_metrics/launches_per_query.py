"""Chunk wrappers and the torch epilogue: the device operations
(kernels, copies, memsets) the profiler records in the traced window,
over the queries completed."""


def read(rec):
    if not rec.traced or rec.n_queries == 0:
        return None
    lo, hi = rec.trace_window_us
    n = sum(1 for _, _, s, e in rec.device_ops if s >= lo and e <= hi)
    return n / rec.n_queries
