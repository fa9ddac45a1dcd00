"""The 90th percentile of the wall of every query completed in the
window, from the call until its result is on the host after a
``torch.cuda.synchronize()``, in milliseconds."""

from smmc_bench.metrics import quantile


def read(rec):
    if rec.n_queries == 0:
        return None
    return quantile(rec.walls_s, 0.9) * 1e3
