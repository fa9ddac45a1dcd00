"""``host_gap_ms`` of the bands cells, where it moves the bands' end-to-end
metrics: the same reading."""

from smmc_bench.layer_metrics.host_gap_ms import read  # noqa: F401
