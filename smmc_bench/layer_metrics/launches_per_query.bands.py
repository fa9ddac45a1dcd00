"""``launches_per_query`` of the bands cells, where it moves the bands' end-to-end
metrics: the same reading."""

from smmc_bench.layer_metrics.launches_per_query import read  # noqa: F401
