"""``roofline_share`` of the bands cells, where it moves the bands' end-to-end
metrics: the same reading."""

from smmc_bench.layer_metrics.roofline_share import read  # noqa: F401
