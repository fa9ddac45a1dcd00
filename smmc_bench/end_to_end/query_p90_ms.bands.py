"""``query_p90_ms`` of the bands cells, which the host holds back: the same
reading, bounded apart."""

from smmc_bench.end_to_end.query_p90_ms import read  # noqa: F401
