"""``paths_per_s`` of the bands cells, which the host holds back: the same
reading, bounded apart."""

from smmc_bench.end_to_end.paths_per_s import read  # noqa: F401
