"""End-to-end metric readers: ``<name>.py`` per metric of
``BENCHMARK.json``'s ``end_to_end``, each ``read(rec) -> float | None``
over ``metrics.Records`` (host clock, every run)."""
