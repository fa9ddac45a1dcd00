"""Per-layer metric readers: ``<name>.py`` per metric of
``BENCHMARK.json``'s ``per_layer``, each ``read(rec) -> float | None``
over a traced run's ``metrics.Records``; None where the run holds
nothing to read."""
