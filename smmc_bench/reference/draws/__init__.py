"""The draws of the reference, one module a configuration's
``model["draw"]``: ``growth_fn(model, table, base, tile0, n_tiles,
device)`` returns ``growth(t)``, the (n_tiles, 64, 128) float32 growth
factors of month t of those tiles' paths under stream ``base``; ``table``
is the padded growth table (``stream.pad_table``) on ``device``, or None
for a model without one. ``model["n_table"]`` holds the table's rows."""
