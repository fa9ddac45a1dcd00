"""Paths per second: every path of every query completed in the window,
over the window's seconds (from its start to the last query's result on
the host)."""


def read(rec):
    if rec.n_queries == 0:
        return None
    return rec.n_queries * rec.paths_per_query / rec.window_s
