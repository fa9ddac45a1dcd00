"""The system under test: the port's public entry point for a cell, built
from its configuration and traffic mix, and its answers in the form the
comparison reads. The only module of the benchmark that imports the
port (``stock_market_monte_carlo_torch``).

Everything is named by the files: the model and the strategy are the
port's classes of those names with the files' ``args`` (a model with a
``table`` takes the returns table as ``returns_pct``), the entry point the
port's function of the traffic's ``entry`` name, called with the
configuration's sizes, the traffic's ``call`` keywords, the query's seed
and ``EngineOptions`` of the configuration's ``engine_options`` and the
traffic's ``options`` on ``device``.
"""

from __future__ import annotations

import numpy as np


class Program:
    """``program(seed)`` runs one query as a user calls it."""

    def __init__(self, config: dict, traffic: dict, table, device="cuda"):
        import stock_market_monte_carlo_torch as smt

        m, s = config["model"], traffic["strategy"]
        table_arg = {} if table is None else {"returns_pct": table}
        model = getattr(smt, m["class"])(**m.get("args", {}), **table_arg)
        strategy = getattr(smt, s["class"])(**s.get("args", {}))
        options = smt.EngineOptions(**config.get("engine_options", {}),
                                    **traffic.get("options", {}),
                                    device=device)
        entry = getattr(smt, traffic["entry"])
        kw = dict(traffic.get("call", {}), model=model,
                  n_paths=int(config["n_paths"]),
                  n_periods=int(config["n_periods"]),
                  initial_capital=float(config["initial_capital"]),
                  strategy=strategy, options=options)
        if "quantile_levels" in kw:
            kw["quantile_levels"] = tuple(kw["quantile_levels"])
        self.check = traffic["check"]
        self._call = lambda seed: entry(seed=seed, **kw)

    def __call__(self, seed: int):
        return self._call(seed)

    def answer(self, result) -> dict:
        """What the comparison reads of a query's result."""
        if self.check == "stats":
            m = result.moments
            return dict(n=m.n, mean=m.mean, std=m.std, min=m.min, max=m.max,
                        count_below=m.count_below,
                        withdrawn=m.total_withdrawn,
                        hist=np.asarray(result.histogram_counts, np.float64))
        if self.check == "bands":
            return dict(counts=np.asarray(result.month_hist, np.float64),
                        values=np.asarray(result.values, np.float64))
        raise ValueError(f"unknown check {self.check!r}")
