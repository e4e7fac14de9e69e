"""The general generator of open-loop traffic, from a mix's parameters.

A mix file (``traffic/<mix>.json``) with ``"loop": "open"`` gives:

- ``rate_per_s``: requests a second, offered whatever the server does;
- ``arrivals``: ``"poisson"`` (exponential gaps) or ``"fixed"`` (even
  gaps);
- ``rows``: ``{"dist": "log_uniform", "max": M}``, a request's rows
  ``int(M ** u)`` for u uniform in [0, 1), from 1 to M; or
  ``{"dist": "fixed", "rows": R}``;
- ``queries``: ``"uniform_box"``, each query uniform in the index's box
  [0, 1)^D.

Every seed gets the same set of gaps and sizes, in another order: the i-th
of m requests takes the quantile (i + 0.5) / m of each distribution, and
the seed shuffles both lists. So the work and the schedule's length are
the seed's only through their order, and a request's queries are drawn
from (seed, i). Imports numpy only.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, *parts: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *parts])


def schedule(mix: dict, seconds: float, seed: int) -> dict:
    """``{"due": float64[m] seconds after the start, "rows": int64[m]}``,
    m = round(rate * seconds) requests."""
    rate = float(mix["rate_per_s"])
    m = max(1, int(round(rate * seconds)))
    u = (np.arange(m) + 0.5) / m
    if mix.get("arrivals", "poisson") == "poisson":
        gaps = -np.log1p(-u) / rate
    else:
        gaps = np.full(m, 1.0 / rate)
    rows_spec = mix["rows"]
    if rows_spec["dist"] == "log_uniform":
        rows = np.floor(float(rows_spec["max"]) ** u).astype(np.int64)
    else:
        rows = np.full(m, int(rows_spec["rows"]), np.int64)
    rng = _rng(seed, 1)
    gaps = rng.permutation(gaps)
    rows = rng.permutation(np.clip(rows, 1, None))
    return {"due": np.cumsum(gaps) - gaps[0], "rows": rows}


def request_queries(mix: dict, seed: int, i: int, rows: int, dim: int
                    ) -> np.ndarray:
    """f32[rows, dim]: the queries of request ``i``."""
    if mix.get("queries", "uniform_box") != "uniform_box":
        raise ValueError(f"unknown query distribution {mix['queries']!r}")
    return _rng(seed, 2, int(i)).random((int(rows), dim), dtype=np.float32)


def sampled_requests(sched: dict, count: int, seed: int) -> list[int]:
    """Requests whose answers the reference checks: ``count`` drawn from
    the seed, and the one with the most rows."""
    m = len(sched["rows"])
    pick = set(_rng(seed, 3).choice(m, size=min(count, m), replace=False)
               .tolist())
    pick.add(int(np.argmax(sched["rows"])))
    return sorted(pick)
