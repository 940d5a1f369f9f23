"""The one traffic generator: reads a mix's parameters and draws its
queries from the world's stream.

A mix file holds:

- ``loop``: ``"closed"`` (one caller: the next predict after the last
  returns) or ``"open"`` (single titles arriving on a schedule, whatever
  the server's state);
- closed: ``pool_batches``, distinct batches the caller cycles through,
  each of the configuration's ``batch_queries`` titles (the deployment's
  batch, so that its size and any cut of it sit in one file);
- open: ``rate_per_s``; the run holds round(rate · seconds) requests whose
  gaps are the exponential distribution's quantiles (i + 0.5) / n at that
  rate, in an order drawn from the seed, so every seed offers the same
  arrivals in another order;
- ``mix``: the shares of ``exact`` copies, ``misspelled`` truth titles and
  ``absent`` titles;
- ``profile`` (optional): ``"latency"`` builds the matcher as ``serve
  --profile latency`` does;
- ``sample``: how many of the window's queries (closed: distinct rows of
  the pool) are held against the reference;
- ``trace_units``: predicts (closed) or requests (open) that the profiler
  covers at the end of a traced window.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from benchmark.world import World


@dataclass
class Traffic:
    loop: str
    pool: List[List[str]] = field(default_factory=list)          # closed: batches of raw titles
    pool_actual: List[List[int]] = field(default_factory=list)
    sample_rows: List[np.ndarray] = field(default_factory=list)  # closed: rows of each batch held
    requests: List[str] = field(default_factory=list)            # open: every request's raw title
    actual: List[int] = field(default_factory=list)
    due: np.ndarray = field(default_factory=lambda: np.zeros(0))  # open: seconds after the start
    n_window: int = 0                                            # open: requests in the window
    sample: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    trace_units: int = 0
    profile: str = ""


def check_mix(mix: Dict[str, float]) -> None:
    total = float(mix["exact"]) + float(mix["misspelled"]) + float(mix["absent"])
    if abs(total - 1.0) > 1e-9:
        raise ValueError(f"mix shares sum to {total}, not 1")


def make_traffic(world: World, spec: Dict, seconds: float, seed: int,
                 batch_queries: Optional[int] = None) -> Traffic:
    check_mix(spec["mix"])
    rng = np.random.default_rng([seed, 7])
    out = Traffic(loop=spec["loop"], trace_units=int(spec.get("trace_units", 0)),
                  profile=spec.get("profile", ""))
    n_sample = int(spec["sample"])
    if spec["loop"] == "closed":
        if batch_queries is None:
            raise ValueError("a closed-loop mix takes its batch size from the configuration's batch_queries")
        n = int(batch_queries)
        pool = int(spec["pool_batches"])
        for _ in range(pool):
            titles, actual = world.queries(n, spec["mix"])
            out.pool.append(titles)
            out.pool_actual.append(actual)
        per = -(-n_sample // pool)
        out.sample_rows = [np.sort(rng.choice(n, size=min(per, n), replace=False)) for _ in range(pool)]
        return out
    if spec["loop"] != "open":
        raise ValueError(f"unknown loop {spec['loop']!r}")
    rate = float(spec["rate_per_s"])
    n = int(round(rate * seconds))
    total = n + out.trace_units
    out.requests, out.actual = world.queries(total, spec["mix"])
    gaps = -np.log1p(-(np.arange(total) + 0.5) / total) / rate
    gaps = gaps[rng.permutation(total)]
    out.due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    out.n_window = n
    out.sample = np.sort(rng.choice(n, size=min(n_sample, n), replace=False))
    return out
