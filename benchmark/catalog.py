"""Finds every part of a cell by its name.

``BENCHMARK.json`` (at the checkout's root) names the cells, the metrics and
the configurations.  The rest is data found by name under the benchmark's
folders, so that a new configuration, traffic mix, metric or cell is a new
file and a new entry, never an edit:

- ``configs/<config>.json``: the deployment (truth size, the matcher's
  settings, the precision it states);
- ``traffic/<mix>.json``: closed or open loop, its size or rate, the mix;
- ``metrics/<metric>.py``: a function ``read(run)`` that returns the
  metric's value from a finished run, or None where the run has nothing to
  read;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


class Catalog:
    """The benchmark's spec and the folders its parts are found in (the
    first folder holding a part wins)."""

    def __init__(self, spec_path: Optional[str] = None, dirs: Sequence[str] = (BENCH_DIR,)):
        with open(spec_path or os.path.join(ROOT, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.dirs = list(dirs)

    def _find(self, kind: str, name: str, ext: str) -> str:
        for d in self.dirs:
            path = os.path.join(d, kind, name + ext)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"no {kind}/{name}{ext} under {self.dirs}")

    def _json(self, kind: str, name: str) -> Dict:
        with open(self._find(kind, name, ".json")) as f:
            return json.load(f)

    def workload(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> Dict[str, float]:
        return self._json("limits", cell)

    def metrics(self, section: str, cell: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
        return [m for m in self.spec[section] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable:
        path = self._find("metrics", metric, ".py")
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(path)}_{abs(hash(path))}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
