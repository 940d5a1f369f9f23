"""A tiny catalog of cells for the CPU tests: the real configurations cut to
4,000 truth titles, batches of 256 queries (the model waves forced, as a
batch of 2,048 rows past the exact stage would take them) and a few
single titles, each with the limits of the real cell it stands for."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from benchmark.catalog import BENCH_DIR, ROOT, Catalog

# tiny cell -> (real config, retrieval mode, traffic, real cell whose limits it takes)
TINY = {
    "tiny-exact.batch": ("titles-30k", "auto", "tiny-batch", "titles-30k.batch"),
    "tiny-folded.batch": ("titles-500k", "folded", "tiny-batch", "titles-500k.batch"),
    "tiny-exact.serve": ("titles-30k", "auto", "tiny-serve", "titles-30k.serve"),
    "tiny-folded.serve": ("titles-500k", "folded", "tiny-serve", "titles-30k.serve"),
}
TRAFFIC = {
    "tiny-batch": {"loop": "closed", "pool_batches": 2,
                   "mix": {"exact": 0.1, "misspelled": 0.5, "absent": 0.4}, "sample": 48,
                   "trace_units": 1},
    "tiny-serve": {"loop": "open", "rate_per_s": 40, "profile": "latency",
                   "mix": {"exact": 0.1, "misspelled": 0.5, "absent": 0.4}, "sample": 24,
                   "trace_units": 4},
}


def _load(kind: str, name: str) -> Dict:
    with open(os.path.join(BENCH_DIR, kind, name + ".json")) as f:
        return json.load(f)


def tiny_catalog(root: str, limits: Optional[Dict[str, float]] = None) -> Catalog:
    """A catalog over ``root`` holding the tiny cells, searched before the
    benchmark's own folders."""
    for kind in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, kind), exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"] = []
    for cell, (config, mode, traffic, real) in TINY.items():
        cfg = _load("configs", config)
        cfg["truth_titles"] = 4000
        cfg["batch_queries"] = 256
        cfg["matcher"] = dict(cfg["matcher"], retrieval_mode=mode, cascade_impl="device")
        name = cell.split(".")[0]
        with open(os.path.join(root, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(root, "limits", cell + ".json"), "w") as f:
            json.dump(limits or _load("limits", real), f)
        spec["workloads"].append({"name": cell, "config": name, "traffic": traffic, "chips": 1,
                                  "why": "a CPU test"})
    for name, mix in TRAFFIC.items():
        with open(os.path.join(root, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    path = os.path.join(root, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return Catalog(path, [root, BENCH_DIR])


def one_thread():
    import torch

    torch.set_num_threads(1)


class _Unhooked:
    """Forwards every attribute to ``inner`` but drops assignments to
    ``names``: a harness hook set there no longer reaches the path."""

    def __init__(self, inner, names):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_names", names)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        if name not in self._names:
            setattr(self._inner, name, value)


def unhooked(matcher):
    """Retrieval no longer passes the harness's hooks (as after a program
    change that reroutes it): no candidates are copied out of the path."""
    matcher.scorer = _Unhooked(matcher.scorer, ("topk_device",))
    fused = _Unhooked(matcher._fused_engine(), ("dispatch",))
    matcher._fused_engine = lambda: fused
