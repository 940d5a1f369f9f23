"""Kernel A's share of its roofline on the served folded requests: the least
time the card needs to score every traced request that reached the device,
over kernel A's device time in the profiled slice.

A request reaches the device where the program records a ``doppel.fused``
span with ``folded`` 1; each scores one folded block against the whole
truth database, whose bytes are ``benchmark/roofline.py``'s folded term:
``fold_hashes · fold_dim · truth_titles / 8`` occupancy bytes (the cell's
configuration), 64 MB or 19.1 µs at ``PEAK_BYTES`` for 500,000 titles.  The
operations term is left out: at most 2 × 506 weighted buckets × 500,000
titles, 0.5 µs at the bfloat16 peak, under 3 % of the bytes term.  A's time
is the sum of the slice's device operations named ``score_window_kernel``
(the ten longest are kept, and A is the longest by far).  None where the
run has no trace, no such span, no such operation or no configuration."""

from benchmark import roofline
from benchmark.catalog import Catalog
from benchmark.spans import program_spans

KERNEL = "score_window_kernel"


def read(run):
    t = run.trace
    if run.kind != "serve" or t is None:
        return None
    a_s = sum(s for name, s in t.device_ops if KERNEL in name)
    blocks = sum(1 for s in program_spans(run) if s.name == "doppel.fused" and s.counts.get("folded") == 1)
    if a_s <= 0 or not blocks:
        return None
    cat = Catalog()
    try:
        config = cat.config(cat.workload(run.cell)["config"])
    except (KeyError, FileNotFoundError):
        return None
    m = config["matcher"]
    block_bytes = int(m["fold_hashes"]) * int(m["fold_dim"]) * int(config["truth_titles"]) / 8
    least = roofline.least_seconds([(0.0, blocks * block_bytes)], config["precision"]["coarse"])
    return 100.0 * least / a_s
