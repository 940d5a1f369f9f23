"""Reading the program's own spans (``doppelspeller_tpu_torch.utils.timing``)
after a run.

The program records spans only while a ``torch.profiler`` session runs, so
what a run leaves in its store is the traced slice: the last predicts or
requests of a ``--trace 1`` run.  A program that records no spans (one
older than its recorder) leaves nothing, and every reader here then
returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional

WAIT = ".wait"
# a CUDA graph's launch: under the profiler it blocks the host for
# milliseconds while each node of the graph is instrumented, a cost the
# untraced program does not pay (its launch takes microseconds)
REPLAY = "doppel.replay"


def program_spans(run) -> list:
    """The spans the program recorded since the run's process started."""
    try:
        from doppelspeller_tpu_torch.utils.timing import recorded
    except ImportError:
        return []
    t0 = int(run.t_start * 1e9)
    return [s for s in recorded() if s.start_ns >= t0]


def children(spans: list) -> Dict[int, list]:
    out: Dict[int, List] = {}
    for s in spans:
        if s.parent is not None:
            out.setdefault(s.parent, []).append(s)
    return out


def off_host_ns(span, kids: Dict[int, list]) -> int:
    """Nanoseconds under ``span`` in which the host waited on the card
    (``.wait`` spans) or launched a graph (``doppel.replay``)."""
    total = 0
    for c in kids.get(span.id, []):
        off = c.name.endswith(WAIT) or c.name == REPLAY
        total += c.duration_ns if off else off_host_ns(c, kids)
    return total


def host_seconds(span, kids: Dict[int, list]) -> float:
    """A span's seconds less its waits on the card and its graph launches."""
    return (span.duration_ns - off_host_ns(span, kids)) / 1e9


def stage_host_s(run, stage: str) -> Optional[float]:
    """Mean over the traced predicts of stage ``doppel.<stage>``'s host
    seconds (a batch cell's)."""
    if run.kind != "batch":
        return None
    spans = program_spans(run)
    kids = children(spans)
    vals = [host_seconds(s, kids) for s in spans if s.name == f"doppel.{stage}"]
    return sum(vals) / len(vals) if vals else None
