"""Reading a ``torch.profiler`` session in memory: the device's busy time,
the host's launch calls, the device operations that took most time and the
longest idle gaps by what the benchmark's host was doing.

The benchmark marks its own host spans with ``record_function`` names
starting ``bench.`` (``bench.encode``, ``bench.predict``, ``bench.wait``,
``bench.request``); the traced window runs from the first such span's start
to the last one's end.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch")
SPAN_PREFIX = "bench."
# a device operation's name as reported (templated kernel names run long)
NAME_CHARS = 200


@dataclass
class TraceReading:
    window_s: float = 0.0
    busy_s: float = 0.0
    launches: int = 0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def read_events(events) -> TraceReading:
    """``events``: the profiler's kineto events (``prof.profiler.
    kineto_results.events()``): objects with name(), start_ns(),
    duration_ns() and device_type()."""
    spans, device, launches = [], [], []
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            # the device-side copy of a host annotation spans work, it is none
            if not (name.startswith(SPAN_PREFIX) or e.is_user_annotation()):
                device.append((name[:NAME_CHARS], start, end))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, start, end))
        elif name in LAUNCH_CALLS:
            launches.append(start)
    out = TraceReading()
    if not spans:
        return out
    w0 = min(s for _, s, _ in spans)
    w1 = max(e for _, _, e in spans)
    out.window_s = (w1 - w0) / 1e9
    busy = _merge([(max(s, w0), min(e, w1)) for _, s, e in device if e > w0 and s < w1])
    out.busy_s = sum(e - s for s, e in busy) / 1e9
    out.launches = sum(1 for t in launches if w0 <= t <= w1)
    by_name: Dict[str, int] = defaultdict(int)
    for name, s, e in device:
        if e > w0 and s < w1:
            by_name[name] += min(e, w1) - max(s, w0)
    out.device_ops = [(n, t / 1e9) for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    inner = sorted(spans, key=lambda sp: sp[2] - sp[1])           # innermost span first
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) // 2
        label = next((n for n, s, e in inner if s <= mid <= e and n != "bench.request"),
                     next((n for n, s, e in inner if s <= mid <= e), "bench.outside"))
        out.idle_gaps.append((label, (g1 - g0) / 1e9))
    return out
