"""Program spans, and the command-line verbs' timing decorator.

A span is one named interval of the program (``doppel.predict``,
``doppel.retrieval``, ...): ``span(name, **counts)`` opens one as a context
manager, and ``sp.set(**counts)`` adds counts while it is open.  Spans are
recorded exactly while a ``torch.profiler`` session is active: each then
also opens ``torch.profiler.record_function(name)``, so it lies in the
profiler's trace on the clock of the device operations, and is kept in a
bounded store in memory (``recorded()``, ``clear()``; the newest
``STORE_SPANS``).  With no profiler active a span costs one flag check.
``timed(name, **counts)`` is a span that reads its clock whatever the
profiler does: the cascade's stages fill ``stage_seconds`` from it, so a
stage's span and its ``stage_seconds`` entry are one number.

Each recorded span holds its name, its id, its parent's id (the span open
on the same thread when it opened), its call id (the id of its root span:
every span of one predict, one request's encode or one piece of
construction shares it), its thread, its start (``time.time_ns``), its
duration (``perf_counter_ns``) and its counts.  Every point where the host
blocks on the card is a span whose name ends in ``.wait``, and every CUDA
graph launch is a ``doppel.replay`` span: under the profiler a launch
blocks the host while each node of the graph is instrumented (milliseconds
for a large graph), a cost the untraced program does not pay.

``time_usage`` logs ``Elapsed time [verb]: Xh | Ym | Z.ZZs`` at INFO when
the verb ends.  With ``DOPPEL_PROFILE_DIR`` set, the verb runs under
``torch.profiler`` (CPU and, where there is a card, CUDA activity), a
Chrome trace is written into that directory, and a table of the verb's
spans by name is logged: count, total and self seconds, and each count
summed (a text count as value:spans).
"""

from __future__ import annotations

import functools
import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from torch.autograd import profiler as _profiler

LOGGER = logging.getLogger(__name__)

STORE_SPANS = 65_536


class Span:
    """One interval of the program; see the module's docstring."""

    __slots__ = ("name", "id", "parent", "call", "thread", "start_ns", "duration_ns", "counts",
                 "_recorder", "_t0", "_rf")

    def __init__(self, recorder: Optional["Recorder"], name: str, counts: Dict):
        self.name = name
        self.counts = counts
        self._recorder = recorder             # None: timed, not recorded
        self.duration_ns: Optional[int] = None

    def set(self, **counts) -> None:
        self.counts.update(counts)

    @property
    def seconds(self) -> float:
        """The span's duration, or while it is open the time since it opened."""
        ns = self.duration_ns if self.duration_ns is not None else time.perf_counter_ns() - self._t0
        return ns / 1e9

    def __enter__(self) -> "Span":
        rec = self._recorder
        if rec is not None:
            stack = rec._stack()
            parent = stack[-1] if stack else None
            self.id = next(rec._ids)
            self.parent = parent.id if parent is not None else None
            self.call = parent.call if parent is not None else self.id
            self.thread = threading.get_ident()
            stack.append(self)
            self._rf = _profiler.record_function(self.name)
            # read before the range opens: the profiler's first range of a
            # session sets itself up before it reads its own start
            self.start_ns = time.time_ns()
            self._t0 = time.perf_counter_ns()
            self._rf.__enter__()
        else:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.duration_ns = time.perf_counter_ns() - self._t0
        rec = self._recorder
        if rec is not None:
            self._rf.__exit__(*exc)
            self._rf = None
            rec._stack().pop()
            rec._store.append(self)


class _Off:
    """What ``span`` gives while nothing records: a context that does nothing."""

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **counts) -> None:
        return None


_OFF = _Off()


class Recorder:
    """A bounded store of finished spans and a stack of open ones per thread."""

    def __init__(self, bound: int = STORE_SPANS):
        self._store: deque = deque(maxlen=bound)
        self._local = threading.local()
        self._ids = itertools.count(1)

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **counts):
        """A span, recorded while a profiler session is active, else nothing."""
        if not _profiler._is_profiler_enabled:
            return _OFF
        return Span(self, name, counts)

    def timed(self, name: str, **counts) -> Span:
        """A span whose ``seconds`` are read whether or not it is recorded."""
        return Span(self if _profiler._is_profiler_enabled else None, name, counts)

    def recorded(self) -> List[Span]:
        return list(self._store)

    def clear(self) -> None:
        self._store.clear()


_RECORDER = Recorder()
span = _RECORDER.span
timed = _RECORDER.timed
recorded = _RECORDER.recorded
clear = _RECORDER.clear


def self_seconds(spans: Sequence[Span]) -> Dict[str, Tuple[int, float, float]]:
    """{name: (count, total seconds, self seconds)}: a span's self seconds
    are its duration less its child spans' (children run one after another
    on their parent's thread)."""
    child_ns: Dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.duration_ns
    out: Dict[str, List] = {}
    for s in spans:
        row = out.setdefault(s.name, [0, 0, 0])
        row[0] += 1
        row[1] += s.duration_ns
        row[2] += s.duration_ns - child_ns.get(s.id, 0)
    return {n: (c, t / 1e9, own / 1e9) for n, (c, t, own) in out.items()}


def count_totals(spans: Sequence[Span]) -> Dict[str, Dict[str, object]]:
    """{name: {count: total}}: a numeric count summed over the spans of a
    name; a text count (``path``, ``wave``, ``graph``) as {value: spans}."""
    out: Dict[str, Dict[str, object]] = {}
    for s in spans:
        row = out.setdefault(s.name, {})
        for key, v in s.counts.items():
            if isinstance(v, str):
                tally = row.setdefault(key, {})
                tally[v] = tally.get(v, 0) + 1
            else:
                row[key] = row.get(key, 0) + v
    return out


def span_table(spans: Sequence[Span]) -> str:
    """The spans by name, as ``self_seconds`` counts them, longest total
    first, each with its counts as ``count_totals`` sums them."""
    rows = sorted(self_seconds(spans).items(), key=lambda kv: -kv[1][1])
    counts = count_totals(spans)
    width = max([len(n) for n, _ in rows] + [4])

    def shown(row: Dict[str, object]) -> str:
        return " ".join(
            f"{k}=" + (",".join(f"{v}:{c}" for v, c in sorted(t.items()))
                       if isinstance(t, dict) else str(t))
            for k, t in row.items())

    lines = [f"{'span':<{width}} {'count':>7} {'total s':>10} {'self s':>10}  counts"]
    lines += [f"{n:<{width}} {c:>7} {t:>10.4f} {own:>10.4f}  {shown(counts[n])}".rstrip()
              for n, (c, t, own) in rows]
    return "\n".join(lines)


def _profiled(profile_dir: str, name: str, call):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    since = time.time_ns()
    with torch.profiler.profile(activities=acts) as prof:
        result = call()
    trace = os.path.join(profile_dir, f"{name}.{os.getpid()}.{int(time.time())}.trace.json")
    prof.export_chrome_trace(trace)
    LOGGER.info("profiler trace written to %s", trace)
    LOGGER.info("program spans of [%s]:\n%s", name,
                span_table([s for s in recorded() if s.start_ns >= since]))
    return result


def time_usage(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        profile_dir = os.environ.get("DOPPEL_PROFILE_DIR")
        start = time.time()
        if profile_dir:
            result = _profiled(profile_dir, func.__name__, lambda: func(*args, **kwargs))
        else:
            result = func(*args, **kwargs)
        elapsed = time.time() - start
        hours, rem = divmod(elapsed, 3600)
        minutes, seconds = divmod(rem, 60)
        LOGGER.info(
            "Elapsed time [%s]: %dh | %dm | %.2fs",
            func.__name__, int(hours), int(minutes), seconds,
        )
        return result

    return wrapper
