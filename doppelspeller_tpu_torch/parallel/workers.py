"""The host side of running on cards: ``Workers``, and the rows they split.

One implementation serves one device and a mesh alike.  ``Workers`` drives
a ``Mesh``, a tuple of devices, one shard each: one host thread per
distinct device issues its shards' work under that device, on a stream
per shard, and the caller's stream waits on the shards' events, never on
the host.  A single device is a mesh of one shard (``ops/jaccard.py``'s
``JaccardScorer``: the same groups and graphs, and no merge), whose work
the caller's thread issues itself, on the shard's stream: with no other
shard to overlap, a hand-off to a thread would only cost.  The
title-sharded mesh (``parallel/sharded.py``) has a shard per entry.  So
the port has one cache of CUDA graphs, the batch stages' and the
one-dispatch path's (``ops/serve_fused.py``) alike, and one op-by-op
switch, ``use_graphs``.

On a card each shard keeps CUDA graphs, in a memory pool of its own.  A
batch stage's key runs op by op through the caller-level run (``run``: a
predict, a retrieval, a run of rows) that first uses it, and is captured in
a later run (``due``), so work that a process does once, a one-shot
``generate-predictions`` or a training's retrieval, pays no capture; the
one-dispatch path, whose keys recur request after request, captures at a
key's first request.  A capture runs while every worker is idle, after a
device synchronize, and leaves the caching allocators alone
(``torch.cuda.graph`` would empty them, and every later allocation would be
a fresh ``cudaMalloc``).  A graph's outputs are overwritten by the shard's next
replay, so every caller copies them out on the shard's stream first.  A
capture or replay that fails raises; nothing falls back to running op by
op.

``row_parallel`` splits rows over the shards (``replicate`` gives each
distinct device a copy of an engine): the fuzzy and model stages of
``pipeline.Matcher``, each run of rows padded to a power of two of at
least 64 and run as a graph on a card from the second run that uses its
shape.
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from doppelspeller_tpu_torch.device import resolve_device
from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
from doppelspeller_tpu_torch.utils import timing


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices its shards run on, in shard order (one
    device may appear more than once), and the name of its axis."""

    devices: Tuple[torch.device, ...]
    axis: str = "titles"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        devs = []
        for d in self.devices:
            d = resolve_device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        object.__setattr__(self, "devices", tuple(devs))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """Each device once, in the order of its first shard."""
        return tuple(dict.fromkeys(self.devices))


# ------------------------------------------------------------- the workers

class ShardError(RuntimeError):
    """An exception raised on a shard's worker, raised again in the caller:
    the message names the shard and its device; ``__cause__`` is the
    original."""

    def __init__(self, shard: int, device: torch.device, exc: BaseException):
        super().__init__(f"shard {shard} on {device}: {type(exc).__name__}: {exc}")
        self.shard = shard
        self.device = device


Done = Tuple[Any, Optional[torch.cuda.Event]]


@dataclass
class _Graph:
    """One shard's captured program: the graph, its static inputs and
    outputs, and the kernel launches one replay makes."""

    graph: Any
    static_in: Tuple[torch.Tensor, ...]
    out: Tuple[torch.Tensor, ...]
    launches: List[int]


class Workers:
    """A mesh's host side (a single device's too, as a mesh of one shard):
    one thread per distinct device, and on a card one stream per shard (two
    shards of one card: two streams).

    ``submit(job, shards)`` hands each card's shards to its thread, which
    calls ``job(device, shard indices)`` for a dict {shard: result} (a
    mesh of one shard calls it on the caller's thread);
    ``collect`` reads every card's result and raises the error of the
    lowest shard that failed.  Inside a job, ``on(i)`` makes shard i's
    device and stream current and names the shard in any error
    (``ShardError``).  ``fork`` orders the shards' streams after the
    caller's work; ``to_first`` moves the shards' results to the first
    device on the caller's stream, after the event each shard recorded.
    The threads start at first use and end with ``close``.

    On a card each shard keeps CUDA graphs (``graphs``, keyed by (shard,
    key), ``key[0]`` a name: ``topk``, ``FuzzyEngine``, ``RerankEngine``
    or ``FusedServe``), in a memory pool of its own: ``due`` says
    whether a key not captured yet is captured now (a run before this one
    used it) or run op by op, ``capture`` makes one and ``replay`` runs
    it; ``captures`` and ``replays`` count them by name and shard, and
    ``capture_seconds`` sums by name the host seconds of the captures
    (their warm-ups included).
    ``use_graphs = False`` (the reference the graphs are held to) runs
    every step op by op instead."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.first = mesh.devices[0]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in mesh.devices]
        self._threads: Dict[torch.device, ThreadPoolExecutor] = {}
        self.use_graphs = True
        self.graphs: Dict[Tuple[int, tuple], _Graph] = {}
        self._pools: Dict[int, Any] = {}
        self.captures: Dict[str, List[int]] = {}
        self.replays: Dict[str, List[int]] = {}
        self.capture_seconds: Dict[str, float] = {}
        self._runs = self._depth = 0
        self._first_run: Dict[Tuple[int, tuple], int] = {}

    @property
    def graphed(self) -> bool:
        """Whether steps run as CUDA graphs: on a card, unless switched off."""
        return self.use_graphs and self.first.type == "cuda"

    @contextlib.contextmanager
    def run(self):
        """A caller-level run: a predict, or a retrieval or a run of rows
        called alone; the runs nested in it are part of it."""
        self._runs += self._depth == 0
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    def due(self, i: int, key: tuple) -> bool:
        """For a key that shard i has no graph of yet: whether a run before
        this one used it, so that it is captured now (in the run that
        first uses it, it runs op by op)."""
        return self._first_run.setdefault((i, key), self._runs) < self._runs

    def capture(self, i: int, key: tuple, fn: Callable[..., Tuple[torch.Tensor, ...]],
                inputs: Sequence[torch.Tensor], rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, ...]:
        """Called with every worker idle (after ``fork``): on shard i's
        thread, ``fn`` runs op by op on copies of ``inputs`` on its device
        (the warm-up; its outputs are returned), then, after a device
        synchronize, is captured as the graph (i, key), those copies its
        static inputs; ``rows`` (the first input's by default) is the
        ``doppel.capture`` span's count."""
        def job(d, _idx):
            with self.on(i) as stream:
                static = tuple(x.to(d, copy=True) for x in inputs)
                out = fn(*static)
                if i not in self._pools:
                    self._pools[i] = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()

                def capture():
                    with timing.span("doppel.capture.wait"):
                        torch.cuda.synchronize(d)
                    graph.capture_begin(self._pools[i], capture_error_mode="thread_local")
                    try:
                        return fn(*static)
                    finally:
                        graph.capture_end()

                g_out, launches = jk.uncounted(capture)
                self.graphs[i, key] = _Graph(graph, static, g_out, launches)
                self.captures.setdefault(key[0], [0] * self.mesh.size)[i] += 1
            return {i: out}

        rows = int(inputs[0].shape[0]) if rows is None else rows
        with timing.timed("doppel.capture", graph=key[0], rows=rows) as sp:
            out = self.collect(self.submit(job, [i]))[i]
        self.capture_seconds[key[0]] = self.capture_seconds.get(key[0], 0.0) + sp.seconds
        return out

    def replay(self, i: int, key: tuple, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """On shard i's thread, under ``on(i)`` (a mesh of one: on the
        caller's stream too, as the one-dispatch path replays): ``inputs``
        copied into the leading rows of graph (i, key)'s static inputs (the
        rows past them keep earlier valid rows; a pinned host input, without
        blocking), one replay.  Returns its static outputs, valid until the
        shard's next replay."""
        g = self.graphs[i, key]
        for dst, x in zip(g.static_in, inputs):
            dst[: x.shape[0]].copy_(x, non_blocking=True)
        with timing.span("doppel.replay", graph=key[0]):
            g.graph.replay()
        jk.count_replay(g.launches)
        self.replays.setdefault(key[0], [0] * self.mesh.size)[i] += 1
        return g.out

    def drop(self, *names: str) -> None:
        """Forget the graphs whose key is named one of ``names``."""
        for k in [k for k in self.graphs if k[1][0] in names]:
            del self.graphs[k]

    @contextlib.contextmanager
    def on(self, i: int):
        """Shard i's device and stream (yielded; None on the CPU) made
        current; an exception inside is raised as ``ShardError``."""
        d, s = self.mesh.devices[i], self.streams[i]
        try:
            if s is None:
                yield None
            else:
                with torch.cuda.device(d), torch.cuda.stream(s):
                    yield s
        except ShardError:
            raise
        except Exception as exc:
            raise ShardError(i, d, exc) from exc

    def event(self, i: int) -> Optional[torch.cuda.Event]:
        """An event recorded now on shard i's stream (None on the CPU)."""
        if self.streams[i] is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.streams[i])
        return ev

    def fork(self) -> None:
        """Each shard's stream waits for the caller's current streams on the
        first device and on its own."""
        for d, s in zip(self.mesh.devices, self.streams):
            if s is not None:
                if self.first.type == "cuda" and self.first != d:
                    s.wait_stream(torch.cuda.current_stream(self.first))
                s.wait_stream(torch.cuda.current_stream(d))

    def submit(self, job: Callable[[torch.device, List[int]], Dict[int, Any]],
               shards: Optional[Sequence[int]] = None) -> List[Future]:
        if self.mesh.size == 1:
            done: Future = Future()
            try:
                done.set_result(job(self.first, [0]))
            except Exception as exc:
                done.set_exception(exc)
            return [done]
        cards: Dict[torch.device, List[int]] = {}
        for i in range(self.mesh.size) if shards is None else shards:
            cards.setdefault(self.mesh.devices[i], []).append(i)
        out = []
        for d, idx in cards.items():
            if d not in self._threads:
                self._threads[d] = ThreadPoolExecutor(1, thread_name_prefix=f"mesh-{d}")
            out.append(self._threads[d].submit(job, d, idx))
        return out

    def collect(self, futures: Sequence[Future]) -> Dict[int, Any]:
        out, errors = {}, []
        for f in futures:
            try:
                out.update(f.result())
            except Exception as exc:
                errors.append(exc)
        if errors:
            raise min(errors, key=lambda e: getattr(e, "shard", self.mesh.size))
        return out

    def map(self, fn: Callable[[int], Any], shards: Sequence[int]) -> Dict[int, Done]:
        """{shard: (``fn(i)`` run under ``on(i)`` on its card's thread, the
        event recorded after it)}, every card at once."""
        def job(_d, idx):
            out = {}
            for i in idx:
                with self.on(i):
                    out[i] = fn(i), self.event(i)
            return out

        return self.collect(self.submit(job, shards))

    def to_first(self, parts: Sequence[Tuple[Tuple[torch.Tensor, ...], Optional[torch.cuda.Event]]]
                 ) -> List[Tuple[torch.Tensor, ...]]:
        """Each shard's (tensors, event) → the tensors on the first device,
        on the caller's stream after the event.  A copy from another card
        runs on that card's current stream, which waits for the caller's."""
        first = self.first
        if first.type != "cuda":
            return [tuple(x.to(first) for x in xs) for xs, _ in parts]
        caller = torch.cuda.current_stream(first)
        for _, ev in parts:
            if ev is not None:
                caller.wait_event(ev)
        out = []
        for xs, _ in parts:
            moved = []
            for x in xs:
                if x.device == first:
                    x.record_stream(caller)
                    moved.append(x)
                else:
                    moved.append(x.to(first))
                    x.record_stream(torch.cuda.current_stream(x.device))
            out.append(tuple(moved))
        return out

    def close(self) -> None:
        for t in self._threads.values():
            t.shutdown(wait=True)
        self._threads.clear()


# --------------------------------------------------- row data parallelism

def replicate(module: nn.Module, mesh: Mesh) -> Dict[torch.device, nn.Module]:
    """One copy of ``module`` (its buffers) on each distinct device of
    ``mesh``: ``module`` itself, which lies on the mesh's first device, for
    that one.  Two shards of one card share its copy."""
    out = {}
    for d in mesh.distinct:
        if d == mesh.devices[0]:
            out[d] = module
        else:
            rep = copy.deepcopy(module).to(d)
            rep.device = d
            out[d] = rep
    return out


def row_parallel(workers: Workers, run: Callable[..., Tuple[torch.Tensor, ...]],
                 *rows: torch.Tensor, graph: Optional[tuple] = None,
                 graph_run: Optional[Callable[..., Tuple[torch.Tensor, ...]]] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """``run(device, *row slices)`` on each shard's run of rows (⌈R/D⌉ rows
    each, in order, moved to the shard's device; a shard left with none
    is skipped), every shard at once on its card's worker and stream;
    each output's parts concatenated on the mesh's first device in row
    order, on the caller's stream.  Every row must be decided alone, so
    that the result is the single device's.

    ``graph`` (a name, then ``run``'s settings) runs each part on a card
    as the workers' CUDA graph of (``graph``, rows padded to a power of
    two, at least 64, with copies of the part's first row, the rows'
    trailing shapes), captured from ``graph_run`` (default ``run``),
    which must decide the same and make no host sync, in the second run
    that uses it (``Workers.due``; the first calls ``run`` on the part's
    rows)."""
    mesh = workers.mesh
    n = rows[0].shape[0]
    per = max(-(-n // mesh.size), 1)
    spans = {i: (i * per, min(n, (i + 1) * per)) for i in range(mesh.size) if i == 0 or i * per < n}
    keys, missing = {}, {}
    if graph is not None and workers.graphed:
        shapes = tuple((tuple(x.shape[1:]), x.dtype) for x in rows)
        with workers.run():
            for i, (lo, hi) in spans.items():
                if hi > lo:
                    pad = max(64, 1 << (hi - lo - 1).bit_length())
                    key = graph + (pad,) + shapes
                    if (i, key) not in workers.graphs:
                        if not workers.due(i, key):
                            continue
                        missing[i] = [torch.cat([x[lo:hi], x[lo : lo + 1].expand(pad - hi + lo, *x.shape[1:])])
                                      for x in rows]
                    keys[i] = key
    workers.fork()
    warm = {i: workers.capture(i, keys[i], partial(graph_run or run, mesh.devices[i]), padded)
            for i, padded in missing.items()}

    def part(i):
        lo, hi = spans[i]
        d = mesh.devices[i]
        if i in warm:
            return tuple(o[: hi - lo] for o in warm[i])
        xs = [x[lo:hi].to(d) for x in rows]
        if i in keys:
            return tuple(o[: hi - lo].clone() for o in workers.replay(i, keys[i], xs))
        return run(d, *xs)

    done = workers.map(part, list(spans))
    outs = workers.to_first([done[i] for i in spans])
    return tuple(torch.cat([o[j] for o in outs]) for j in range(len(outs[0])))
