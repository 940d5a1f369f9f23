"""Multi-device execution: the title-sharded index and data-parallel boosting.

The JAX package's ``parallel/sharded.py`` in PyTorch.  That package's mesh
is one SPMD program per group of query blocks (``shard_map`` inside one
``jit``), so every shard works at once.  Here a ``Mesh`` is a tuple of
devices and one process drives it through ``Workers``: one host thread per
distinct device, each issuing its shards' work under that device, on a
stream per shard.  The shards of distinct cards are issued at once, two
shards of one card run on two streams, and the caller's stream waits on
the shards' events, never on the host.  A mesh may name one device more
than once: two shards of one card have the shard boundaries, streams,
launches and merges of two cards.

What the mesh buys is room: an index larger than one card's memory is
held across several.  It costs no throughput on one card: on two shards
of one H100 80GB HBM3 at 700 W (``chip_smoke.py``'s ``mesh`` phase, in
turns with a single-card Matcher) a 16,384-query predict took 0.69× the
single card's time at 150k titles and 0.51× at 500k, and the host issued
110 kernel launches and ~240 graph launches where the single card issues
54k-77k kernel launches: the single card still runs its fuzzy and model
stages op by op.  On four such cards (``scripts/torch_mesh_cards.py``)
a predict over ``make_mesh()`` ran at 1.75× one card's queries a second
at 150k titles and 2.25× at 500k.

* **Sharded retrieval** (``ShardedJaccardScorer``): the title axis, padded
  to a multiple of ``devices × title_block``, is cut into one run of titles
  per device.  Each shard is the single device's engine over its run (the
  exact engine, kernel A or D; or the folded engine, kernel A with two
  hashes and the exact rescore), and each returns its own top-k.  The
  blocks go in groups of ``dispatch_blocks`` (of ``query_block`` queries;
  the JAX package's groups): a group's inputs are uploaded once a card
  from pinned memory, every shard scores each block of the group on its
  own stream, and the shards' candidates of the whole group go to the
  first device once and merge there in one stable sort of the (G, QB,
  devices·k) candidates laid out shard by shard: the order of
  ``lax.top_k`` over the JAX package's all-gather, ties to the lower shard.
  On a card each (shard, block shape) is a CUDA graph, captured at its
  first block (whose result is the op-by-op warm-up's) while every worker
  is idle, then replayed: a block costs its shard one copy in, one replay
  and one copy out.
* **Data-parallel boosting** (``dp_boost_round``, ``models.gbt.train_gbt``
  with ``mesh=``): each shard grows the histograms of its rows in fixed
  point, the integer sums add up on the first device, and every shard
  routes its own rows through the one tree.
* **Row data parallelism** (``replicate``, ``row_parallel``): the fuzzy and
  model stages' engines, one copy per distinct device, each deciding a run
  of rows on its shard's worker (``pipeline.Matcher`` under a mesh).  On a
  card each shard's run, padded to a power of two rows, is a CUDA graph
  too (the fuzzy stage in its static form, which makes no host sync and
  decides the same): these stages are thousands of small operations a
  slab, and op by op the workers' launches contend for the interpreter
  lock, each switch costing more than the launch itself.

An exception on a worker is raised in the caller as ``ShardError``, which
names the shard and its device; there is no serial path beside the
workers.  ``Workers.use_graphs = False`` runs every step op by op (the
reference the graphs are held to).  A CPU mesh (the tests') takes the
same workers and groups, each step a direct call.
"""

from __future__ import annotations

import contextlib
import copy
import logging
from concurrent.futures import Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.device import resolve_device
from doppelspeller_tpu_torch.models.gbt import build_tree_shards, margin_grad_hess, split_rows
from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
from doppelspeller_tpu_torch.ops.fold import FoldedEngine, plan_id_blocks
from doppelspeller_tpu_torch.ops.index_device import build_shard, ids_width, index_from_shards
from doppelspeller_tpu_torch.ops.jaccard import ExactEngine, JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import TruthIndex, checkpoint_holds, plan_query_blocks
from doppelspeller_tpu_torch.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)


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


def make_mesh(n_devices: Optional[int] = None, axis: str = "titles",
              platform: Optional[str] = None) -> Mesh:
    """The first ``n_devices`` cards (default: all of them) as a mesh;
    ``platform="cpu"`` gives ``n_devices`` (default 1) CPU entries, the
    counterpart of the JAX package's virtual CPU devices.  ValueError where
    there are fewer cards than asked for."""
    if platform == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1), axis)
    if platform not in (None, "cuda"):
        raise ValueError(f"unknown platform {platform!r}: 'cuda' or 'cpu'")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or max(have, 1)
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


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
    """The mesh's host side: one thread per distinct device, and on a card
    one stream per shard (two shards of one card: two streams).

    ``submit(job, shards)`` hands each card's shards to its thread, which
    calls ``job(device, shard indices)`` for a dict {shard: result};
    ``collect`` reads every card's result and raises the error of the
    lowest shard that failed.  Inside a job, ``on(i)`` makes shard i's
    device and stream current and names the shard in any error
    (``ShardError``).  ``fork`` orders the shards' streams after the
    caller's work; ``to_first`` moves the shards' results to the first
    device on the caller's stream, after the event each shard recorded.
    The threads start at first use and end with ``close``.

    On a card each shard keeps CUDA graphs (``graphs``, keyed by (shard,
    key), ``key[0]`` a name), in a memory pool of its own: ``capture``
    makes one and ``replay`` runs it; ``captures`` and ``replays`` count
    them by name and shard.  ``use_graphs = False`` (the reference the
    graphs are held to) runs every step op by op instead."""

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

    @property
    def graphed(self) -> bool:
        """Whether steps run as CUDA graphs: on a card, unless switched off."""
        return self.use_graphs and self.first.type == "cuda"

    def capture(self, i: int, key: tuple, fn: Callable[..., Tuple[torch.Tensor, ...]],
                inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Called with every worker idle (after ``fork``): on shard i's
        thread, ``fn`` runs op by op on copies of ``inputs`` on its device
        (the warm-up; its outputs are returned), then is captured as the
        graph (i, key), those copies its static inputs."""
        def job(d, _idx):
            with self.on(i) as stream:
                static = tuple(x.to(d, copy=True) for x in inputs)
                out = fn(*static)
                if i not in self._pools:
                    self._pools[i] = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()

                def capture():
                    with torch.cuda.graph(graph, pool=self._pools[i], stream=stream,
                                          capture_error_mode="thread_local"):
                        return fn(*static)

                g_out, launches = jk.uncounted(capture)
                self.graphs[i, key] = _Graph(graph, static, g_out, launches)
                self.captures.setdefault(key[0], [0] * self.mesh.size)[i] += 1
            return {i: out}

        return self.collect(self.submit(job, [i]))[i]

    def replay(self, i: int, key: tuple, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """On shard i's thread, under ``on(i)``: ``inputs`` copied into the
        leading rows of graph (i, key)'s static inputs (the rows past them
        keep earlier valid rows), one replay.  Returns its static outputs,
        valid until the shard's next replay."""
        g = self.graphs[i, key]
        for dst, x in zip(g.static_in, inputs):
            dst[: x.shape[0]].copy_(x)
        g.graph.replay()
        jk.count_replay(g.launches)
        self.replays.setdefault(key[0], [0] * self.mesh.size)[i] += 1
        return g.out

    def drop(self, name: str) -> None:
        """Forget the graphs whose key is named ``name``."""
        for k in [k for k in self.graphs if k[1][0] == name]:
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
                if self.first.type == "cuda":
                    s.wait_stream(torch.cuda.current_stream(self.first))
                s.wait_stream(torch.cuda.current_stream(d))

    def submit(self, job: Callable[[torch.device, List[int]], Dict[int, Any]],
               shards: Optional[Sequence[int]] = None) -> List[Future]:
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


# ------------------------------------------------------------ sharded index

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _title_slice(truth: TitleSet, lo: int, hi: int) -> TitleSet:
    return TitleSet(titles=truth.titles[lo:hi], transformed=truth.transformed[lo:hi],
                    ids=truth.ids[lo:hi], encoded=truth.encoded[lo:hi], lengths=truth.lengths[lo:hi])


def _shard_view(index: TruthIndex, lo: int, ntp_local: int) -> TruthIndex:
    """Titles [lo, lo + ntp_local) of ``index`` as an index of their own:
    their trigram rows, ids and sums (zero past the real titles), the
    global IDF tables."""
    nt = int(np.clip(index.num_titles - lo, 0, ntp_local))
    sums = np.zeros(ntp_local, np.float32)
    part = index.sums[lo : lo + ntp_local]
    sums[: len(part)] = part
    return replace(index, sums=sums, title_ids=index.title_ids[lo : lo + nt], num_titles=nt,
                   padded_titles=ntp_local, trigrams=index.trigrams[lo : lo + nt])


class ShardedJaccardScorer(JaccardScorer):
    """Retrieval over a truth index sharded across a mesh's title axis.

    ``truth`` (the encodings) is needed by the folded engine only, which is
    engaged as ``JaccardScorer`` engages it: ``retrieval_mode="folded"``, or
    ``"auto"`` given ``truth`` at ``folded_min_titles`` titles or more.
    ``exact`` / ``folded`` hold one engine per shard (the other is None).
    Results come back on the mesh's first device.  ``workers`` issue the
    shards' work and hold their CUDA graphs (``close`` ends their
    threads)."""

    def __init__(self, index: TruthIndex, mesh: Mesh, config: Config,
                 truth: Optional[TitleSet] = None):
        self.cfg = config
        self.index = index
        self.mesh = mesh
        self.device = mesh.devices[0]
        D = mesh.size
        # pad the title axis to a multiple of (devices × title_block)
        self.ntp = _round_up(index.padded_titles, D * config.title_block)
        self.ntp_local = self.ntp // D
        self.offsets = [i * self.ntp_local for i in range(D)]
        self.tb = 2048 if self.ntp_local % 2048 == 0 else config.title_block
        if self._wants_folded(index, config, truth):
            # the trigram lists' width is that of all the titles
            l_eff = int(truth.lengths.max(initial=3)) if len(truth) else 3
            ltw = max(_round_up(l_eff - 2, 8), 8)
            self.folded = [
                FoldedEngine(_shard_view(index, lo, self.ntp_local),
                             _title_slice(truth, lo, lo + self.ntp_local), config, dev,
                             tb=self.tb, ltw=ltw)
                for lo, dev in zip(self.offsets, mesh.devices)]
            self.exact = None
        else:
            self.folded = None
            self.exact = [ExactEngine(_shard_view(index, lo, self.ntp_local), config, dev, tb=self.tb)
                          for lo, dev in zip(self.offsets, mesh.devices)]
        self.workers = Workers(mesh)
        LOGGER.info("[ShardedJaccardScorer] %d titles on %d shards of %d (tb=%d, %s)",
                    index.num_titles, D, self.ntp_local, self.tb,
                    "folded" if self.folded else "exact")

    def close(self) -> None:
        """End the workers' threads."""
        self.workers.close()

    # -------------------------------------------------------------- blocks

    def _blocks(self, queries: TitleSet, rows) -> Tuple[list, List[Tuple[tuple, np.ndarray]]]:
        """(plans, [(block shape, the block's int32 input)]): the exact
        engine's (U, QB, LQ) and union ids then positions, held to the
        index on the host (``check_plan``); the folded engine's (QB, LQ)
        and trigram ids."""
        if self.exact is not None:
            plans = plan_query_blocks(queries, self.index, self.cfg, rows=rows)
            for p in plans:
                self.exact[0].check_plan(p)
            return plans, [((p.union_ids.shape[0],) + p.w_pos.shape,
                            np.concatenate([p.union_ids, p.w_pos.reshape(-1)])) for p in plans]
        plans = plan_id_blocks(queries, self.cfg, rows=rows)
        return plans, [(p.ids.shape, p.ids.reshape(-1)) for p in plans]

    def _step(self, i: int, key: tuple, x: torch.Tensor, k: int) -> torch.Tensor:
        """Shard i's top-k of one block, ``x`` the block's input on its
        device: int32 (QB, 2k), the scores' bits then the global positions."""
        if self.exact is not None:
            u, qb, lq = key
            v, p = self.exact[i].topk_union(x[:u], x[u:].view(qb, lq), k)
        else:
            v, p = self.folded[i].topk_block(x.view(key).to(torch.int64), k)
        return torch.cat([v.view(torch.int32), p + self.offsets[i]], dim=1)

    def _issue(self, blocks, host: torch.Tensor, k: int, warm, graphs: bool,
               d: torch.device, shards: List[int]) -> Dict[int, Done]:
        """One group on card ``d`` (a worker's job): its input uploaded once,
        then every block on each of the card's shards, on the shard's
        stream, into int32 (G, QB, 2k).  ``blocks``: [(shape, offset,
        size)] into ``host``."""
        qb = blocks[0][0][-2]
        with self.workers.on(shards[0]) as first:
            buf = host.to(d, non_blocking=True)
        out = {}
        for i in shards:
            with self.workers.on(i) as stream:
                if stream is not None and stream is not first:
                    stream.wait_stream(first)
                    buf.record_stream(stream)
                res = torch.empty((len(blocks), qb, 2 * k), dtype=torch.int32, device=d)
                for j, (key, off, n) in enumerate(blocks):
                    if (i, j) in warm:
                        res[j].copy_(warm[i, j])
                    elif graphs:
                        res[j].copy_(self.workers.replay(i, ("topk",) + key, [buf[off : off + n]])[0])
                    else:
                        res[j].copy_(self._step(i, key, buf[off : off + n], k))
                out[i] = (res,), self.workers.event(i)
        return out

    def _merge(self, plans, futures: List[Future], k: int, vals: list, pos: list) -> None:
        """A group's candidates of every shard, on the first device, merged
        by one stable descending sort of (G, QB, devices·k) laid out shard
        by shard (ties to the lower shard, then to the shard's own order);
        each block's valid rows appended to ``vals`` and ``pos``."""
        done = self.workers.collect(futures)
        parts = self.workers.to_first([done[i] for i in range(self.mesh.size)])
        x = torch.stack([p[0] for p in parts], dim=2)                 # (G, QB, D, 2k)
        G, qb, D, _ = x.shape
        v = x[..., :k].reshape(G, qb, D * k).view(torch.float32)
        ps = x[..., k:].reshape(G, qb, D * k)
        v, order = torch.sort(v, dim=2, descending=True, stable=True)
        ps = torch.gather(ps, 2, order[..., :k])
        for j, p in enumerate(plans):
            vals.append(v[j, : p.n_valid, :k])
            pos.append(ps[j, : p.n_valid])

    def topk_device(self, queries: TitleSet, k: Optional[int] = None,
                    rows: Optional[np.ndarray] = None, probe_tables=None):
        """``JaccardScorer.topk_device`` over the shards, on the mesh's first
        device, on the caller's stream.  Plans are made over the whole
        index and go in groups of ``dispatch_blocks`` (of ``query_block``
        queries); each shard scores every block and returns its top-k,
        which merge once a group.  With ``probe_tables`` (per-title
        lengths and longest word lengths on the first device) also returns
        each row's largest of both over its candidates, int (R, 2), a
        padding candidate reading the last title."""
        k = k or self.cfg.top_n_predicting
        if self.index.num_titles < k:
            raise ValueError(f"index has {self.index.num_titles} titles < k={k}")
        per_shard = self.ntp_local if self.folded or not self.cfg.retrieval_window_select \
            else self.ntp_local // max(self.tb // 128, 1)
        if per_shard < k:
            raise ValueError(f"per-shard candidates {per_shard} < k={k}; use fewer devices or "
                             "a larger title_block")
        plans, blocks = self._blocks(queries, rows)
        vals: List[torch.Tensor] = []
        pos: List[torch.Tensor] = []
        if plans:
            self._run_groups(plans, blocks, k, vals, pos)
            out = torch.cat(vals), torch.cat(pos)
        else:
            empty = torch.zeros((0, k), device=self.device)
            out = empty, empty.to(torch.int32)
        if probe_tables is None:
            return out
        t_len, t_wlen = probe_tables
        cand = out[1].to(torch.int64).clamp(max=t_len.shape[0] - 1)
        probe = torch.stack([t_len[cand].max(dim=1).values, t_wlen[cand].max(dim=1).values], dim=1) \
            if len(cand) else torch.zeros((0, 2), dtype=t_len.dtype, device=self.device)
        return out + (probe,)

    def _run_groups(self, plans, blocks, k: int, vals: list, pos: list) -> None:
        """Each group's input packed on the host (pinned on a card) and
        issued on every card's worker; a group is merged while the workers
        issue the next.  Missing graphs are captured first, with the
        workers idle."""
        on_card = self.device.type == "cuda"
        graphs = self.workers.graphed
        qb = blocks[0][0][-2]
        g = max(1, int(self.cfg.dispatch_blocks) * self.cfg.query_block // qb)
        self.workers.fork()
        issued: List[Tuple[list, List[Future]]] = []       # issued, not merged yet
        try:
            for s in range(0, len(blocks), g):
                group = blocks[s : s + g]
                sizes = [a.shape[0] for _, a in group]
                offsets = np.cumsum([0] + sizes)
                host = torch.empty(int(offsets[-1]), dtype=torch.int32, pin_memory=on_card)
                np.concatenate([a for _, a in group], out=host.numpy())
                # each shard's new block shapes: block j, the first of its
                # shape, is run op by op (its result) and captured
                missing = {}
                for j, (key, a) in enumerate(group):
                    for i in range(self.mesh.size):
                        if graphs and (i, ("topk",) + key) not in self.workers.graphs:
                            missing.setdefault((i, key), (j, a))
                if missing:
                    while issued:                  # the workers idle while one captures
                        self._merge(*issued.pop(0), k, vals, pos)
                warm = {(i, j): self.workers.capture(
                            i, ("topk",) + key, lambda x, i=i, key=key: (self._step(i, key, x, k),),
                            [torch.from_numpy(a)])[0]
                        for (i, key), (j, a) in missing.items()}
                layout = [(key, int(o), n) for (key, _), o, n in zip(group, offsets, sizes)]
                issued.append((plans[s : s + g], self.workers.submit(
                    partial(self._issue, layout, host, k, warm, graphs))))
                if len(issued) > 1:
                    self._merge(*issued.pop(0), k, vals, pos)
            while issued:
                self._merge(*issued.pop(0), k, vals, pos)
        except BaseException:
            for _, futures in issued:
                wait(futures)
            raise

    # ------------------------------------------------- checkpoint / resume

    def save(self, path: str) -> None:
        """Checkpoint the index under the package's ``INDEX_FORMAT``: the
        statistics and the per-title trigram rows, which shard by rows, so
        one file loads onto a mesh of any size or onto one device
        (``TruthIndex.load``).  The packed shards are never on the host:
        each device builds its own from its rows."""
        self.index.save(path)

    @classmethod
    def load(cls, path: str, mesh: Mesh, config: Config,
             truth: Optional[TitleSet] = None) -> "ShardedJaccardScorer":
        """A checkpoint of ``save`` (or ``TruthIndex.save``) placed shard by
        shard onto ``mesh``; ``truth`` lets ``retrieval_mode`` engage the
        folded engine, whose state is never checkpointed."""
        scorer = cls(TruthIndex.load(path), mesh, config, truth=truth)
        LOGGER.info("[ShardedJaccardScorer] loaded checkpoint %s onto %d shards", path, mesh.size)
        return scorer

    @staticmethod
    def checkpoint_matches(path: str, truth: TitleSet) -> bool:
        """Whether the checkpoint at ``path`` is this package's and holds
        exactly ``truth`` (``ngram_index.checkpoint_holds``).  A foreign
        (the JAX package's) or unreadable file does not match, with a
        warning."""
        try:
            return checkpoint_holds(path, truth)
        except Exception as exc:  # a torn or foreign file: rebuild rather than fail
            LOGGER.warning("index checkpoint at %s unreadable (%s)", path, exc)
            return False


def build_sharded_index(truth: TitleSet, mesh: Mesh, config: Config) -> ShardedJaccardScorer:
    """The truth index and its scorer, built on ``mesh``: each shard's ids,
    document frequencies and sums on its own device from its slice of the
    encodings (``index_device.build_shard``, ``shard_sums``), the
    frequencies summed on the first device.  The ids are dropped once the
    index is downloaded; each shard's engine builds its matrices on its
    device as ``ShardedJaccardScorer`` does.  ``.index`` equals
    ``build_truth_index``'s bit for bit; its ids keep the width of all the
    titles."""
    nt, tb, D = len(truth), config.title_block, mesh.size
    ntp_local = _round_up(_round_up(max(nt, tb), tb), D * tb) // D
    width = ids_width(truth.lengths)
    shards = [build_shard(truth.encoded[lo : lo + ntp_local], truth.lengths[lo : lo + ntp_local],
                          dev, width)
              for lo, dev in zip(range(0, D * ntp_local, ntp_local), mesh.devices)]
    index = index_from_shards(truth, config, shards)
    del shards
    return ShardedJaccardScorer(index, mesh, config, truth=truth)


# ------------------------------------------------------- data-parallel GBT

def dp_boost_round(mesh: Mesh, bins: Sequence[torch.Tensor], y: Sequence[torch.Tensor],
                   margins: Sequence[torch.Tensor], *, depth: int, eta: float, beta: float,
                   lambda_: float = 1.0, min_child_weight: float = 1.0):
    """One data-parallel boosting round: ``bins[i]`` (N_i, F), ``y[i]`` and
    ``margins[i]`` (N_i,) on ``mesh.devices[i]``.  Returns (each shard's new
    margins, the tree (feat, split_bin, missing_left, value·eta, is_leaf) on
    the first device): one device's round over all the rows, bit for bit."""
    if not len(bins) == len(y) == len(margins) == mesh.size:
        raise ValueError(f"one shard per device of the mesh ({mesh.size}), got {len(bins)}")
    first = mesh.devices[0]
    # the gradients of all rows at once, as ``boost_segment`` takes them
    g, h = margin_grad_hess(torch.cat([m.to(first) for m in margins]),
                            torch.cat([t.to(first) for t in y]), beta)
    *tree, contrib = build_tree_shards(bins, split_rows(g, bins), split_rows(h, bins), depth=depth,
                                       lambda_=lambda_, min_child_weight=min_child_weight)
    tree[3] = tree[3] * eta
    return [m + eta * c for m, c in zip(margins, contrib)], tuple(tree)


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
                 *rows: torch.Tensor, graph: Optional[tuple] = None) -> Tuple[torch.Tensor, ...]:
    """``run(device, *row slices)`` on each shard's run of rows (⌈R/D⌉ rows
    each, in order, moved to the shard's device; a shard left with none
    is skipped), every shard at once on its card's worker and stream;
    each output's parts concatenated on the mesh's first device in row
    order, on the caller's stream.  Every row must be decided alone, so
    that the result is the single device's.

    ``graph`` (a name, then ``run``'s settings) runs each part on a card
    as the workers' CUDA graph of (``graph``, rows padded to a power of
    two, at least 64, with copies of the part's first row, the rows'
    trailing shapes), captured at its first use; ``run`` must then make
    no host sync."""
    mesh = workers.mesh
    n = rows[0].shape[0]
    per = max(-(-n // mesh.size), 1)
    spans = {i: (i * per, min(n, (i + 1) * per)) for i in range(mesh.size) if i == 0 or i * per < n}
    keys, missing = {}, {}
    if graph is not None and workers.graphed:
        shapes = tuple((tuple(x.shape[1:]), x.dtype) for x in rows)
        for i, (lo, hi) in spans.items():
            if hi > lo:
                pad = max(64, 1 << (hi - lo - 1).bit_length())
                keys[i] = graph + (pad,) + shapes
                if (i, keys[i]) not in workers.graphs:
                    missing[i] = [torch.cat([x[lo:hi], x[lo : lo + 1].expand(pad - hi + lo, *x.shape[1:])])
                                  for x in rows]
    workers.fork()
    warm = {i: workers.capture(i, keys[i], partial(run, mesh.devices[i]), padded)
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
