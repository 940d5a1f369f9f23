"""Retrieval: top-k IDF-weighted Jaccard candidates per query.

The JAX package's ``JaccardScorer`` with both of its engines:

- **exact** (``ExactEngine``, the JAX ``_topk_multiblock`` with
  ``impl="pallas"``): per block of ``query_block`` queries, the union of
  their trigram ids is scored either with the per-window pre-selection
  (``retrieval_window_select``, the default: kernel A with ``folds=1``) or
  as the full matrix (kernel D) followed by an exact top-k.  Both kernels
  read the union's rows straight from the packed index, so no gathered
  copy of them exists.  ``"exact"`` takes it at any size,
  ``"auto"`` below ``folded_min_titles`` or when no truth encodings are
  given;
- **folded** (``ops/fold.py``): ``"folded"``, and ``"auto"`` at or above
  ``folded_min_titles`` titles.
"""

from __future__ import annotations

import logging
from collections import Counter
from concurrent.futures import Future, wait
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.device import resolve_device
from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
from doppelspeller_tpu_torch.ops.fold import FoldedEngine, plan_id_blocks
from doppelspeller_tpu_torch.ops.ngram_index import (
    QueryBlockPlan,
    TruthIndex,
    build_packed_matrix,
    plan_query_blocks,
)
from doppelspeller_tpu_torch.parallel.workers import Done, Mesh, Workers
from doppelspeller_tpu_torch.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)


class ExactEngine(nn.Module):
    """Device-resident exact-retrieval state: the packed (V, ntp/8) index,
    the IDF tables and the per-title sums."""

    def __init__(self, index: TruthIndex, cfg: Config, device="cuda", *, tb: int):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        self.tb = tb
        self.nt = index.num_titles
        self.register_buffer("packed", build_packed_matrix(index, device))
        self.register_buffer("idf", torch.from_numpy(index.idf).to(device))
        self.register_buffer("fb", torch.from_numpy(index.fallback_idf()).to(device))
        self.register_buffer("sums", torch.from_numpy(index.sums).to(device))
        self.union_sizes: Counter = Counter()     # blocks scored, by union size
        LOGGER.info("[ExactEngine] packed index %.2f GB, tb=%d", self.packed.numel() / 1e9, tb)

    def check_plan(self, plan: QueryBlockPlan) -> None:
        """The host part of a block: the kernels read packed[id] unchecked,
        so the plan's union ids are held to the index here, where they are
        still on the host; the block is counted under its union size."""
        V = self.packed.shape[0]
        if plan.union_ids.size and not (0 <= plan.union_ids.min() and plan.union_ids.max() < V):
            raise ValueError(f"union ids outside the packed index's {V} rows")
        self.union_sizes[plan.union_ids.shape[0]] += 1

    def topk_block(self, plan: QueryBlockPlan, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k (scores f32, title positions i32) of one plan's block."""
        self.check_plan(plan)
        dev = self.packed.device
        return self.topk_union(torch.from_numpy(plan.union_ids).to(dev),
                               torch.from_numpy(plan.w_pos).to(dev), k)

    def topk_union(self, union_ids: torch.Tensor, w_pos: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device part of a block: top-k of the queries whose trigrams
        sit at ``w_pos`` (QB, LQ) in the union ``union_ids`` (U,), integer
        tensors on the device that ``check_plan`` passed.  No host sync.

        Weights and the max-intersection bound are rebuilt from the resident
        tables as the reference does on the device: w_val = (idf[union] ‖
        0)[min(w_pos, U)] and maxint = Σ (fb[union] ‖ 0)[min(w_pos, U)] in
        f32, slot U standing for a query's unused trigram slots.  The
        union's own padding rows (id 0) get no weight."""
        dev = self.packed.device
        uid = union_ids.to(torch.int64)
        u = uid.shape[0]
        wp = w_pos.to(torch.int64).clamp(max=u)
        zero = torch.zeros(1, dtype=torch.float32, device=dev)
        w_val = torch.cat([self.idf[uid], zero])[wp]
        maxint = torch.cat([self.fb[uid], zero])[wp].sum(dim=1)
        w = jk.densify_weights(wp, w_val, u)
        sd = self.cfg.score_dtype
        if self.cfg.retrieval_window_select:
            W = max(self.tb // 128, 1)
            wmax, warg = jk.score_window_select(self.packed, w, self.sums, maxint, self.nt,
                                                tb=self.tb, W=W, folds=1, score_dtype=sd,
                                                union_ids=uid)
            return jk.select_topk_windowed(wmax, warg, k)
        jacc = jk.score_full(self.packed, uid, w, self.sums, maxint, self.nt, tb=self.tb,
                             score_dtype=sd)
        return jk.select_topk_permuted(jacc, k, self.tb)


class JaccardScorer:
    """Device-resident retrieval engine over a TruthIndex.  ``truth`` (the
    encodings) is needed by the folded engine only.

    Blocks go in groups of ``dispatch_blocks`` (of ``query_block``
    queries), as the JAX package's ``topk_device`` streams them to
    ``_topk_multiblock`` / ``folded_multiblock``: a group's int32 input is
    packed on the host (pinned on a card) and uploaded once, and
    ``workers``, a mesh of this one device (``parallel/workers.py``), issues
    its blocks on the shard's stream.  On a card each (k, block shape) is a
    CUDA graph: it runs op by op through the first run that uses it
    (``Workers.run``: a predict, or a retrieval called alone); a later run
    captures it at its first block (whose result is the warm-up's) and
    replays it for every other, one replay and one copy out a block.  One
    device has no merge: its own top-k is the result.
    ``workers.use_graphs = False`` runs every block op by op (the
    reference the graphs are held to); ``close`` ends a mesh's worker
    threads (a scorer of one device has none)."""

    def __init__(self, index: TruthIndex, config: Config, device="cuda",
                 truth: Optional[TitleSet] = None):
        self.cfg = config
        self.index = index
        self.device = resolve_device(device)
        folded = self._wants_folded(index, config, truth)
        tb = 2048 if index.padded_titles % 2048 == 0 else config.title_block
        self.folded = FoldedEngine(index, truth, config, self.device, tb=tb) if folded else None
        self.exact = None if folded else ExactEngine(index, config, self.device, tb=tb)
        self.offsets = [0]
        self.workers = Workers(Mesh((self.device,)))

    @staticmethod
    def _wants_folded(index: TruthIndex, config: Config, truth: Optional[TitleSet]) -> bool:
        """Whether ``retrieval_mode`` takes the folded engine: ``"folded"``,
        or ``"auto"`` given the truth encodings at ``folded_min_titles``
        titles or more."""
        mode = config.retrieval_mode
        if mode not in ("auto", "exact", "folded"):
            raise ValueError(f"unknown retrieval_mode {mode!r}")
        folded = mode == "folded" or (
            mode == "auto" and truth is not None
            and index.num_titles >= config.folded_min_titles
        )
        if folded and truth is None:
            raise ValueError("retrieval_mode='folded' needs the truth TitleSet "
                             "(encodings): pass truth= to the scorer")
        return folded

    def engine(self, i: int):
        """Shard i's engine (one device: the engine)."""
        return self.exact if self.exact is not None else self.folded

    def close(self) -> None:
        """End the workers' threads."""
        self.workers.close()

    # -------------------------------------------------------------- blocks

    def _blocks(self, queries: TitleSet, rows) -> Tuple[list, List[Tuple[tuple, np.ndarray]]]:
        """(plans, [(block shape, the block's int32 input)]): the exact
        engine's (U, QB, LQ) and union ids then positions, held to the
        index on the host (``check_plan``); the folded engine's (QB, LQ)
        and trigram ids.  Plans keep the order of ``rows`` (overflowing
        blocks split in order)."""
        if self.exact is not None:
            plans = plan_query_blocks(queries, self.index, self.cfg, rows=rows)
            for p in plans:
                self.engine(0).check_plan(p)
            return plans, [((p.union_ids.shape[0],) + p.w_pos.shape,
                            np.concatenate([p.union_ids, p.w_pos.reshape(-1)])) for p in plans]
        plans = plan_id_blocks(queries, self.cfg, rows=rows)
        return plans, [(p.ids.shape, p.ids.reshape(-1)) for p in plans]

    def _step(self, i: int, key: tuple, x: torch.Tensor, k: int) -> torch.Tensor:
        """Shard i's top-k of one block, ``x`` the block's input on its
        device: int32 (QB, 2k), the scores' bits then the global positions."""
        if self.exact is not None:
            u, qb, lq = key
            v, p = self.engine(i).topk_union(x[:u], x[u:].view(qb, lq), k)
        else:
            v, p = self.engine(i).topk_block(x.view(key).to(torch.int64), k)
        return torch.cat([v.view(torch.int32), p + self.offsets[i]], dim=1)

    def _issue(self, blocks, host: torch.Tensor, k: int, warm, eager,
               d: torch.device, shards: List[int]) -> Dict[int, Done]:
        """One group on card ``d`` (a worker's job): its input uploaded once,
        then every block on each of the card's shards, on the shard's
        stream, into int32 (G, QB, 2k).  ``blocks``: [(shape, offset,
        size)] into ``host``; block j of shard i is ``warm[i, j]`` (its
        capture's warm-up), runs op by op where (i, j) is in ``eager``
        (everything, where the workers do not graph) and replays its graph
        otherwise."""
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
                    elif eager is None or (i, j) in eager:
                        res[j].copy_(self._step(i, key, buf[off : off + n], k))
                    else:
                        res[j].copy_(self.workers.replay(i, ("topk", k) + key, [buf[off : off + n]])[0])
                out[i] = (res,), self.workers.event(i)
        return out

    def _merge(self, plans, futures: List[Future], k: int, vals: list, pos: list) -> None:
        """A group's top-k on the first device, on the caller's stream:
        one device's own (no merge); each block's valid rows appended to
        ``vals`` and ``pos``."""
        x = self.workers.to_first([self.workers.collect(futures)[0]])[0][0]
        for j, p in enumerate(plans):
            vals.append(x[j, : p.n_valid, :k].view(torch.float32))
            pos.append(x[j, : p.n_valid, k:])

    def _check_k(self, k: int) -> None:
        if self.index.num_titles < k:
            raise ValueError(f"index has {self.index.num_titles} titles < k={k}")

    def topk_device(self, queries: TitleSet, k: Optional[int] = None,
                    rows: Optional[np.ndarray] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores f32 (R, k), title positions i32 (R, k)) on the device, one
        row per entry of ``rows`` (default: every query), sorted by
        descending score; on the caller's stream, with no host sync."""
        k = k or self.cfg.top_n_predicting
        self._check_k(k)
        plans, blocks = self._blocks(queries, rows)
        if not plans:
            empty = torch.zeros((0, k), device=self.workers.first)
            return empty, empty.to(torch.int32)
        vals: List[torch.Tensor] = []
        pos: List[torch.Tensor] = []
        with self.workers.run():
            self._run_groups(plans, blocks, k, vals, pos)
        return torch.cat(vals), torch.cat(pos)

    def _run_groups(self, plans, blocks, k: int, vals: list, pos: list) -> None:
        """Each group's input packed on the host (pinned on a card) and
        issued on every card's worker; a group is merged while the workers
        issue the next.  A graph due in a group (``Workers.due``) is
        captured first, with the workers idle."""
        on_card = self.workers.first.type == "cuda"
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
                # each shard's blocks without a graph: a (k, shape) that an
                # earlier run used is captured at its first block here (its
                # result the warm-up's), any other runs op by op
                missing, eager = {}, None
                if graphs:
                    eager = set()
                    for j, (key, a) in enumerate(group):
                        gk = ("topk", k) + key
                        for i in range(self.workers.mesh.size):
                            if (i, gk) in self.workers.graphs or (i, gk) in missing:
                                continue
                            if self.workers.due(i, gk):
                                missing[i, gk] = (j, a, key)
                            else:
                                eager.add((i, j))
                if missing:
                    while issued:                  # the workers idle while one captures
                        self._merge(*issued.pop(0), k, vals, pos)
                warm = {(i, j): self.workers.capture(
                            i, gk, lambda x, i=i, key=key: (self._step(i, key, x, k),),
                            [torch.from_numpy(a)])[0]
                        for (i, gk), (j, a, key) in missing.items()}
                layout = [(key, int(o), n) for (key, _), o, n in zip(group, offsets, sizes)]
                issued.append((plans[s : s + g], self.workers.submit(
                    partial(self._issue, layout, host, k, warm, eager))))
                if len(issued) > 1:
                    self._merge(*issued.pop(0), k, vals, pos)
            while issued:
                self._merge(*issued.pop(0), k, vals, pos)
        except BaseException:
            for _, futures in issued:
                wait(futures)
            raise

    def topk(self, queries: TitleSet, k: Optional[int] = None,
             rows: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Host (scores float32[N, k], positions int32[N, k]) into
        ``index.title_ids``, sorted by descending score."""
        vals, pos = self.topk_device(queries, k=k, rows=rows)
        return vals.cpu().numpy(), pos.cpu().numpy()

    def topk_title_ids(self, queries: TitleSet, k: Optional[int] = None,
                       rows: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Like :meth:`topk` but with the positions mapped to the external
        title ids."""
        scores, pos = self.topk(queries, k=k, rows=rows)
        return scores, self.index.title_ids[pos]
