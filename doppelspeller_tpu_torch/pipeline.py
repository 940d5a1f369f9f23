"""The prediction cascade: exact → Jaccard top-n → fuzzy Levenshtein → model.

The JAX package's ``pipeline.py`` (``Matcher.predict`` with its device
cascade) in PyTorch, on one device, the card unless the caller names the
CPU, or on a mesh (``parallel/sharded.py``).  Stages:

1. **Exact**: transformed-title lookup (on duplicate truth titles the last
   id wins), prediction 1.0.
2. **Fuzzy**: top-k retrieval candidates (``ops/jaccard.py``: the exact
   union engine below ``folded_min_titles`` titles, the folded engine at or
   above it, or as ``retrieval_mode`` forces), length-delta prefilter,
   rounded Levenshtein ratio with token-sort fallback; a unique max over
   the threshold matches, tied maxima drop to stage 3.
3. **Model**: GBT probability over the candidates, unique argmax above the
   probability threshold.  With adaptive depth, wave A scores the first
   ``model_depth_initial`` candidates of every row; rows whose wave-A max
   lies in [widen, trust) (or is tied at or above trust) score the rest in
   wave B, and the two waves merge exactly.  As in the JAX package the
   waves run only for ``cascade_impl="device"`` or, under ``"auto"``, at
   2,048 or more rows past the exact stage; a smaller batch, ``"host"`` and
   a single-title request score every candidate in one wave.  The same
   device engines serve both: a pair's ratio and probability do not depend
   on how it is batched.

A batch of at most one query block (a single title among them) takes the
one-dispatch path instead (``_stage_fused``): the three stages as one
device program (``ops/serve_fused.py``, a graph on the scorer's workers),
as the JAX package's ``predict`` takes its fused path; ``serve_fused="off"``
and ``cascade_impl="host"`` leave it.  Rows it cannot decide at its static
model bucket, and rows over a capped fuzzy tile (``fuzzy_tile_cap``), go
through the reference's host stages (``_stage_fuzzy``, ``_stage_model``),
which index the truth arrays with numpy as the reference does.

The batch cascade follows the JAX package's plan for one device (its
``_cascade_device``: every stage queued, a fetch between stages).
Retrieval goes in groups of ``dispatch_blocks`` query blocks
(``ops/jaccard.py``); both later stages take ``model_slab`` rows at a time
(the fuzzy stage of a tile bucket, the model stage of a (TL, WL) bucket),
each slab through ``row_parallel`` on the scorer's workers: on a card a
CUDA graph of the slab padded to a power of two of at least 64 rows.  A
predict is one run of the workers (``Workers.run``): a shape runs op by
op through the first predict that uses it and is captured in the next,
so a one-shot predict (``generate-predictions``) captures nothing.
The powers of two are ``row_parallel``'s, the rule the mesh graphs with,
so one device and a mesh share one path; the slabs are the JAX package's
model-stage slabs, which bound a graph's pool and a bucket's padding:
every full slab is one shape, and only a bucket's last slab pads, to
under twice its rows (a bucket of 10,357 rows padded whole would take
16,384).  Uploads go through pinned memory, and each stage's results are
fetched once (the model stage's once a wave), so no host sync falls
inside a stage once its shapes are graphs.  Results do not depend on the
padding, the groups or the graphs: every row is decided alone.

Each predict is a ``doppel.predict`` span and each stage a span inside it
(``utils/timing.py``), recorded while a profiler runs; the stage spans'
seconds fill ``PredictionResult.stage_seconds`` whether or not they are
recorded.
"""

from __future__ import annotations

import contextlib
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from doppelspeller_tpu_torch.config import Config, get_config
from doppelspeller_tpu_torch.device import resolve_device, synchronize, upload
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.models.trainer import WordCounts
from doppelspeller_tpu_torch.ops.features import remove_spaces_host, split_words_host
from doppelspeller_tpu_torch.ops.fuzzy import FuzzyEngine
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import TruthIndex, build_truth_index, checkpoint_holds
from doppelspeller_tpu_torch.ops.rerank import RerankEngine
from doppelspeller_tpu_torch.ops.serve_fused import FusedServe
from doppelspeller_tpu_torch.ops.tiles import device_word_grid, fuzzy_tile_bound, query_block, title_grid
from doppelspeller_tpu_torch.parallel.sharded import ShardedJaccardScorer, build_sharded_index
from doppelspeller_tpu_torch.parallel.workers import Mesh, replicate, row_parallel
from doppelspeller_tpu_torch.utils import timing
from doppelspeller_tpu_torch.utils.io import TitleSet, as_int64, load_ground_truth, read_csv

LOGGER = logging.getLogger(__name__)

STAGE_NONE = 0
STAGE_EXACT = 1
STAGE_FUZZY = 2
STAGE_MODEL = 3


@dataclass
class PredictionResult:
    test_index: np.ndarray        # int64[N]
    match_title_id: np.ndarray    # int64[N]  (−1 = not found)
    prediction: np.ndarray        # float32[N]
    stage: np.ndarray             # uint8[N]  (STAGE_*)
    transformed: List[str]
    match_transformed: List[Optional[str]]
    stage_counts: Dict[str, int] = field(default_factory=dict)
    stage_seconds: Dict[str, float] = field(default_factory=dict)

    def save_csv(self, path: str, delimiter: str = "|") -> None:
        """``title_id|test_index`` rows sorted by ``test_index``, as the
        reference's ``to_output_frame().to_csv(path, index=False, sep=...)``
        writes them (its sort is numpy's default quicksort, taken here too)."""
        order = np.argsort(self.test_index, kind="quicksort")
        with open(path, "w", newline="") as f:
            f.write(f"title_id{delimiter}test_index\n")
            f.writelines(f"{int(self.match_title_id[i])}{delimiter}{int(self.test_index[i])}\n"
                         for i in order)

    def single_result(self) -> dict:
        """The single-title dict of the reference (first row of the result)."""
        return {
            "test_index": int(self.test_index[0]),
            "transformed_title": self.transformed[0],
            "match_transformed_title": self.match_transformed[0],
            "match_title_id": int(self.match_title_id[0]),
            "prediction": float(self.prediction[0]),
        }


# under cascade_impl="auto" the adaptive-depth waves start at this many rows
# past the exact stage (the JAX package's threshold)
DEVICE_CASCADE_MIN_ROWS = 2048


def fetch(outs: List[tuple]) -> List[np.ndarray]:
    """The results of a stage's calls, each a tuple of (R_i,) device
    tensors: each output concatenated over the calls and brought to the
    host in one copy, in its own dtype."""
    cols = [torch.cat(c) for c in zip(*outs)]
    packed = torch.stack([(c.view(torch.int32) if c.dtype == torch.float32 else c).to(torch.int64)
                          for c in cols]).cpu().numpy()
    return [p.astype(np.int32).view(np.float32) if c.dtype == torch.float32
            else p.astype(torch.empty(0, dtype=c.dtype).numpy().dtype) for p, c in zip(packed, cols)]


def _groupby_max_unique(q_idx: np.ndarray, values: np.ndarray, n_queries: int):
    """For rows (q_idx, value): each query's first max row (−1 where it has
    none) and whether exactly one row reaches the max.  Returns
    (best_row[nq], unique[nq])."""
    max_val = np.full(n_queries, -np.inf, dtype=np.float64)
    np.maximum.at(max_val, q_idx, values.astype(np.float64))
    is_max = values.astype(np.float64) == max_val[q_idx]
    count_max = np.zeros(n_queries, dtype=np.int64)
    np.add.at(count_max, q_idx[is_max], 1)
    best_row = np.full(n_queries, -1, dtype=np.int64)
    rows = np.flatnonzero(is_max)
    best_row[q_idx[rows][::-1]] = rows[::-1]
    return best_row, count_max == 1


@contextlib.contextmanager
def _stage_span(res: PredictionResult, stage: str, **counts):
    """Cascade stage ``stage``'s span (``doppel.<stage>``, ``utils/timing.py``);
    its seconds fill ``res.stage_seconds[stage]`` when it ends, by a
    ``return`` inside it too."""
    with timing.timed(f"doppel.{stage}", **counts) as sp:
        yield sp
    res.stage_seconds[stage] = sp.seconds


class Matcher:
    """End-to-end matcher over a truth database, on one device or a mesh.

    ``truth`` defaults to ``load_ground_truth(config)``.  Without ``index``
    the index checkpoint at ``config.index_path`` is used when its count,
    ids and content hash match the truth; a checkpoint that does not match,
    or that this package cannot read (the JAX package's among them), is
    rebuilt with a warning.  An index is built on ``device`` or on the
    host as ``config.index_build_impl`` resolves (``build_truth_index``).
    ``model`` defaults to ``config.model_path``, read at the first use of
    stage 3.  ``init_seconds`` splits the construction's seconds by piece
    (load, index, retrieval, words, token_sort, fuzzy_engine, rest), each
    a ``doppel.init.<piece>`` span (``utils/timing.py``).

    ``mesh`` (``parallel.sharded.Mesh``; ``device`` is then its first
    device): the index (the checkpoint's or the given one) is sharded over
    the mesh's title axis, or, without one, built there shard by shard
    (``build_sharded_index``), and the fuzzy and model stages run
    data-parallel over the rows, on one copy of their engine per distinct
    device, each shard on its card's worker thread (the scorer's
    ``workers``; ``close`` ends them).  A mesh never takes the one-dispatch
    path."""

    def __init__(self, config: Optional[Config] = None, truth: Optional[TitleSet] = None,
                 model: Optional[GBTModel] = None, device="cuda", *,
                 index: Optional[TruthIndex] = None, use_index_checkpoint: bool = True,
                 mesh: Optional[Mesh] = None):
        self.cfg = config = config or get_config()
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        devices = mesh.distinct if mesh is not None else (self.device,)

        # construction's pieces, each a span that ends after a synchronize:
        # the truth index (the truth and checkpoint reads under "load"), the
        # retrieval engine's device matrices (on a mesh built here, with
        # the index: "retrieval" is then 0), the truth's word split, its
        # token-sorted encodings, the fuzzy engine, and the rest.  The
        # pieces follow one another, so their seconds sum to the
        # construction's
        self.init_seconds: Dict[str, float] = {}
        for d in devices:
            synchronize(d)

        @contextlib.contextmanager
        def piece(key: str):
            with timing.timed(f"doppel.init.{key}") as sp:
                yield
                for d in devices:
                    synchronize(d)
            self.init_seconds[key] = sp.seconds

        with piece("load"):
            self.truth = truth = truth or load_ground_truth(config)
            if index is None and use_index_checkpoint and os.path.exists(config.index_path):
                index = self._checkpoint(config.index_path, truth, on_mesh=mesh is not None)
        on_mesh_built = mesh is not None and index is None
        with piece("index"):
            if on_mesh_built:
                # built on the mesh, each shard on its own device
                self.scorer = build_sharded_index(truth, mesh, config)
                self.index = self.scorer.index
            else:
                self.index = index or build_truth_index(truth, config, self.device)
        with piece("retrieval"):
            if mesh is None:
                self.scorer = JaccardScorer(self.index, config, self.device, truth)
            elif not on_mesh_built:
                self.scorer = ShardedJaccardScorer(self.index, mesh, config, truth=truth)
        with piece("words"):
            self.truth_words = split_words_host(truth.encoded, truth.lengths)
            wlen_max = self.truth_words[1].max(axis=1).astype(np.int32)
        with piece("token_sort"):
            self.ts_truth = ts_enc, ts_len = truth.encoded_token_sorted
        with piece("fuzzy_engine"):
            self.fuzzy = FuzzyEngine(truth.encoded, truth.lengths, ts_enc, ts_len, wlen_max,
                                     config, self.device)
            self._fuzzy_copies = replicate(self.fuzzy, self.scorer.workers.mesh)
        with piece("rest"):
            # exact-match lookup: duplicate transformed titles → last id wins
            self.reverse: Dict[str, int] = {
                t: int(i) for t, i in zip(truth.transformed, truth.ids)
            }
            self._word_counts: Optional[np.ndarray] = None
            self.set_model(model)

    @staticmethod
    def _checkpoint(path: str, truth: TitleSet, on_mesh: bool = False) -> Optional[TruthIndex]:
        """The checkpointed index at ``path`` if it holds this truth, else None."""
        where = " on the mesh" if on_mesh else ""
        try:
            if checkpoint_holds(path, truth):
                loaded = TruthIndex.load(path)
                LOGGER.info("loaded index checkpoint from %s%s", path, " onto the mesh" if on_mesh else "")
                return loaded
        except Exception as exc:  # stale, old-format or foreign checkpoint
            LOGGER.warning("index checkpoint at %s unreadable (%s); rebuilding%s", path, exc, where)
            return None
        LOGGER.warning("index checkpoint at %s does not match the truth data; rebuilding%s", path, where)
        return None

    def _decide(self, engine, copies, *rows, **kw):
        """``engine.decide(*rows, **kw)`` on the scorer's workers
        (``row_parallel``): each shard decides a run of the rows on its
        device's copy of the engine (``copies``; None: ``engine`` itself,
        one device), all shards at once (one device: one shard, every
        row).  On a card each run, padded to a power of two of at least 64
        rows, is a CUDA graph of (stage, settings, padded shape) from the
        second run that uses it (op by op before); in a graph the fuzzy
        stage takes its static form, which makes no host sync and decides
        the same.  Each row is
        decided alone, so the result is one device's op by op."""
        workers = self.scorer.workers
        copies = copies or {d: engine for d in workers.mesh.distinct}
        graph = graph_kw = None
        if workers.graphed:
            graph_kw = dict(kw, static=True) if engine is self.fuzzy else kw
            graph = (type(engine).__name__,) + tuple(sorted(graph_kw.items()))
        return row_parallel(workers, lambda d, *part: copies[d].decide(*part, **kw), *rows,
                            graph=graph,
                            graph_run=lambda d, *part: copies[d].decide(*part, **graph_kw))

    def close(self) -> None:
        """End the scorer's worker threads."""
        self.scorer.close()

    def set_model(self, model: Optional[GBTModel]) -> None:
        """Take another model for stage 3 (say, one just trained) over the
        same truth database: only the model stage's engine is rebuilt, at
        its next use.  ``None`` reads ``config.model_path`` then."""
        self.model = model
        self._rerank: Optional[RerankEngine] = None
        self._rerank_copies = None
        self.scorer.workers.drop(RerankEngine.__name__, FusedServe.__name__)   # the old model's graphs
        self._fused = None            # the one-dispatch path, over this model

    @property
    def rerank(self) -> RerankEngine:
        """The stage-3 engine, built at first use (with the model of
        ``config.model_path`` where none was given)."""
        if self._rerank is None:
            if self.model is None:
                self.model = GBTModel.load(self.cfg.model_path)
            if self._word_counts is None:
                self._word_counts = WordCounts(self.truth).matrix(self.truth.transformed)
            self._rerank = RerankEngine(self.truth.encoded, self.truth.lengths, self.truth_words,
                                        self._word_counts, self.model, len(self.truth), self.cfg,
                                        self.device)
            self._rerank_copies = replicate(self._rerank, self.scorer.workers.mesh)
        return self._rerank

    def _use_fused(self, rem: np.ndarray, impl: str) -> bool:
        """Whether the one-dispatch path decides the rows ``rem``, as in the
        JAX package: one device (no mesh), at most one query block, at
        least k titles, neither it (``serve_fused="off"``) nor the device
        (``cascade_impl="host"``) switched off."""
        cfg = self.cfg
        if cfg.serve_fused == "off" or impl == "host" or self.mesh is not None:
            return False
        return (len(rem) <= query_block(cfg, self.scorer.folded is not None)
                and self.index.num_titles >= cfg.top_n_predicting)

    def _fused_engine(self) -> FusedServe:
        """The one-dispatch path's program over this matcher's engines and
        ``cfg``, built at first use; the graphs of one built before are
        dropped, as they ran its settings."""
        if self._fused is None:
            self.scorer.workers.drop(FusedServe.__name__)
            self._fused = FusedServe(self.cfg, self.scorer, self.fuzzy, self.rerank, self.truth.lengths)
        return self._fused

    # ------------------------------------------------------------- stages

    def _stage_exact(self, queries: TitleSet, res: PredictionResult) -> None:
        hits = 0
        for i, t in enumerate(queries.transformed):
            tid = self.reverse.get(t)
            if tid is not None:
                res.match_title_id[i] = tid
                res.prediction[i] = 1.0
                res.stage[i] = STAGE_EXACT
                res.match_transformed[i] = t
                hits += 1
        res.stage_counts["exact"] = hits

    def _record(self, res: PredictionResult, qi: int, pos: int, pred: float, stage: int) -> None:
        res.match_title_id[qi] = int(self.index.title_ids[pos])
        res.prediction[qi] = pred
        res.stage[qi] = stage
        res.match_transformed[qi] = self.truth.transformed[pos]

    def _stage_fuzzy(self, queries: TitleSet, rem: np.ndarray, cand_pos: np.ndarray,
                     res: PredictionResult) -> None:
        """The reference's host fuzzy stage for the rows ``rem`` and their
        candidates ``cand_pos`` (R, K) (host positions): the prefilter on
        numpy, the considered pairs' ratios on the device, a unique max over
        the threshold matches.  A padding candidate raises ``IndexError``."""
        cfg = self.cfg
        R, K = cand_pos.shape
        thr = cfg.levenshtein_ratio_threshold
        q_len = queries.lengths[rem].astype(np.int64)
        t_len = self.truth.lengths[cand_pos.reshape(-1)].reshape(R, K).astype(np.int64)
        tot = q_len[:, None] + t_len
        delta = np.abs(q_len[:, None] - t_len)
        consider = (tot - delta) / np.maximum(tot, 1) * 100.0 >= thr

        ratio = np.zeros((R, K), dtype=np.int32)
        rows, cols = np.nonzero(consider)
        if len(rows):
            ts_all, ts_len_all = queries.encoded_token_sorted
            ratio[rows, cols] = self.fuzzy.ratios(
                queries.encoded[rem], queries.lengths[rem].astype(np.int32),
                ts_all[rem][:, : cfg.max_characters], np.minimum(ts_len_all[rem], cfg.max_characters),
                rows, cand_pos[rows, cols], self.truth.lengths, self.ts_truth[1],
            )
        kr, kc = np.nonzero(ratio > thr)
        hits = 0
        if len(kr):
            best_row, unique = _groupby_max_unique(kr, ratio[kr, kc], R)
            # a query whose max is tied between candidates drops to stage 3
            for r in np.flatnonzero((best_row >= 0) & unique):
                self._record(res, rem[r], int(cand_pos[r, kc[best_row[r]]]), 1.0, STAGE_FUZZY)
                hits += 1
        res.stage_counts["fuzzy"] = hits
        LOGGER.info("Matched %d titles so far (fuzzy)", hits)

    def _stage_model(self, queries: TitleSet, rem: np.ndarray, cand_pos: np.ndarray,
                     res: PredictionResult, single: bool) -> None:
        """The reference's host model stage: every candidate of the rows
        ``rem`` scored; a unique max over the probability threshold matches,
        or in ``single`` mode the first max of all, whatever its value."""
        R, K = cand_pos.shape
        if R == 0:
            res.stage_counts["model"] = 0
            return
        flat_pos = cand_pos.reshape(-1).astype(np.int64)
        q_idx = np.repeat(np.arange(R), K)
        q_wo, q_wo_len = remove_spaces_host(queries.encoded[rem], queries.lengths[rem])
        pred = self.rerank.score(queries.encoded[rem], queries.lengths[rem].astype(np.int32),
                                 q_wo, q_wo_len, q_idx, flat_pos, self.truth.lengths)
        hits = 0
        if single:
            best = int(np.argmax(pred))
            self._record(res, rem[q_idx[best]], int(flat_pos[best]), float(pred[best]), STAGE_MODEL)
            hits = 1
        else:
            best_row, unique = _groupby_max_unique(q_idx, pred, R)
            for r in np.flatnonzero((best_row >= 0) & unique):
                row = best_row[r]
                if pred[row] > self.cfg.prediction_probability_threshold:
                    self._record(res, rem[r], int(flat_pos[row]), float(pred[row]), STAGE_MODEL)
                    hits += 1
        res.stage_counts["model"] = hits
        LOGGER.info("Matched %d titles (model stage)", hits)

    def _cascade_device(self, queries: TitleSet, rem: np.ndarray,
                        res: PredictionResult, waves: bool = True,
                        single: bool = False) -> None:
        """Retrieval, fuzzy and model stages for the rows ``rem``.  Without
        ``waves`` stage 3 scores every candidate in one pass, and a padding
        candidate raises ``IndexError`` as the reference's host stages do;
        ``single`` (one row) records the first max of all its probabilities
        whatever its value and count.  Each stage is a span (``doppel.plan``,
        ``doppel.retrieval``, ``doppel.fuzzy``, ``doppel.model``) whose
        seconds fill ``res.stage_seconds``; each fetch is a ``.wait`` span
        inside its stage."""
        cfg = self.cfg
        dev = self.device
        k = cfg.top_n_predicting
        buckets = title_grid(cfg, cfg.max_characters)
        buckets_arr = np.asarray(buckets)
        with timing.span("doppel.plan", rows=len(rem)):
            # a fuzzy-considered candidate satisfies the length-delta
            # prefilter, so the fuzzy tile is derived from the threshold
            # (``fuzzy_tile_bound``) and no considered pair can overflow it,
            # unless fuzzy_tile_cap caps the tile at the widest bucket within
            # it; a row with a considered pair longer than that tile is
            # flagged and decided again by the host stage on its candidates
            q_len_all = queries.lengths.astype(np.int64)
            titles = np.array(queries.transformed, dtype=object)
            fzb = np.searchsorted(buckets_arr, fuzzy_tile_bound(q_len_all[rem], cfg))
            order = np.lexsort((titles[rem], fzb))
            rem = rem[order]
            fzb = fzb[order]

        with _stage_span(res, "retrieval", rows=len(rem)):
            _, cand = self.scorer.topk_device(queries, k=k, rows=rem)          # (R, k) i32
            with timing.span("doppel.retrieval.wait"):
                if not waves:
                    self._raise_on_padding(cand, order)
                synchronize(dev)

        # ---- stage 2: fuzzy, per tile bucket (a run of ``rem``, which is
        # sorted by bucket) in slabs of ``model_slab`` rows, as the model
        # stage; the rows uploaded once, the results fetched once
        with _stage_span(res, "fuzzy", rows=len(rem)) as sp:
            slab = int(cfg.model_slab)
            cap = int(cfg.fuzzy_tile_cap)
            cap_tl = max([b for b in buckets if b <= cap] or [buckets[0]])
            L = cfg.max_characters
            ts_enc_all, ts_len_all = queries.encoded_token_sorted
            q_enc, q_len, q_ts, q_ts_len = (upload(x, dev) for x in (
                queries.encoded[rem], queries.lengths[rem], ts_enc_all[rem, :L], ts_len_all[rem]))
            outs = []
            for bi in np.unique(fzb):
                lo, hi = np.searchsorted(fzb, bi), np.searchsorted(fzb, bi, side="right")
                TL = int(buckets_arr[bi])
                if cap:
                    TL = min(TL, cap_tl)
                for a in range(lo, hi, slab):
                    b = min(a + slab, hi)
                    outs.append(self._decide(self.fuzzy, self._fuzzy_copies, q_enc[a:b, :TL],
                                             q_len[a:b], q_ts[a:b, :TL], q_ts_len[a:b], cand[a:b],
                                             tl=TL))
            with timing.span("doppel.fuzzy.wait"):
                m, best_pos, _ratio, over_rows, probe_tl, probe_wl = fetch(outs)
            matched = m & ~over_rows
            hits = 0
            for j in np.flatnonzero(matched):
                self._record(res, rem[j], int(best_pos[j]), 1.0, STAGE_FUZZY)
                hits += 1
            res.stage_counts["fuzzy"] = hits
            sp.set(slabs=len(outs), hits=hits, overflow_rows=int(over_rows.sum()))
            if over_rows.any():
                js = np.flatnonzero(over_rows)
                LOGGER.warning("fuzzy device overflow on %d rows; host redo", len(js))
                with timing.span("doppel.fuzzy.redo", rows=len(js)):
                    with timing.span("doppel.fuzzy.redo.wait"):
                        cand_js = cand[torch.from_numpy(js).to(dev)].cpu().numpy()
                    self._stage_fuzzy(queries, rem[js], cand_js, res)
                res.stage_counts["fuzzy"] += hits

        # ---- stage 3: model on still-unmatched rows, in wave A and, with
        # adaptive depth, wave B, each a ``doppel.model.wave`` span whose
        # fetch is a ``doppel.model.wave.wait`` ----
        with _stage_span(res, "model") as sp:
            todo = np.flatnonzero(res.stage[rem] == STAGE_NONE)     # indices into rem
            sp.set(rows=len(todo), hits=0)
            if len(todo) == 0:
                res.stage_counts["model"] = 0
                return
            gq = rem[todo]
            tl_need = np.maximum(q_len_all[gq], probe_tl[todo])
            wl_need = np.maximum(probe_wl[todo], 1)
            w_buckets = device_word_grid(cfg.max_characters)
            w_arr = np.asarray(w_buckets)
            tbi = np.searchsorted(buckets_arr, np.minimum(tl_need, cfg.max_characters))
            wbi = np.searchsorted(w_arr, np.minimum(wl_need, cfg.max_characters))
            tbi = np.maximum(tbi, np.searchsorted(buckets_arr, w_arr)[wbi])

            wo_enc, wo_len = queries.encoded_wo
            todo_d = upload(todo, dev)
            q_enc_d, q_len_d, cand_todo = q_enc[todo_d], q_len[todo_d], cand[todo_d]
            q_wo_d, q_wo_len_d = upload(wo_enc[gq], dev), upload(wo_len[gq], dev)
            n = len(todo)

            def run_wave(wave: str, rows_t: np.ndarray, narrow: int, col_lo: int = 0):
                """(cnt, pos, mx) host arrays over todo rows ``rows_t`` (others
                left at cnt 0, mx −inf): the slabs' rows uploaded once, their
                results fetched once."""
                with timing.timed("doppel.model.wave", wave=wave, rows=len(rows_t)) as sw:
                    slabs = []
                    for ti, TL in enumerate(buckets):
                        for wi, WL in enumerate(w_buckets):
                            if WL > TL:
                                continue
                            sub = rows_t[(tbi[rows_t] == ti) & (wbi[rows_t] == wi)]
                            slabs += [(sub[s : s + slab], TL, WL)
                                      for s in range(0, len(sub), slab)]
                    sw.set(slabs=len(slabs))
                    sel = np.concatenate([sl for sl, _, _ in slabs])
                    sel_d = upload(sel, dev)
                    rerank = self.rerank        # built (and copied to the mesh) at first use
                    outs, o = [], 0
                    for sl, TL, WL in slabs:
                        sl_d = sel_d[o : o + len(sl)]
                        o += len(sl)
                        outs.append(self._decide(
                            rerank, self._rerank_copies,
                            q_enc_d[sl_d], q_len_d[sl_d], q_wo_d[sl_d], q_wo_len_d[sl_d],
                            cand_todo[sl_d], tl=TL, wl=WL, narrow=narrow, col_lo=col_lo,
                        ))
                    cnt = np.zeros(n, np.int64)
                    pos = np.zeros(n, np.int64)
                    mx = np.full(n, -np.inf, np.float32)
                    with timing.timed("doppel.model.wave.wait") as sf:
                        cnt[sel], pos[sel], mx[sel] = fetch(outs)
                if wave == "b":
                    LOGGER.info("model wave B: %d slabs dispatched %.2fs, fetched %.2fs",
                                len(slabs), sw.seconds - sf.seconds, sf.seconds)
                return cnt, pos, mx

            def apply(rows_t, cnt, pos, mx) -> int:
                thr = cfg.prediction_probability_threshold
                hit = 0
                for j in rows_t[(cnt[rows_t] == 1) & (mx[rows_t] > thr)]:
                    self._record(res, rem[todo[j]], int(pos[j]), float(mx[j]), STAGE_MODEL)
                    hit += 1
                return hit

            k1 = int(cfg.model_depth_initial)
            adaptive = waves and 0 < k1 < k
            all_rows = np.arange(n, dtype=np.int64)
            cnt_a, pos_a, mx_a = run_wave("a", all_rows, k1 if adaptive else 0)
            if single:
                self._record(res, rem[todo[0]], int(pos_a[0]), float(mx_a[0]), STAGE_MODEL)
                hits = 1
            elif not adaptive:
                hits = apply(all_rows, cnt_a, pos_a, mx_a)
            else:
                widen_thr = float(cfg.model_widen_threshold)
                trust_thr = float(cfg.model_trust_threshold)
                band = (mx_a >= widen_thr) & (mx_a < trust_thr)
                # a trusted head whose max is tied must widen: the tail may hold
                # a strictly higher unique max
                band |= (mx_a >= trust_thr) & (cnt_a > 1)
                widen = all_rows[band]
                hits = apply(all_rows[~band], cnt_a, pos_a, mx_a)
                if len(widen):
                    LOGGER.info("model wave B: %d/%d rows widened by %d tail candidates",
                                len(widen), n, k - k1)
                    cnt_b, pos_b, mx_b = run_wave("b", widen, 0, col_lo=k1)
                    a_wins = mx_a[widen] >= mx_b[widen]         # ties keep A (first col)
                    tie = mx_a[widen] == mx_b[widen]
                    LOGGER.info("model wave B: tail won %d/%d widened rows, %d head=tail ties",
                                int((~a_wins).sum()), len(widen), int(tie.sum()))
                    dump = os.environ.get("DOPPEL_DUMP_WAVES")
                    if dump:
                        # per widened row, both waves' (max, position, count at
                        # max), to calibrate model_trust_threshold offline
                        np.savez(dump, widen=widen, mx_a=mx_a[widen], mx_b=mx_b[widen],
                                 pos_a=pos_a[widen], pos_b=pos_b[widen], cnt_a=cnt_a[widen],
                                 cnt_b=cnt_b[widen])
                    mx_a[widen] = np.where(a_wins, mx_a[widen], mx_b[widen])
                    pos_a[widen] = np.where(a_wins, pos_a[widen], pos_b[widen])
                    cnt_a[widen] = np.where(tie, cnt_a[widen] + cnt_b[widen],
                                            np.where(a_wins, cnt_a[widen], cnt_b[widen]))
                    hits += apply(widen, cnt_a, pos_a, mx_a)
            res.stage_counts["model"] = hits
            sp.set(hits=hits)

    def _stage_fused(self, queries: TitleSet, rem: np.ndarray, res: PredictionResult,
                     single: bool) -> None:
        """The rows ``rem`` (at most one query block) through one device
        program (``FusedServe.dispatch``), decided here; rows past its static
        model bucket go to the host stages on the fetched candidates.  The
        ``doppel.fused`` span's seconds are the retrieval stage's."""
        fused = self._fused_engine()
        with timing.timed("doppel.fused", rows=len(rem), folded=int(fused.mode == "folded")) as sp:
            rows, stats, cand, tlr = fused.dispatch(queries, rem)
            res.stage_seconds["retrieval"] = sp.seconds
            fz_matched, fz_pos, _ratio, md_cnt, md_pos, md_pred, probe_tl, probe_wl = stats[:, : len(rows)]
            redo = (probe_tl > tlr) | (probe_wl > fused.wl_default)
            fz = ~redo & (fz_matched > 0)
            # a single title takes the first max whatever its value
            thr_p = self.cfg.prediction_probability_threshold
            md = ~redo & ~fz & (single | ((md_cnt == 1) & (md_pred > thr_p)))
            for j in np.flatnonzero(fz):
                self._record(res, rows[j], int(fz_pos[j]), 1.0, STAGE_FUZZY)
            for j in np.flatnonzero(md):
                self._record(res, rows[j], int(md_pos[j]), float(md_pred[j]), STAGE_MODEL)
            n_fz, n_md = int(fz.sum()), int(md.sum())
            res.stage_counts.update(fuzzy=n_fz, model=n_md)
            js = np.flatnonzero(redo)
            sp.set(fallback_rows=len(js))
            if len(js):
                LOGGER.info("[FusedServe] %d rows exceed the (%d, %d) rerank bucket; classic host redo",
                            len(js), tlr, fused.wl_default)
                with timing.span("doppel.fused.redo", rows=len(js)):
                    qs, cand_sub = rows[js].astype(np.int64), cand[js]
                    self._stage_fuzzy(queries, qs, cand_sub, res)
                    res.stage_counts["fuzzy"] += n_fz
                    still = res.stage[qs] == STAGE_NONE
                    if still.any():
                        self._stage_model(queries, qs[still], cand_sub[still], res, single)
                        res.stage_counts["model"] += n_md
        res.stage_seconds.update(fuzzy=0.0, model=0.0)

    def _raise_on_padding(self, cand: torch.Tensor, order: np.ndarray) -> None:
        """The reference's host stages index the truth arrays with numpy,
        which raises on a padding candidate (a position past the truth
        count, which window select returns over fewer titles than k windows
        hold); raise its IndexError, for the first such position in the
        rows' own order."""
        nt = self.index.num_titles
        flat = cand[torch.from_numpy(np.argsort(order)).to(cand.device)].reshape(-1)
        bad = torch.nonzero(flat >= nt)
        if bad.numel():
            raise IndexError(f"index {int(flat[bad[0, 0]])} is out of bounds for axis 0 "
                             f"with size {nt}")

    # -------------------------------------------------------------- entry

    def predict(self, queries: TitleSet, single: bool = False) -> PredictionResult:
        cfg = self.cfg
        if single and len(queries) != 1:
            raise ValueError("single prediction requires exactly one query")
        if queries.encoded.shape[1] != cfg.max_characters:
            raise ValueError(
                f"queries were encoded at width {queries.encoded.shape[1]} but this "
                f"Matcher's config.max_characters is {cfg.max_characters}"
            )
        n = len(queries)
        with timing.span("doppel.predict", queries=n) as root:
            res = PredictionResult(
                test_index=queries.ids.copy(),
                match_title_id=np.full(n, cfg.train_not_found_value, dtype=np.int64),
                prediction=np.zeros(n, dtype=np.float32),
                stage=np.zeros(n, dtype=np.uint8),
                transformed=list(queries.transformed),
                match_transformed=[None] * n,
            )
            with _stage_span(res, "exact") as sp:
                self._stage_exact(queries, res)
                sp.set(hits=res.stage_counts["exact"])
            res.stage_seconds.update(retrieval=0.0, fuzzy=0.0, model=0.0)
            res.stage_counts.update(fuzzy=0, model=0)
            rem = np.flatnonzero(res.stage == STAGE_NONE)
            impl = cfg.cascade_impl
            waves = not single and (
                impl == "device" or (impl == "auto" and len(rem) >= DEVICE_CASCADE_MIN_ROWS))
            if not len(rem):
                root.set(path="exact")
            elif not waves and self._use_fused(rem, impl):
                root.set(path="fused")
                self._stage_fused(queries, rem, res, single)
            else:
                root.set(path="waves" if waves else "staged")
                with self.scorer.workers.run():                # one run of the graphs' rule
                    self._cascade_device(queries, rem, res, waves=waves, single=single)
        LOGGER.info("Matched %d/%d titles (exact %d, fuzzy %d, model %d)",
                    int((res.stage != STAGE_NONE).sum()), n, res.stage_counts["exact"],
                    res.stage_counts["fuzzy"], res.stage_counts["model"])
        return res


def accuracy_report(actuals_path: str, output_path: str, delimiter: str = "|") -> dict:
    """Counts of the predictions at ``output_path`` against the actuals
    (``test_index`` and ``company_id`` columns): matched right or wrong,
    marked not found right or wrong, and the custom error (a wrong match
    weighs 5, a wrong not-found 1)."""
    actual = read_csv(actuals_path, delimiter)
    predictions = read_csv(output_path, delimiter)
    actual_map = dict(zip(as_int64(actual["test_index"]).tolist(), actual["company_id"]))
    pred_map = dict(zip(as_int64(predictions["test_index"]).tolist(), predictions["title_id"]))

    cm_e = cm_ne = im_e = im_ne = 0
    for key, actual_value in actual_map.items():
        p = pred_map[key]
        if p == -1:
            if actual_value == p:
                cm_ne += 1
            else:
                im_ne += 1
        else:
            if actual_value == p:
                cm_e += 1
            else:
                im_e += 1
    report = {
        "correctly_matched": cm_e,
        "incorrectly_matched": im_e,
        "correctly_not_found": cm_ne,
        "incorrectly_not_found": im_ne,
        "custom_error": im_ne + im_e * 5,
    }
    LOGGER.info(
        "\n\n    Correctly matched titles            %(correctly_matched)d\n"
        "    Incorrectly matched titles          %(incorrectly_matched)d\n"
        "    Correctly marked as not-found       %(correctly_not_found)d\n"
        "    Incorrectly marked as not-found     %(incorrectly_not_found)d\n\n"
        "    Custom Error                        %(custom_error)d\n",
        report,
    )
    return report
