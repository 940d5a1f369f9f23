"""The one-dispatch small-batch path: retrieval, fuzzy and model as one
device program for at most one query block.

The JAX package's ``ops/serve_fused.py`` (``_fused_cascade_impl`` and
``FusedServe``).  ``fused_cascade`` composes the device parts the batch
cascade runs, over a fixed block of QB queries and all QB·k of their pairs
at static tiles: the exact engine's ``topk_union`` or the folded engine's
``topk_block``, ``fuzzy_decide`` with ``static=True`` (both ratios of every
pair, no host sync) and the model's ``decide`` over every candidate at the
static (tlr, wl) bucket.  It returns one packed stats matrix and the
candidates, in the reference's row order.

On the card each static key (engine, union size, LQ, fuzzy and model
tiles) is captured once as a ``torch.cuda.CUDAGraph``, at its first request
after a warm-up run on a side stream, all graphs in one memory pool.  A
request then costs one copy of one pinned buffer into the graph's static
input, one replay, one copy of the packed result into pinned memory and one
stream sync.  A capture or replay that fails raises; nothing falls back to
eager execution.  On the CPU the same function runs eagerly.

The model stage's bucket covers at least 99.9 % of the truth titles; the
program also returns each row's probe (its candidates' longest title and
longest word), and a row past the bucket is decided again by the matcher's
host stages on the fetched candidates, as in the reference.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
from doppelspeller_tpu_torch.ops.fold import plan_id_blocks
from doppelspeller_tpu_torch.ops.ngram_index import plan_query_blocks
from doppelspeller_tpu_torch.pipeline import STAGE_FUZZY, STAGE_MODEL, STAGE_NONE
from doppelspeller_tpu_torch.utils import timing

LOGGER = logging.getLogger(__name__)


def fused_cascade(retrieval, fuzzy, rerank, ids: torch.Tensor, union_ids: Optional[torch.Tensor],
                  q_enc, q_len, q_ts, q_ts_len, q_wo, q_wo_len, *, k: int, tlf: int, tlr: int,
                  wl: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Retrieval, probe, fuzzy and model for one block of QB queries, with
    static shapes and no host sync.

    ``retrieval`` is the exact engine (``union_ids`` (U,), ``ids`` the
    block's positions into it (QB, LQ)) or the folded engine (``ids`` the
    block's trigram ids (QB, LQ), ``union_ids`` None).  Query tensors are
    (QB, ≥ max(tlf, tlr)) uint8 and (QB,) int32.  Returns (stats f32
    (8, QB): fuzzy matched, fuzzy position, fuzzy max ratio, model count at
    max, model position, model max probability, probe title length, probe
    word length; candidates i32 (QB, k))."""
    if union_ids is None:
        _, cand = retrieval.topk_block(ids.to(torch.int64), k)
    else:
        _, cand = retrieval.topk_union(union_ids, ids, k)
    fz_matched, fz_pos, fz_mx, _over, probe_tl, probe_wl = fuzzy.decide(
        q_enc, q_len, q_ts, q_ts_len, cand, tlf, static=True)
    md_cnt, md_pos, md_mx = rerank.decide(q_enc, q_len, q_wo, q_wo_len, cand, tlr, wl)
    stats = torch.stack([x.to(torch.float32) for x in (
        fz_matched, fz_pos, fz_mx, md_cnt, md_pos, md_mx, probe_tl, probe_wl)])
    return stats, cand


def _segments(u: int, qb: int, lq: int, tlq: int) -> Tuple[List[tuple], int]:
    """The request buffer's layout: [(name, dtype, shape, byte offset)]
    with each segment 16-byte aligned, and its size in bytes."""
    segs = [("union", np.int32, (u,))] if u else []
    segs += [("ids", np.int32, (qb, lq)), ("q_len", np.int32, (qb,)),
             ("q_ts_len", np.int32, (qb,)), ("q_wo_len", np.int32, (qb,)),
             ("q_enc", np.uint8, (qb, tlq)), ("q_ts", np.uint8, (qb, tlq)),
             ("q_wo", np.uint8, (qb, tlq))]
    out, off = [], 0
    for name, dt, shape in segs:
        out.append((name, dt, shape, off))
        off += -(-int(np.prod(shape)) * np.dtype(dt).itemsize // 16) * 16
    return out, off


_TORCH_DTYPE = {np.int32: torch.int32, np.uint8: torch.uint8}


@dataclass
class _Graph:
    """One captured static key: the graph, its static input and packed
    output, their pinned host twins, and the kernel launches one replay makes."""

    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    out: torch.Tensor
    host_in: torch.Tensor
    host_out: torch.Tensor
    launches: List[int]


class FusedServe:
    """The one-dispatch path over a Matcher's resident engines.

    ``captures`` and ``replays`` count the CUDA graphs captured and replayed
    by every instance, beside the kernel wrappers' ``launches``."""

    captures = 0
    replays = 0

    def __init__(self, matcher):
        self.m = matcher
        cfg = self.cfg = matcher.cfg
        self.device = matcher.device
        folded = matcher.scorer.folded
        self.mode = "folded" if folded is not None else "exact"
        self.retrieval = folded if folded is not None else matcher.scorer.exact
        self.fuzzy = matcher.fuzzy
        self.rerank = matcher.rerank
        self.k = cfg.top_n_predicting
        self.qb = (cfg.fold_query_block or cfg.query_block) if self.mode == "folded" \
            else cfg.query_block
        # static model buckets covering >= 99.9 % of the truth titles; rows
        # whose candidates exceed them go through the host stages
        L = cfg.max_characters
        self._buckets = np.asarray([b for b in cfg.length_buckets if b < L] + [L])
        self._w_buckets = np.asarray([b for b in (16, 32, 64) if b < L] + [L])
        tl999 = int(np.quantile(matcher.truth.lengths, 0.999))
        wl999 = int(np.quantile(np.maximum(self.rerank._wlen_max, 1), 0.999))
        self.tlr_default = self._bucket(min(tl999, L))
        self.wl_default = int(self._w_buckets[np.searchsorted(self._w_buckets, min(wl999, L))])
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None
        self.capture_seconds: Dict[tuple, float] = {}
        LOGGER.info("[FusedServe] mode=%s qb=%d k=%d rerank bucket (%d, %d)",
                    self.mode, self.qb, self.k, self.tlr_default, self.wl_default)

    def _bucket(self, n: int) -> int:
        return int(self._buckets[np.searchsorted(self._buckets, n)])

    # ---------------------------------------------------------- dispatch

    def request(self, queries, rows: np.ndarray):
        """(query rows, static key, {segment: host array}) of one request of
        at most one query block."""
        cfg = self.cfg
        if self.mode == "folded":
            plans = plan_id_blocks(queries, cfg, rows=rows)
        else:
            plans = plan_query_blocks(queries, self.m.index, cfg, rows=rows)
        if len(plans) != 1:
            raise AssertionError("the one-dispatch path takes one query block")
        p = plans[0]
        if self.mode == "folded":
            arrays, u = {"ids": p.ids}, 0
        else:
            self.retrieval.check_plan(p)
            arrays, u = {"union": p.union_ids, "ids": p.w_pos}, p.union_ids.shape[0]
        qb, lq = arrays["ids"].shape
        rws = p.query_rows

        # fuzzy tile: the length-delta prefilter bounds every considered
        # candidate by |q|·(200−thr)/thr, so the query lengths fix it
        L = cfg.max_characters
        thr = int(cfg.levenshtein_ratio_threshold)
        q_len = queries.lengths[rws].astype(np.int64)
        need = int(np.minimum((q_len * (200 - thr) + thr - 1) // thr, L).max(initial=1))
        longest = int(q_len.max(initial=1))
        tlf = self._bucket(min(max(need, longest), L))
        # model tile: the static bucket, widened to hold the query
        tlr = self._bucket(min(max(self.tlr_default, longest), L))
        tlq = max(tlf, tlr)

        def pad(x):
            out = np.zeros((qb,) + x.shape[1:], x.dtype)
            out[: len(rws)] = x
            return out

        ts_all, ts_len_all = queries.encoded_token_sorted
        wo_all, wo_len_all = queries.encoded_wo
        arrays.update(
            q_enc=pad(queries.encoded[rws][:, :tlq]), q_len=pad(queries.lengths[rws]),
            q_ts=pad(ts_all[rws][:, :tlq]), q_ts_len=pad(np.minimum(ts_len_all[rws], tlq)),
            q_wo=pad(wo_all[rws][:, :tlq]), q_wo_len=pad(np.minimum(wo_len_all[rws], tlq)),
        )
        return rws, (self.mode, u, lq, tlf, tlr, self.wl_default), arrays

    def run(self, buf: torch.Tensor, key: tuple) -> torch.Tensor:
        """``fused_cascade`` on a request buffer u8 (the layout of
        ``_segments``): the packed result f32 (8·QB + QB·k,), the stats then
        the candidates' bits."""
        _mode, u, lq, tlf, tlr, wl = key
        segs, _ = _segments(u, self.qb, lq, max(tlf, tlr))
        t = {}
        for name, dt, shape, off in segs:
            nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
            t[name] = buf[off : off + nbytes].view(_TORCH_DTYPE[dt]).reshape(shape)
        stats, cand = fused_cascade(self.retrieval, self.fuzzy, self.rerank, t["ids"], t.get("union"),
                                    t["q_enc"], t["q_len"], t["q_ts"], t["q_ts_len"], t["q_wo"],
                                    t["q_wo_len"], k=self.k, tlf=tlf, tlr=tlr, wl=wl)
        return torch.cat([stats.reshape(-1), cand.reshape(-1).view(torch.float32)])

    @staticmethod
    def _pack(host: np.ndarray, segs, arrays) -> None:
        for name, dt, shape, off in segs:
            nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
            host[off : off + nbytes].view(dt).reshape(shape)[...] = arrays[name]

    def _capture(self, key: tuple, segs, nbytes: int, arrays) -> _Graph:
        """Warm up, then capture the key's graph into the shared pool: a
        ``doppel.capture`` span, whose seconds are ``capture_seconds[key]``."""
        with timing.timed("doppel.capture", graph="FusedServe", rows=self.qb) as sp:
            dev = self.device
            host_in = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=True)
            self._pack(host_in.numpy(), segs, arrays)
            static_in = host_in.to(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.run(static_in, key)
            torch.cuda.current_stream(dev).wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()

            def capture():
                with torch.cuda.graph(graph, pool=self._pool):
                    return self.run(static_in, key)

            out, launches = jk.uncounted(capture)
        FusedServe.captures += 1
        self.capture_seconds[key] = sp.seconds
        LOGGER.info("[FusedServe] captured %s in %.3f s", key, self.capture_seconds[key])
        return _Graph(graph, static_in, out, host_in,
                      torch.empty(out.shape, dtype=out.dtype, pin_memory=True), launches)

    def dispatch(self, queries, rows: np.ndarray, eager: bool = False):
        """One device program for at most one query block.  Returns (query
        rows, stats f32 (8, QB), candidates i32 (QB, k), the model tile tlr),
        host arrays.  ``eager`` runs ``fused_cascade`` op by op on the card
        too, as on the CPU (what a replay is held against)."""
        rws, key, arrays = self.request(queries, rows)
        segs, nbytes = _segments(key[1], self.qb, key[2], max(key[3], key[4]))
        if eager or self.device.type == "cpu":
            buf = np.zeros(nbytes, np.uint8)
            self._pack(buf, segs, arrays)
            packed = self.run(torch.from_numpy(buf).to(self.device), key)
            with timing.span("doppel.fused.wait"):
                out = packed.cpu().numpy()
        else:
            g = self._graphs.get(key)
            if g is None:
                g = self._graphs[key] = self._capture(key, segs, nbytes, arrays)
            else:
                self._pack(g.host_in.numpy(), segs, arrays)
            g.static_in.copy_(g.host_in, non_blocking=True)
            with timing.span("doppel.replay", graph="FusedServe"):
                g.graph.replay()
            FusedServe.replays += 1
            jk.count_replay(g.launches)
            g.host_out.copy_(g.out, non_blocking=True)
            with timing.span("doppel.fused.wait"):
                torch.cuda.current_stream(self.device).synchronize()
            out = g.host_out.numpy().copy()
        qb = self.qb
        return rws, out[: 8 * qb].reshape(8, qb), out[8 * qb :].view(np.int32).reshape(qb, self.k), key[4]

    # ------------------------------------------------------------- decode

    def match(self, queries, rem: np.ndarray, res, single: bool) -> None:
        """Decide the rows ``rem`` (at most one query block) into ``res``.
        Rows whose candidates exceed the static model bucket are decided
        again by the host stages on the fetched candidates."""
        with timing.timed("doppel.fused", rows=len(rem)) as sp:
            rows, stats, cand, tlr = self.dispatch(queries, rem)
            res.stage_seconds["retrieval"] = sp.seconds
            fz_matched, fz_pos, _fz_ratio, md_cnt, md_pos, md_pred, probe_tl, probe_wl = stats
            thr_p = self.cfg.prediction_probability_threshold
            fallback = []
            n_fz = n_md = 0
            for j, qi in enumerate(rows):
                if probe_tl[j] > tlr or probe_wl[j] > self.wl_default:
                    fallback.append((j, qi))
                elif fz_matched[j] > 0:
                    self.m._record(res, qi, int(fz_pos[j]), 1.0, STAGE_FUZZY)
                    n_fz += 1
                elif single or (md_cnt[j] == 1 and md_pred[j] > thr_p):
                    # a single title takes the first max whatever its value
                    self.m._record(res, qi, int(md_pos[j]), float(md_pred[j]), STAGE_MODEL)
                    n_md += 1
            res.stage_counts["fuzzy"] = n_fz
            res.stage_counts["model"] = n_md
            sp.set(fallback_rows=len(fallback))
            if fallback:
                LOGGER.info("[FusedServe] %d rows exceed the (%d, %d) rerank bucket; classic host redo",
                            len(fallback), tlr, self.wl_default)
                with timing.span("doppel.fused.redo", rows=len(fallback)):
                    js = np.asarray([j for j, _ in fallback])
                    qs = np.asarray([qi for _, qi in fallback], dtype=np.int64)
                    cand_sub = cand[js]
                    self.m._stage_fuzzy(queries, qs, cand_sub, res)
                    res.stage_counts["fuzzy"] += n_fz
                    still = res.stage[qs] == STAGE_NONE
                    if still.any():
                        self.m._stage_model(queries, qs[still], cand_sub[still], res, single)
                        res.stage_counts["model"] += n_md
        res.stage_seconds["fuzzy"] = 0.0
        res.stage_seconds["model"] = 0.0
