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
tiles) is a CUDA graph in the retrieval scorer's ``Workers``
(``parallel/workers.py``): captured at its first request, which answers
with the capture's op-by-op warm-up, then replayed on the caller's stream,
with one copy of a pinned buffer in and one out.  A failed capture or
replay raises.  Where the workers run op by op (the CPU, ``use_graphs =
False``), so does the program.

Each row's probe (its candidates' longest title and word) rides along: the
cascade (``pipeline.Matcher._stage_fused``) decides the result and sends a
row past the static model bucket (at least 99.9 % of the truth titles) to
its host stages, as the reference does.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from doppelspeller_tpu_torch.ops.fold import plan_id_blocks
from doppelspeller_tpu_torch.ops.jaccard_kernels import kernel_a_queries
from doppelspeller_tpu_torch.ops.ngram_index import plan_query_blocks
from doppelspeller_tpu_torch.ops.tiles import device_word_grid, fuzzy_tile_bound, query_block, title_grid
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
    """The request buffer's layout: [(name, dtype, shape, byte slice)]
    with each segment 16-byte aligned, and its size in bytes."""
    segs = [("union", np.int32, (u,))] if u else []
    segs += [("ids", np.int32, (qb, lq)), ("q_len", np.int32, (qb,)),
             ("q_ts_len", np.int32, (qb,)), ("q_wo_len", np.int32, (qb,)),
             ("q_enc", np.uint8, (qb, tlq)), ("q_ts", np.uint8, (qb, tlq)),
             ("q_wo", np.uint8, (qb, tlq))]
    out, off = [], 0
    for name, dt, shape in segs:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        out.append((name, dt, shape, slice(off, off + n)))
        off += -(-n // 16) * 16
    return out, off


_TORCH_DTYPE = {np.int32: torch.int32, np.uint8: torch.uint8}


class FusedServe:
    """The one-dispatch path's device program over a truth database's
    resident engines: the retrieval scorer (``ops/jaccard.py``), whose
    ``workers`` keep its graphs, and the fuzzy and model engines.  ``cfg``
    sets the query block and the cascade's settings; ``truth_lengths``
    size the static model bucket."""

    # the graphs are counted in the workers' ``captures["FusedServe"]``;
    # kept at 0 for benchmark/drive.py, whose capture count adds it
    captures = 0

    def __init__(self, cfg, scorer, fuzzy, rerank, truth_lengths: np.ndarray):
        self.cfg, self.scorer, self.fuzzy, self.rerank = cfg, scorer, fuzzy, rerank
        self.device = scorer.device
        self.mode = "folded" if scorer.folded is not None else "exact"
        self.retrieval = scorer.engine(0)
        self.k = cfg.top_n_predicting
        self.qb = query_block(cfg, scorer.folded is not None)
        # the query rows kernel A computes for a folded block, the request's
        # padded to its tile (0 on the exact engine, whose A scores a union)
        self.a_queries = kernel_a_queries(self.qb) if self.mode == "folded" else 0
        # static model buckets covering >= 99.9 % of the truth titles; rows
        # whose candidates exceed them go through the host stages
        L = cfg.max_characters
        self._buckets = np.asarray(title_grid(cfg, L))
        self._w_buckets = np.asarray(device_word_grid(L))
        tl999 = int(np.quantile(truth_lengths, 0.999))
        wl999 = int(np.quantile(np.maximum(rerank._wlen_max, 1), 0.999))
        self.tlr_default = self._bucket(min(tl999, L))
        self.wl_default = int(self._w_buckets[np.searchsorted(self._w_buckets, min(wl999, L))])
        # each key's pinned host twins of its graph's input and output
        self._host: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        LOGGER.info("[FusedServe] mode=%s qb=%d k=%d rerank bucket (%d, %d)",
                    self.mode, self.qb, self.k, self.tlr_default, self.wl_default)

    def _bucket(self, n: int) -> int:
        return int(self._buckets[np.searchsorted(self._buckets, n)])

    def request(self, queries, rows: np.ndarray):
        """(query rows, graph key, {segment: host array, the query rows'
        only}) of one request of at most one query block."""
        cfg = self.cfg
        if self.mode == "folded":
            plans = plan_id_blocks(queries, cfg, rows=rows)
        else:
            plans = plan_query_blocks(queries, self.scorer.index, cfg, rows=rows)
        if len(plans) != 1:
            raise AssertionError("the one-dispatch path takes one query block")
        p = plans[0]
        if self.mode == "folded":
            arrays, u = {"ids": p.ids}, 0
        else:
            self.retrieval.check_plan(p)
            arrays, u = {"union": p.union_ids, "ids": p.w_pos}, p.union_ids.shape[0]
        lq = arrays["ids"].shape[1]
        rws = p.query_rows

        # fuzzy tile: the length-delta prefilter bounds every considered
        # candidate, so the query lengths fix it
        L = cfg.max_characters
        need = int(fuzzy_tile_bound(queries.lengths[rws], cfg).max(initial=1))
        longest = int(queries.lengths[rws].max(initial=1))
        tlf = self._bucket(min(max(need, longest), L))
        # model tile: the static bucket, widened to hold the query
        tlr = self._bucket(min(max(self.tlr_default, longest), L))
        tlq = max(tlf, tlr)
        ts_all, ts_len_all = queries.encoded_token_sorted
        wo_all, wo_len_all = queries.encoded_wo
        arrays.update(
            q_enc=queries.encoded[rws][:, :tlq], q_len=queries.lengths[rws],
            q_ts=ts_all[rws][:, :tlq], q_ts_len=np.minimum(ts_len_all[rws], tlq),
            q_wo=wo_all[rws][:, :tlq], q_wo_len=np.minimum(wo_len_all[rws], tlq),
        )
        return rws, ("FusedServe", self.mode, u, lq, tlf, tlr, self.wl_default), arrays

    def run(self, buf: torch.Tensor, key: tuple) -> torch.Tensor:
        """``fused_cascade`` on a request buffer u8 (the layout of
        ``_segments``): the packed result f32 (8·QB + QB·k,), the stats then
        the candidates' bits."""
        _name, _mode, u, lq, tlf, tlr, wl = key
        segs, _ = _segments(u, self.qb, lq, max(tlf, tlr))
        t = {name: buf[sl].view(_TORCH_DTYPE[dt]).reshape(shape) for name, dt, shape, sl in segs}
        stats, cand = fused_cascade(self.retrieval, self.fuzzy, self.rerank, t["ids"], t.get("union"),
                                    t["q_enc"], t["q_len"], t["q_ts"], t["q_ts_len"], t["q_wo"],
                                    t["q_wo_len"], k=self.k, tlf=tlf, tlr=tlr, wl=wl)
        return torch.cat([stats.reshape(-1), cand.reshape(-1).view(torch.float32)])

    def dispatch(self, queries, rows: np.ndarray, eager: bool = False):
        """One device program for at most one query block.  Returns (query
        rows, stats f32 (8, QB), candidates i32 (QB, k), the model tile tlr),
        host arrays.  Where the workers run graphs the key's graph is
        captured at its first request (whose result is the warm-up's) and
        replayed at every later one; ``eager``, or workers that run op by
        op, run ``fused_cascade`` op by op (what a replay is held against).
        The request's plan and its staging into the pinned input buffer are
        the ``doppel.fused.plan`` span (counts ``folded``, ``lq``,
        ``query_rows``, ``a_queries``)."""
        with timing.span("doppel.fused.plan", folded=int(self.mode == "folded")) as sp:
            rws, key, arrays = self.request(queries, rows)
            sp.set(lq=key[3], query_rows=len(rws), a_queries=self.a_queries)
            segs, nbytes = _segments(key[2], self.qb, key[3], max(key[4], key[5]))
            if key not in self._host:
                pin = self.device.type == "cuda"
                self._host[key] = (torch.zeros(nbytes, dtype=torch.uint8, pin_memory=pin),
                                   torch.empty(self.qb * (8 + self.k), dtype=torch.float32,
                                               pin_memory=pin))
            host_in, host_out = self._host[key]
            for name, dt, shape, sl in segs:
                seg, n = host_in.numpy()[sl].view(dt).reshape(shape), len(arrays[name])
                seg[:n], seg[n:] = arrays[name], 0        # zeros past the request's rows
        # a graph replays on the caller's stream, which every run of the
        # shards joins (``to_first``) and every later one forks from: on an
        # H100 shard 0's stream cost 0.1-0.25 ms more a request after an idle
        # gap (its event waits)
        workers = self.scorer.workers
        if eager or not workers.graphed:
            packed = self.run(host_in.to(self.device), key)
        elif (0, key) in workers.graphs:
            packed, = workers.replay(0, key, (host_in,))
        else:
            workers.fork()
            packed, = workers.capture(0, key, lambda buf: (self.run(buf, key),), (host_in,), rows=self.qb)
        host_out.copy_(packed, non_blocking=True)
        with timing.span("doppel.fused.wait"):
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        out = host_out.numpy().copy()
        qb = self.qb
        return rws, out[: 8 * qb].reshape(8, qb), out[8 * qb :].view(np.int32).reshape(qb, self.k), key[5]
