"""The prediction cascade: exact → Jaccard top-n → fuzzy Levenshtein → model.

The JAX package's ``pipeline.py`` (``Matcher.predict`` with its device
cascade) in PyTorch, on one device: the card unless the caller names the
CPU.  Stages:

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

The TPU package's static slab and bucket shapes exist for XLA recompiles;
here the rows are only grouped by the (TL, WL) bucket their candidates need
and taken ``model_slab`` at a time.  Results do not depend on that padding.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.device import resolve_device, synchronize
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.models.trainer import WordCounts
from doppelspeller_tpu_torch.ops.features import split_words_host
from doppelspeller_tpu_torch.ops.fuzzy import FuzzyEngine
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
from doppelspeller_tpu_torch.ops.rerank import RerankEngine
from doppelspeller_tpu_torch.utils import text as T
from doppelspeller_tpu_torch.utils.io import TitleSet

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


class Matcher:
    """End-to-end matcher over a truth database, on one device."""

    def __init__(self, config: Config, truth: TitleSet, model: GBTModel, device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self.truth = truth
        self.index = build_truth_index(truth, config)
        self.scorer = JaccardScorer(self.index, config, self.device, truth)
        # exact-match lookup: duplicate transformed titles → last id wins
        self.reverse: Dict[str, int] = {
            t: int(i) for t, i in zip(truth.transformed, truth.ids)
        }
        self.truth_words = split_words_host(truth.encoded, truth.lengths)
        wlen_max = self.truth_words[1].max(axis=1).astype(np.int32)
        ts = [" ".join(sorted(t.split())) for t in truth.transformed]
        ts_enc = T.encode_titles(ts, config.max_characters)
        ts_len = np.array([min(len(s), config.max_characters) for s in ts], np.int32)
        self.fuzzy = FuzzyEngine(truth.encoded, truth.lengths, ts_enc, ts_len, wlen_max,
                                 config, self.device)
        self._word_counts = WordCounts(truth).matrix(truth.transformed)
        self.set_model(model)

    def set_model(self, model: GBTModel) -> None:
        """Take another model for stage 3 (say, one just trained) over the
        same truth database: only the model stage's engine is rebuilt."""
        self.model = model
        self.rerank = RerankEngine(self.truth.encoded, self.truth.lengths, self.truth_words,
                                   self._word_counts, model, len(self.truth), self.cfg, self.device)

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

    def _cascade_device(self, queries: TitleSet, rem: np.ndarray,
                        res: PredictionResult, waves: bool = True,
                        single: bool = False) -> None:
        """Retrieval, fuzzy and model stages for the rows ``rem``.  Without
        ``waves`` stage 3 scores every candidate in one pass; ``single``
        (one row) records the first max of all its probabilities whatever
        its value and count."""
        cfg = self.cfg
        dev = self.device
        k = cfg.top_n_predicting
        buckets = [b for b in cfg.length_buckets if b < cfg.max_characters]
        buckets.append(cfg.max_characters)
        buckets_arr = np.asarray(buckets)
        # a fuzzy-considered candidate satisfies the length-delta prefilter,
        # so |t| <= ceil(|q|·(200−thr)/thr): the fuzzy tile is derived from
        # the threshold and no considered pair can overflow it
        thr_i = int(cfg.levenshtein_ratio_threshold)
        q_len_all = queries.lengths.astype(np.int64)
        need_all = np.minimum((q_len_all * (200 - thr_i) + thr_i - 1) // thr_i,
                              cfg.max_characters)
        titles = np.array(queries.transformed, dtype=object)
        fzb = np.searchsorted(buckets_arr, need_all[rem])
        order = np.lexsort((titles[rem], fzb))
        rem = rem[order]
        fzb = fzb[order]

        t0 = time.time()
        _, cand = self.scorer.topk_device(queries, k=k, rows=rem)          # (R, k) i32
        synchronize(dev)
        t_retr = time.time()
        res.stage_seconds["retrieval"] = t_retr - t0

        # ---- stage 2: fuzzy, per tile bucket ----
        R = len(rem)
        ts_enc_all, ts_len_all = queries.encoded_token_sorted
        matched = np.zeros(R, bool)
        best_pos = np.zeros(R, np.int64)
        probe_tl = np.zeros(R, np.int64)
        probe_wl = np.zeros(R, np.int64)
        for bi in np.unique(fzb):
            sel = np.flatnonzero(fzb == bi)
            TL = int(buckets_arr[bi])
            src = rem[sel]
            sel_d = torch.from_numpy(sel).to(dev)
            out = self.fuzzy.decide(
                torch.from_numpy(np.ascontiguousarray(queries.encoded[src, :TL])).to(dev),
                torch.from_numpy(queries.lengths[src]).to(dev),
                torch.from_numpy(np.ascontiguousarray(ts_enc_all[src, :TL])).to(dev),
                torch.from_numpy(ts_len_all[src]).to(dev),
                cand[sel_d], TL,
            )
            m, bp, _ratio, over, ptl, pwl = (x.cpu().numpy() for x in out)
            if over.any():
                raise AssertionError("fuzzy tile overflow with an uncapped tile")
            matched[sel] = m
            best_pos[sel] = bp
            probe_tl[sel] = ptl
            probe_wl[sel] = pwl
        hits = 0
        for j in np.flatnonzero(matched):
            self._record(res, rem[j], int(best_pos[j]), 1.0, STAGE_FUZZY)
            hits += 1
        res.stage_counts["fuzzy"] = hits
        t1 = time.time()
        res.stage_seconds["fuzzy"] = t1 - t_retr

        # ---- stage 3: model on still-unmatched rows ----
        todo = np.flatnonzero(~matched)                     # indices into rem
        if len(todo) == 0:
            res.stage_counts["model"] = 0
            res.stage_seconds["model"] = time.time() - t1
            return
        gq = rem[todo]
        tl_need = np.maximum(q_len_all[gq], probe_tl[todo])
        wl_need = np.maximum(probe_wl[todo], 1)
        w_buckets = [b for b in (16, 32, 64) if b < cfg.max_characters]
        w_buckets.append(cfg.max_characters)
        w_arr = np.asarray(w_buckets)
        tbi = np.searchsorted(buckets_arr, np.minimum(tl_need, cfg.max_characters))
        wbi = np.searchsorted(w_arr, np.minimum(wl_need, cfg.max_characters))
        tbi = np.maximum(tbi, np.searchsorted(buckets_arr, w_arr)[wbi])

        wo_enc, wo_len = queries.encoded_wo
        q_enc_d = torch.from_numpy(np.ascontiguousarray(queries.encoded[gq])).to(dev)
        q_len_d = torch.from_numpy(queries.lengths[gq]).to(dev)
        q_wo_d = torch.from_numpy(np.ascontiguousarray(wo_enc[gq])).to(dev)
        q_wo_len_d = torch.from_numpy(wo_len[gq]).to(dev)
        cand_todo = cand[torch.from_numpy(todo).to(dev)]
        slab = int(cfg.model_slab)
        n = len(todo)

        def run_wave(rows_t: np.ndarray, narrow: int, col_lo: int = 0):
            """(cnt, pos, mx) host arrays over todo rows ``rows_t`` (others
            left at cnt 0, mx −inf)."""
            cnt = np.zeros(n, np.int64)
            pos = np.zeros(n, np.int64)
            mx = np.full(n, -np.inf, np.float32)
            for ti, TL in enumerate(buckets):
                for wi, WL in enumerate(w_buckets):
                    if WL > TL:
                        continue
                    sub = rows_t[(tbi[rows_t] == ti) & (wbi[rows_t] == wi)]
                    for s in range(0, len(sub), slab):
                        sl = sub[s : s + slab]
                        sl_d = torch.from_numpy(sl).to(dev)
                        c, p, m = self.rerank.decide(
                            q_enc_d[sl_d], q_len_d[sl_d], q_wo_d[sl_d], q_wo_len_d[sl_d],
                            cand_todo[sl_d], TL, WL, narrow=narrow, col_lo=col_lo,
                        )
                        cnt[sl] = c.cpu().numpy()
                        pos[sl] = p.cpu().numpy()
                        mx[sl] = m.cpu().numpy()
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
        cnt_a, pos_a, mx_a = run_wave(all_rows, k1 if adaptive else 0)
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
                cnt_b, pos_b, mx_b = run_wave(widen, 0, col_lo=k1)
                a_wins = mx_a[widen] >= mx_b[widen]         # ties keep A (first col)
                tie = mx_a[widen] == mx_b[widen]
                mx_a[widen] = np.where(a_wins, mx_a[widen], mx_b[widen])
                pos_a[widen] = np.where(a_wins, pos_a[widen], pos_b[widen])
                cnt_a[widen] = np.where(tie, cnt_a[widen] + cnt_b[widen],
                                        np.where(a_wins, cnt_a[widen], cnt_b[widen]))
                hits += apply(widen, cnt_a, pos_a, mx_a)
        res.stage_counts["model"] = hits
        res.stage_seconds["model"] = time.time() - t1

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
        res = PredictionResult(
            test_index=queries.ids.copy(),
            match_title_id=np.full(n, cfg.train_not_found_value, dtype=np.int64),
            prediction=np.zeros(n, dtype=np.float32),
            stage=np.zeros(n, dtype=np.uint8),
            transformed=list(queries.transformed),
            match_transformed=[None] * n,
        )
        t0 = time.time()
        self._stage_exact(queries, res)
        res.stage_seconds = {"exact": time.time() - t0, "retrieval": 0.0,
                             "fuzzy": 0.0, "model": 0.0}
        res.stage_counts.update(fuzzy=0, model=0)
        rem = np.flatnonzero(res.stage == STAGE_NONE)
        if len(rem):
            impl = cfg.cascade_impl
            waves = not single and (
                impl == "device"
                or (impl == "auto" and len(rem) >= DEVICE_CASCADE_MIN_ROWS))
            self._cascade_device(queries, rem, res, waves=waves, single=single)
        LOGGER.info("Matched %d/%d titles (exact %d, fuzzy %d, model %d)",
                    int((res.stage != STAGE_NONE).sum()), n, res.stage_counts["exact"],
                    res.stage_counts["fuzzy"], res.stage_counts["model"])
        return res
