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
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from doppelspeller_tpu_torch.config import Config, get_config
from doppelspeller_tpu_torch.device import resolve_device, synchronize
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.models.trainer import WordCounts
from doppelspeller_tpu_torch.ops.features import split_words_host
from doppelspeller_tpu_torch.ops.fuzzy import FuzzyEngine
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import TruthIndex, build_truth_index, title_content_hash
from doppelspeller_tpu_torch.ops.rerank import RerankEngine
from doppelspeller_tpu_torch.utils import text as T
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


class Matcher:
    """End-to-end matcher over a truth database, on one device.

    ``truth`` defaults to ``load_ground_truth(config)``.  Without ``index``
    the index checkpoint at ``config.index_path`` is used when its count,
    ids and content hash match the truth; a checkpoint that does not match,
    or that this package cannot read (the JAX package's among them), is
    rebuilt with a warning.  ``model`` defaults to ``config.model_path``,
    read at the first use of stage 3."""

    def __init__(self, config: Optional[Config] = None, truth: Optional[TitleSet] = None,
                 model: Optional[GBTModel] = None, device="cuda", *,
                 index: Optional[TruthIndex] = None, use_index_checkpoint: bool = True):
        self.cfg = config = config or get_config()
        self.device = resolve_device(device)
        self.truth = truth = truth or load_ground_truth(config)
        if index is None and use_index_checkpoint and os.path.exists(config.index_path):
            index = self._checkpoint(config.index_path, truth)
        self.index = index or build_truth_index(truth, config)
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
        self._word_counts: Optional[np.ndarray] = None
        self.set_model(model)

    @staticmethod
    def _checkpoint(path: str, truth: TitleSet) -> Optional[TruthIndex]:
        """The checkpointed index at ``path`` if it holds this truth, else None."""
        try:
            loaded = TruthIndex.load(path)
        except Exception as exc:  # stale, old-format or foreign checkpoint
            LOGGER.warning("index checkpoint at %s unreadable (%s); rebuilding", path, exc)
            return None
        if (loaded.num_titles == len(truth) and np.array_equal(loaded.title_ids, truth.ids)
                and loaded.content_hash == title_content_hash(truth.encoded, truth.lengths)):
            LOGGER.info("loaded index checkpoint from %s", path)
            return loaded
        LOGGER.warning("index checkpoint at %s does not match the truth data; rebuilding", path)
        return None

    def set_model(self, model: Optional[GBTModel]) -> None:
        """Take another model for stage 3 (say, one just trained) over the
        same truth database: only the model stage's engine is rebuilt, at
        its next use.  ``None`` reads ``config.model_path`` then."""
        self.model = model
        self._rerank: Optional[RerankEngine] = None

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
        return self._rerank

    def _reference_host_path(self, n_rows: int) -> bool:
        """Whether the JAX package decides ``n_rows`` rows (one wave, past
        the exact stage) in its host stages rather than its one-dispatch
        path: a batch over one query block, or either path switched off."""
        cfg = self.cfg
        qb = (cfg.fold_query_block or cfg.query_block) if self.scorer.folded is not None \
            else cfg.query_block
        return cfg.serve_fused == "off" or cfg.cascade_impl == "host" or n_rows > qb

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
        if not waves and self._reference_host_path(len(rem)):
            self._raise_on_padding(cand, order)
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
