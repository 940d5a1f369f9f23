"""Stage 3, the model decide: gather → 66 features → GBT → probability.

The JAX package's ``ops/rerank.py`` (``_word_chars``,
``_score_gathered_pairs``, ``_rerank_decide_kernel``, ``RerankEngine``).  The
truth-side tables and the forest stay on the device; per call the engine
takes the query rows and their candidate positions and returns per-row
statistics (count at max, position of the first max, max probability) over
candidate columns [col_lo, col_lo + narrow), so the waves of the adaptive
depth cascade merge exactly.  ``RerankEngine.score`` is the reference's
host-stage entry: the probabilities of (query row, truth row) pairs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.device import resolve_device
from doppelspeller_tpu_torch.models.gbt import GBTModel, predict_forest_margin
from doppelspeller_tpu_torch.ops.features import features_kernel, gather_word_chars
from doppelspeller_tpu_torch.ops.tiles import host_word_grid, title_grid
from doppelspeller_tpu_torch.utils import timing

# pairs scored per features + forest call: one full wave-A slab at the
# default config (model_slab 2048 rows × 32 candidates); bounds the
# (pairs, trees, nodes) temporaries to ~0.5 GB
_PAIR_CHUNK = 1 << 16


def word_chars(t_wchars, t_start, t_wlen, t_enc, pair_t, wl: int) -> torch.Tensor:
    """(B, W, wl) word chars of the gathered truth rows, zero past word_len:
    a slice of the resident (n_truth, W, 32) table when wl <= 32, else
    gathered from the encodings."""
    if wl <= t_wchars.shape[2]:
        return t_wchars[pair_t][:, :, :wl]
    te = t_enc[pair_t]
    start = t_start[pair_t]
    wlen = t_wlen[pair_t]
    B, W = start.shape
    j = torch.arange(wl, device=te.device)
    idx = torch.clamp(start[:, :, None] + j[None, None, :], 0, te.shape[1] - 1)
    chars = torch.gather(te, 1, idx.reshape(B, W * wl)).reshape(B, W, wl)
    return chars * (j[None, None, :] < wlen[:, :, None]).to(chars.dtype)


class RerankEngine(nn.Module):
    """Device-resident stage-3 scorer over a fixed truth set and model."""

    def __init__(self, truth_enc: np.ndarray, truth_len: np.ndarray,
                 truth_words: Tuple[np.ndarray, np.ndarray, np.ndarray],
                 counts_matrix: np.ndarray, model: GBTModel, n_truth: int,
                 config: Config, device="cuda"):
        super().__init__()
        self.cfg = config
        self.device = resolve_device(device)

        def put(x, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device=self.device, dtype=dtype)

        start, wlen, nwords = truth_words
        self.n_truth = float(n_truth)
        # longest word per title (of its first 15), on the host for bucketing
        self._wlen_max = wlen.max(axis=1)
        self.register_buffer("t_enc", put(truth_enc))
        self.register_buffer("t_len", put(truth_len, torch.int32))
        self.register_buffer("t_start", put(start, torch.int64))
        self.register_buffer("t_wlen", put(wlen, torch.int32))
        self.register_buffer("t_nwords", put(nwords, torch.int32))
        self.register_buffer("t_counts", put(counts_matrix.astype(np.float32)))
        self.register_buffer("t_wchars", put(gather_word_chars(truth_enc, start, wlen, 32)))
        feat, thr, ml, val, leaf = model.forest_arrays(self.device)
        self.register_buffer("m_feat", feat)
        self.register_buffer("m_thr", thr)
        self.register_buffer("m_ml", ml)
        self.register_buffer("m_val", val)
        self.register_buffer("m_leaf", leaf)
        self.depth = model.depth
        self.base_margin = model.base_margin

    def score_pairs(self, qe, ql, qw, qwl, pair_t: torch.Tensor, tl: int, wl: int) -> torch.Tensor:
        """Probabilities float32[B] of B gathered pairs (query side already
        per pair, sliced to ``tl``; ``pair_t`` truth positions)."""
        chars = word_chars(self.t_wchars, self.t_start, self.t_wlen, self.t_enc, pair_t, wl)
        feats = features_kernel(
            qe, ql, self.t_enc[pair_t][:, :tl], torch.clamp(self.t_len[pair_t], min=1),
            chars.contiguous(), self.t_wlen[pair_t], torch.clamp(self.t_nwords[pair_t], min=1),
            qw, torch.clamp(qwl, min=1), self.t_counts[pair_t], self.n_truth,
        )
        margins = predict_forest_margin(feats, self.m_feat, self.m_thr, self.m_ml,
                                        self.m_val, self.m_leaf, self.depth, self.base_margin)
        return torch.sigmoid(margins)

    def decide(self, q_enc: torch.Tensor, q_len: torch.Tensor, q_wo: torch.Tensor,
               q_wo_len: torch.Tensor, cand: torch.Tensor, tl: int, wl: int,
               narrow: int = 0, col_lo: int = 0):
        """Per-row (n_at_max int64[R], best_pos int32[R], best_pred f32[R])
        over candidate columns [col_lo, col_lo + narrow) of ``cand`` (R, K)
        (to the end when ``narrow`` is 0).  Query tensors are (R, ≥tl)."""
        K = narrow if narrow else cand.shape[1] - col_lo
        R = cand.shape[0]
        cd = cand[:, col_lo : col_lo + K]
        # padding candidates read the last title (see ``fuzzy_decide``)
        pair_t = cd.reshape(-1).to(torch.int64).clamp(max=self.t_len.shape[0] - 1)
        rows = torch.arange(R * K, device=cand.device) // K
        preds = torch.empty(R * K, dtype=torch.float32, device=cand.device)
        for s in range(0, R * K, _PAIR_CHUNK):
            r = rows[s : s + _PAIR_CHUNK]
            preds[s : s + _PAIR_CHUNK] = self.score_pairs(
                q_enc[r, :tl].contiguous(), q_len[r], q_wo[r, :tl].contiguous(), q_wo_len[r],
                pair_t[s : s + _PAIR_CHUNK], tl, wl,
            )
        preds = preds.reshape(R, K)
        mx = preds.max(dim=1).values
        at_max = preds == mx[:, None]
        cnt = at_max.sum(dim=1)
        best_col = at_max.to(torch.int32).argmax(dim=1)                  # first max
        best_pos = torch.gather(cd, 1, best_col[:, None].to(torch.int64))[:, 0]
        return cnt, best_pos, mx

    def score(self, q_enc: np.ndarray, q_len: np.ndarray, q_wo: np.ndarray,
              q_wo_len: np.ndarray, pair_q: np.ndarray, pair_t: np.ndarray,
              t_len_host: np.ndarray) -> np.ndarray:
        """Probabilities float32[N] of N (query row, truth row) pairs, in
        (TL, WL) buckets of the longer title of the pair and the candidate's
        longest word, as the reference's host stage scores them (a pair
        whose word bucket is wider than its title bucket is left at 0
        there, and here)."""
        L = q_enc.shape[1]
        pair_len = np.maximum(q_len[pair_q], t_len_host[pair_t])
        max_word = np.maximum(self._wlen_max[pair_t], 1)
        buckets = title_grid(self.cfg, L)
        w_buckets = host_word_grid(L, every=True)
        tb = np.searchsorted(np.asarray(buckets), pair_len)
        wb = np.searchsorted(np.asarray(w_buckets), max_word)

        def put(x, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device=self.device, dtype=dtype)

        qe, ql = put(q_enc), put(q_len, torch.int32)
        qw, qwl = put(q_wo), put(q_wo_len, torch.int32)
        out = np.zeros(len(pair_q), dtype=np.float32)
        for ti, TL in enumerate(buckets):
            for wi, WL in enumerate(w_buckets):
                if WL > TL:
                    continue
                sel = np.flatnonzero((tb == ti) & (wb == wi))
                for s in range(0, len(sel), _PAIR_CHUNK):
                    idx = sel[s : s + _PAIR_CHUNK]
                    pq, pt = put(pair_q[idx], torch.int64), put(pair_t[idx], torch.int64)
                    pred = self.score_pairs(qe[pq, :TL].contiguous(), ql[pq],
                                            qw[pq, :TL].contiguous(), qwl[pq], pt, TL, WL)
                    with timing.span("doppel.score.wait"):
                        out[idx] = pred.cpu().numpy()
        return out
