"""Stage 2, the fuzzy decide, on the device.

The JAX package's ``ops/fuzzy.py::_fuzzy_decide_kernel`` and ``FuzzyEngine``.
Per row of candidates: the length-delta prefilter, the rounded Levenshtein
ratio with the token-sort ratio as fallback (banker's rounding), keep
ratio > threshold, per-row max, and a row whose max is tied between
candidates drops to the model stage.  The stage-3 probe (max candidate title
and word length of the row) rides along, as in the reference.

``FuzzyEngine.ratios`` is the reference's host-stage entry: final ratios of
(query row, truth row) pairs, for the host redo of rows a device program
could not decide.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.device import resolve_device
from doppelspeller_tpu_torch.ops.levenshtein import rounded_ratio
from doppelspeller_tpu_torch.utils import timing

# pairs scored per LCS call (bounds the (pairs, TL, words) temporaries)
_PAIR_CHUNK = 1 << 16


def _ratios(a, la, b, lb, tl: int) -> torch.Tensor:
    out = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    for s in range(0, a.shape[0], _PAIR_CHUNK):
        e = s + _PAIR_CHUNK
        out[s:e] = rounded_ratio(a[s:e, :tl], la[s:e], b[s:e, :tl], lb[s:e])
    return out


def fuzzy_decide(
    q_enc, q_len, q_ts, q_ts_len,        # (R, TL) / (R,) query side
    t_enc, t_len, t_ts, t_ts_len,        # truth side, resident
    t_wlen_max,                          # int32[n_truth] max word length per title
    cand,                                # int32 (R, K) candidate truth positions
    *, tl: int, threshold: int, static: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Returns (matched bool[R], best_pos int32[R], best_ratio int32[R],
    over bool[R], probe_tl int32[R], probe_wl int32[R]).

    By default only the pairs the prefilter considers are scored, and the
    token-sort ratio only where the plain one is at or under the threshold,
    which takes a host sync.  ``static`` scores both ratios of every pair
    instead (the reference's one-dispatch body), with no host sync, so a
    CUDA graph can hold it; the results are the same."""
    R, K = cand.shape
    # a padding candidate (position >= the truth count, score -1: window
    # select over fewer titles than k windows) reads the last title, as the
    # reference's clamped device gathers do; best_pos keeps the position
    pos = cand.reshape(-1).to(torch.int64).clamp(max=t_len.shape[0] - 1)
    tle = t_len[pos]
    ttsl = t_ts_len[pos]
    probe_tl = tle.reshape(R, K).max(dim=1).values
    probe_wl = t_wlen_max[pos].reshape(R, K).max(dim=1).values

    ql_r = q_len[:, None].expand(R, K).reshape(-1)
    tot = ql_r + tle
    delta = torch.abs(ql_r - tle)
    del_ratio = (tot - delta).to(torch.float32) / torch.clamp(tot, min=1).to(torch.float32) * 100.0
    consider = del_ratio >= threshold

    if static:
        row = torch.arange(R * K, device=cand.device) // K
        r1 = _ratios(q_enc[row], q_len[row], t_enc[pos], tle, tl)
        r2 = _ratios(q_ts[row], q_ts_len[row], t_ts[pos], ttsl, tl)
        ratio = torch.where(consider, torch.where(r1 > threshold, r1, r2), torch.zeros_like(r1))
    else:
        # considered pairs only (the rest stay 0)
        ratio = torch.zeros(R * K, dtype=torch.int32, device=cand.device)
        idx = torch.nonzero(consider).flatten()
        if idx.numel():
            row = idx // K
            tp = pos[idx]
            r1 = _ratios(q_enc[row], q_len[row], t_enc[tp], tle[idx], tl)
            ratio[idx] = r1
            low = torch.nonzero(r1 <= threshold).flatten()
            if low.numel():
                i2 = idx[low]
                row2 = row[low]
                tp2 = tp[low]
                ratio[i2] = _ratios(q_ts[row2], q_ts_len[row2], t_ts[tp2], ttsl[i2], tl)
    ratio = ratio.reshape(R, K)

    keep = ratio > threshold
    masked = torch.where(keep, ratio, torch.full_like(ratio, -1))
    mx = masked.max(dim=1).values
    cnt = (masked == mx[:, None]).sum(dim=1)
    matched = (mx > -1) & (cnt == 1)
    best_col = (masked == mx[:, None]).to(torch.int32).argmax(dim=1)      # first max
    best_pos = torch.gather(cand, 1, best_col[:, None].to(torch.int64))[:, 0]
    too_long = torch.maximum(torch.maximum(tle, ttsl), ql_r) > tl
    over = (consider & too_long).reshape(R, K).any(dim=1)
    return matched, best_pos, mx, over, probe_tl, probe_wl


class FuzzyEngine(nn.Module):
    """Device-resident stage-2 scorer over a fixed truth set."""

    def __init__(self, truth_enc: np.ndarray, truth_len: np.ndarray,
                 ts_truth_enc: np.ndarray, ts_truth_len: np.ndarray,
                 truth_wlen_max: np.ndarray, config: Config, device="cuda"):
        super().__init__()
        self.cfg = config
        self.device = resolve_device(device)

        def put(x, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.to(device=self.device, dtype=dtype)

        self.register_buffer("t_enc", put(truth_enc))
        self.register_buffer("t_len", put(truth_len, torch.int64))
        self.register_buffer("t_ts", put(ts_truth_enc))
        self.register_buffer("t_ts_len", put(ts_truth_len, torch.int64))
        self.register_buffer("t_wlen_max", put(truth_wlen_max, torch.int64))

    def decide(self, q_enc: torch.Tensor, q_len: torch.Tensor, ts_q_enc: torch.Tensor,
               ts_q_len: torch.Tensor, cand: torch.Tensor, tl: int, static: bool = False):
        """Device decisions for rows whose fuzzy tile is ``tl`` (see
        ``fuzzy_decide``); query tensors are (R, ≥tl) on the device."""
        return fuzzy_decide(
            q_enc, q_len.to(torch.int64), ts_q_enc, ts_q_len.to(torch.int64),
            self.t_enc, self.t_len, self.t_ts, self.t_ts_len, self.t_wlen_max,
            cand, tl=tl, threshold=self.cfg.levenshtein_ratio_threshold, static=static,
        )

    def ratios(self, q_enc: np.ndarray, q_len: np.ndarray, ts_q_enc: np.ndarray,
               ts_q_len: np.ndarray, pair_q: np.ndarray, pair_t: np.ndarray,
               t_len_host: np.ndarray, ts_t_len_host: np.ndarray) -> np.ndarray:
        """Final rounded ratios int32[N] of N (query row, truth row) pairs:
        the plain ratio where it is over the threshold, else the token-sort
        ratio.  The pairs go in buckets of the longest of both strings in
        both forms, as the reference's host stage scores them."""
        thr = self.cfg.levenshtein_ratio_threshold
        L = q_enc.shape[1]
        pair_len = np.maximum.reduce([q_len[pair_q], t_len_host[pair_t],
                                      ts_q_len[pair_q], ts_t_len_host[pair_t]])
        buckets = [b for b in self.cfg.length_buckets if b < L] + [L]
        bi = np.searchsorted(np.asarray(buckets), pair_len)

        def put(x, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device=self.device, dtype=dtype)

        qe, ql = put(q_enc), put(q_len, torch.int64)
        qts, qtsl = put(ts_q_enc), put(ts_q_len, torch.int64)
        out = np.zeros(len(pair_q), dtype=np.int32)
        for i, tl in enumerate(buckets):
            sel = np.flatnonzero(bi == i)
            if len(sel) == 0:
                continue
            pq, pt = put(pair_q[sel], torch.int64), put(pair_t[sel], torch.int64)
            r1 = _ratios(qe[pq], ql[pq], self.t_enc[pt], self.t_len[pt], tl)
            r2 = _ratios(qts[pq], qtsl[pq], self.t_ts[pt], self.t_ts_len[pt], tl)
            ratio = torch.where(r1 > thr, r1, r2)
            with timing.span("doppel.ratios.wait"):
                out[sel] = ratio.cpu().numpy()
        return out
