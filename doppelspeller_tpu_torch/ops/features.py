"""The 66-dim (query, candidate) features.

The JAX package's ``ops/features.py``: the numpy host prep (word splitting,
word-character gathers, space removal) and ``features_kernel``, the torch
counterpart of ``_features_kernel``.  Layout:

    [0]      query #chars                    [1]  candidate #chars
    [2]      query #words                    [3]  candidate #words
    [4]      floor(ratio(query, candidate))
    [5]      floor(ratio(reconstructed, candidate))
    [6:21]   per-candidate-word best sliding-window ratio   (NaN-padded, 15)
    [21:36]  per-candidate-word length                      (NaN-padded)
    [36:51]  per-candidate-word IDF ln(N/count)             (NaN-padded)
    [51:66]  1 + (nanmax(idf) − idf) / candidate_#words

The sliding-window ratios go through kernel B (``ops/features_kernels.py``)
for words of at most 32 characters and through the plain window DP
(``window_best_dp``) for longer ones, as in the reference.  The two
whole-title ratios ([4], [5]) take ``levenshtein.lcs``: kernel F
(``csrc/lcs_pairs.cu``) on CUDA tensors, ``lcs_plain`` on CPU tensors.  The
reconstruction's one-hot matmuls of the TPU version are gathers here.

Two host entries build feature matrices over many pairs:
``features_for_pairs`` (the trainer's: the query and truth tables go to the
device once, then each chunk sends only its index pairs) and
``construct_features`` (pairs given as encodings).  Both bucket the pairs by
(title length, longest word) so a chunk's tensors are as narrow as its pairs
allow; the result does not depend on the chunk size.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from doppelspeller_tpu_torch.config import Config, SPACE_CODE
from doppelspeller_tpu_torch.device import resolve_device
from doppelspeller_tpu_torch.ops.features_kernels import WL_MAX, window_best
from doppelspeller_tpu_torch.ops.levenshtein import floor_ratio, lcs

FEATURES_COUNT = 66
NUM_WORD_SLOTS = 15
_BIG = 1 << 20


# ---------------------------------------------------------------- host prep

def split_words_host(enc: np.ndarray, lengths: np.ndarray, w_slots: int = NUM_WORD_SLOTS):
    """(word_start int32[B, W], word_len int32[B, W], n_words int32[B]);
    slots past the word count have length 0, ``n_words`` is uncapped."""
    B, L = enc.shape
    pos = np.arange(L + 1, dtype=np.int32)
    ext = np.zeros((B, L + 1), dtype=bool)
    ext[:, :L] = enc == SPACE_CODE
    ext[:, :L] &= pos[:L][None, :] < lengths[:, None]
    ext[np.arange(B), lengths] = True  # sentinel space at position len
    pos_or_big = np.where(ext, pos[None, :], _BIG)
    spos = np.sort(pos_or_big, axis=1)[:, :w_slots].astype(np.int32)
    valid = spos < _BIG
    start = np.concatenate([np.zeros((B, 1), np.int32), spos[:, :-1] + 1], axis=1)
    wlen = np.where(valid, spos - start, 0).astype(np.int32)
    start = np.where(valid, start, 0).astype(np.int32)
    n_words = (enc == SPACE_CODE)
    n_words = (n_words & (np.arange(L)[None, :] < lengths[:, None])).sum(axis=1) + 1
    return start, wlen, n_words.astype(np.int32)


def gather_word_chars(enc: np.ndarray, start: np.ndarray, wlen: np.ndarray, wl_max: int):
    """uint8[B, W, wl_max] word characters, zero-padded."""
    B, L = enc.shape
    j = np.arange(wl_max, dtype=np.int32)
    idx = np.clip(start[:, :, None] + j[None, None, :], 0, L - 1)
    chars = enc[np.arange(B)[:, None, None], idx]
    return (chars * (j[None, None, :] < wlen[:, :, None])).astype(np.uint8)


def remove_spaces_host(enc: np.ndarray, lengths: np.ndarray):
    """Stable compaction dropping spaces and padding: (uint8[B, L], int32[B])."""
    B, L = enc.shape
    pos = np.arange(L, dtype=np.int32)[None, :]
    keep = (enc != SPACE_CODE) & (pos < lengths[:, None])
    tgt = np.cumsum(keep, axis=1, dtype=np.int32) - 1
    out = np.zeros((B, L), np.uint8)
    np.put_along_axis(out, np.where(keep, tgt, L - 1), np.where(keep, enc, 0), axis=1)
    len_wo = tgt[:, -1] + 1
    return out, len_wo.astype(np.int32)


# ------------------------------------------------------------ device features

def window_best_dp(word_chars: torch.Tensor, word_len: torch.Tensor,
                   q_wo: torch.Tensor, q_wo_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain window DP for any word length (the reference's XLA scan path):
    LCS of every word against every window by a cummax row scan."""
    B, W, WL = word_chars.shape
    TL = q_wo.shape[1]
    dev = q_wo.device
    wlen = word_len.to(torch.int64)
    qwol = q_wo_len.to(torch.int64)
    p = torch.arange(TL, device=dev)
    j = torch.arange(WL, device=dev)
    pj = p[:, None] + j[None, :]                                          # (P, WL)
    wc = q_wo.to(torch.int64)[:, torch.clamp(pj, max=TL - 1)] * (pj[None] < qwol[:, None, None])
    win_len = torch.clamp(torch.minimum(wlen[:, :, None], qwol[:, None, None] - p[None, None, :]), min=0)
    win_valid = (p[None, None, :] < qwol[:, None, None]) & (wlen[:, :, None] > 0)
    j_in = j[None, None, None, :] < win_len[..., None]                    # (B, W, P, WL)
    dp = torch.zeros((B, W, TL, WL + 1), dtype=torch.int64, device=dev)
    for i in range(WL):
        ai = word_chars[:, :, i].to(torch.int64)
        valid_i = (i < wlen)[:, :, None, None]
        eq = (wc[:, None] == ai[:, :, None, None]) & (wc[:, None] > 0) & j_in & valid_i
        cand = torch.maximum(dp[..., 1:], dp[..., :-1] + eq.to(torch.int64))
        new = torch.cat([torch.zeros_like(dp[..., :1]), torch.cummax(cand, dim=3).values], dim=3)
        dp = torch.where(valid_i, new, dp)
    lcs_wp = dp[..., WL]
    total = (wlen[:, :, None] + win_len).to(torch.float32)
    ratio = torch.floor(200.0 * lcs_wp.to(torch.float32) / torch.clamp(total, min=1.0))
    ratio = torch.where(win_valid, ratio, torch.full_like(ratio, -1.0))
    best = ratio.max(dim=2).values
    best_p = (ratio == best[:, :, None]).to(torch.int32).argmax(dim=2)
    return best, best_p.to(torch.int32)


def _nanmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    nan = torch.isnan(x)
    m = torch.where(nan, torch.full_like(x, -float("inf")), x).max(dim=dim, keepdim=True).values
    return torch.where(nan.all(dim=dim, keepdim=True), torch.full_like(m, float("nan")), m)


def features_kernel(
    q_enc: torch.Tensor,       # uint8[B, TL]
    q_len: torch.Tensor,       # int32[B]
    t_enc: torch.Tensor,       # uint8[B, TL]
    t_len: torch.Tensor,       # int32[B]
    word_chars: torch.Tensor,  # uint8[B, W, WL]
    word_len: torch.Tensor,    # int32[B, W]
    n_words_t: torch.Tensor,   # int32[B] uncapped
    q_wo: torch.Tensor,        # uint8[B, TL] query without spaces
    q_wo_len: torch.Tensor,    # int32[B]
    word_counts: torch.Tensor, # float32[B, W] truth-DB word document counts
    n_truth: float,
) -> torch.Tensor:
    """float32[B, 66] features (see the module docstring)."""
    B, W, WL = word_chars.shape
    TL = q_wo.shape[1]
    dev = q_enc.device
    valid_word = word_len > 0

    pos_t = torch.arange(q_enc.shape[1], device=dev)[None, :]
    n_words_q = (((q_enc == SPACE_CODE) & (pos_t < q_len[:, None])).sum(dim=1) + 1).to(torch.float32)
    lev = floor_ratio(lcs(q_enc, q_len, t_enc, t_len), q_len.to(torch.int64) + t_len)

    if WL <= WL_MAX:
        best_ratio, best_p = window_best(word_chars, word_len, q_wo, q_wo_len)
    else:
        best_ratio, best_p = window_best_dp(word_chars, word_len, q_wo, q_wo_len)
    best_ratio = torch.clamp(best_ratio, min=0.0)

    # ---- reconstructed title ----
    matched = best_ratio > 0.0
    wl64 = word_len.to(torch.int64)
    best_p64 = best_p.to(torch.int64)
    best_win_len = torch.clamp(torch.minimum(wl64, q_wo_len.to(torch.int64)[:, None] - best_p64), min=0)
    rec_len = torch.where(matched, best_win_len, torch.ones_like(best_win_len)) * valid_word
    seg = rec_len + valid_word.to(torch.int64)                      # + joiner space
    offsets = torch.cumsum(seg, dim=1) - seg                        # exclusive
    recon_len = torch.clamp(seg.sum(dim=1) - 1, min=0)
    t_pos = torch.arange(TL, device=dev)[None, :]
    # output position t belongs to the last word whose segment starts at or
    # before t (segment starts are non-decreasing, so that is a count)
    w_of_t = (offsets[:, :, None] <= t_pos[:, None, :]).sum(dim=1) - 1   # (B, TL)
    m_t = torch.gather(matched, 1, w_of_t)
    rl_t = torch.gather(rec_len, 1, w_of_t)
    j_t = t_pos - torch.gather(offsets, 1, w_of_t)
    src = torch.clamp(torch.gather(best_p64, 1, w_of_t) + j_t, 0, TL - 1)
    ch = torch.gather(q_wo, 1, src)
    ch = torch.where(m_t & (j_t < rl_t), ch, torch.full_like(ch, SPACE_CODE))
    recon = torch.where(t_pos < recon_len[:, None], ch, torch.zeros_like(ch))
    recon_ratio = floor_ratio(lcs(recon, recon_len, t_enc, t_len), recon_len + t_len.to(torch.int64))

    # ---- word IDF features ----
    nan = torch.full((B, W), float("nan"), device=dev)
    n_t = torch.full((), n_truth, dtype=torch.float32, device=dev)
    idf = torch.where(valid_word, torch.log(n_t / torch.clamp(word_counts, min=1.0)), nan)
    idf_max = _nanmax(idf, dim=1)
    ranks = 1.0 + (idf_max - idf) / n_words_t[:, None].to(torch.float32)
    best_ratios_f = torch.where(valid_word, best_ratio, nan)
    word_len_f = torch.where(valid_word, word_len.to(torch.float32), nan)

    basic = torch.stack([
        q_len.to(torch.float32), t_len.to(torch.float32), n_words_q,
        n_words_t.to(torch.float32), lev, recon_ratio,
    ], dim=1)
    return torch.cat([basic, best_ratios_f, word_len_f, idf, ranks], dim=1)


# ------------------------------------------------- resident pair features

def pair_features(
    q_enc, q_len, q_wo, q_wo_len,                                 # (U, L) resident query side
    t_enc, t_len, t_wchars, t_start, t_wlen, t_nwords, t_counts,  # resident truth side
    pair_q: torch.Tensor, pair_t: torch.Tensor,                   # int64[B] rows of each side
    n_truth: float, *, tl: int, wl: int,
) -> torch.Tensor:
    """float32[B, 66] features of B (query row, truth row) index pairs, both
    sides gathered on the device from the resident tables and cut to the
    ``tl`` × ``wl`` tile."""
    from doppelspeller_tpu_torch.ops.rerank import word_chars

    chars = word_chars(t_wchars, t_start, t_wlen, t_enc, pair_t, wl)
    return features_kernel(
        q_enc[pair_q, :tl], q_len[pair_q],
        t_enc[pair_t, :tl], torch.clamp(t_len[pair_t], min=1),
        chars.contiguous(), t_wlen[pair_t], torch.clamp(t_nwords[pair_t], min=1),
        q_wo[pair_q, :tl], torch.clamp(q_wo_len[pair_q], min=1),
        t_counts[pair_t], n_truth,
    )


def _pair_chunk(tl: int, wl: int) -> int:
    """Pairs per device call: bounded by the widest temporaries, the plain
    window DP's (pairs, 15, tl, wl + 1) int64 state for words past kernel
    B's 32 characters, else the (pairs, tl)-shaped LCS and gather tensors."""
    if wl > WL_MAX:
        return int(np.clip((1 << 28) // (NUM_WORD_SLOTS * tl * (wl + 1) * 8), 64, 4096))
    return int(np.clip((1 << 22) // tl, 1024, 1 << 16))


def features_for_pairs(
    pair_q: np.ndarray,        # int[M] indices into the unique query rows
    pair_t: np.ndarray,        # int[M] truth row positions
    q_enc: np.ndarray,         # uint8[U, L] unique query encodings
    q_len: np.ndarray,         # int32[U]
    truth_enc: np.ndarray,     # uint8[T, L]
    truth_len: np.ndarray,     # int32[T]
    counts_matrix: np.ndarray, # uint32[T, W] truth-DB word document counts
    config: Config,
    device="cuda",
    chunk: Optional[int] = None,
) -> np.ndarray:
    """float32[M, 66] features of (query row, truth row) pairs.  The query
    and truth tables go to ``device`` once; per chunk only the index pairs
    go up and one (chunk, 66) matrix comes back.  ``chunk`` overrides the
    pairs per device call."""
    cfg = config
    dev = resolve_device(device)
    n = len(pair_q)
    out = np.zeros((n, FEATURES_COUNT), dtype=np.float32)
    if n == 0:
        return out
    pair_q = np.asarray(pair_q, dtype=np.int64)
    pair_t = np.asarray(pair_t, dtype=np.int64)

    q_wo, q_wo_len = remove_spaces_host(q_enc, q_len)
    start, wlen, nwords = split_words_host(truth_enc, truth_len)
    wchars = gather_word_chars(truth_enc, start, wlen, WL_MAX)
    wlen_max = wlen.max(axis=1)

    def put(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev, dtype=dtype)

    tables = (
        put(q_enc), put(q_len, torch.int32), put(q_wo), put(q_wo_len, torch.int32),
        put(truth_enc), put(truth_len, torch.int32), put(wchars), put(start, torch.int64),
        put(wlen, torch.int32), put(nwords, torch.int32), put(counts_matrix.astype(np.float32)),
    )
    n_truth = float(truth_enc.shape[0])

    L = q_enc.shape[1]
    pair_len = np.maximum(q_len[pair_q], truth_len[pair_t])
    buckets = [b for b in cfg.length_buckets if b < L] + [L]
    w_buckets = [b for b in (8, 16, 32, 64) if b < L] + [L]
    tb_idx = np.searchsorted(np.asarray(buckets), np.minimum(pair_len, L))
    wb_idx = np.searchsorted(np.asarray(w_buckets), np.maximum(wlen_max[pair_t], 1))
    # a word is a substring of its title, so its bucket is no wider than the
    # title's on these grids; clamp anyway, the loop visits only WL <= TL
    ti_min_for_w = np.searchsorted(np.asarray(buckets), np.asarray(w_buckets))
    tb_idx = np.maximum(tb_idx, ti_min_for_w[wb_idx])

    n_dispatched = 0
    pending = []
    for ti, TL in enumerate(buckets):
        for wi, WL in enumerate(w_buckets):
            if WL > TL:
                continue
            sel = np.flatnonzero((tb_idx == ti) & (wb_idx == wi))
            step = chunk or _pair_chunk(TL, WL)
            for s in range(0, len(sel), step):
                idx = sel[s : s + step]
                feats = pair_features(*tables, put(pair_q[idx]), put(pair_t[idx]), n_truth,
                                      tl=TL, wl=WL)
                pending.append((idx, feats))
                n_dispatched += len(idx)
    assert n_dispatched == n, f"pair dispatch hole: {n_dispatched} != {n}"
    for idx, feats in pending:
        out[idx] = feats.cpu().numpy()
    return out


def construct_features(
    q_enc: np.ndarray,
    q_len: np.ndarray,
    t_enc: np.ndarray,
    t_len: np.ndarray,
    word_counts: np.ndarray,
    n_truth: int,
    config: Config,
    device="cuda",
    chunk: Optional[int] = None,
) -> np.ndarray:
    """float32[N, 66] features of N (query, candidate) pairs given as
    encodings.  ``word_counts`` is uint32[N, 15]: truth-DB document counts of
    the candidate's first 15 words."""
    cfg = config
    dev = resolve_device(device)
    n = len(q_len)
    q_len = np.asarray(q_len, dtype=np.int32)
    t_len = np.asarray(t_len, dtype=np.int32)
    out = np.zeros((n, FEATURES_COUNT), dtype=np.float32)

    start, wlen, n_words_t = split_words_host(t_enc, t_len)
    q_wo, q_wo_len = remove_spaces_host(q_enc, q_len)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    L = q_enc.shape[1]
    buckets = [b for b in cfg.length_buckets if b < L] + [L]
    w_buckets = [8, 16, 32, 64, L]
    tb_idx = np.searchsorted(np.asarray(buckets), np.maximum(q_len, t_len))
    wb_idx = np.searchsorted(np.asarray(w_buckets), np.maximum(wlen.max(axis=1), 1))

    pending = []
    for ti, TL in enumerate(buckets):
        for wi, WL in enumerate(w_buckets):
            if WL > TL:
                continue
            sel = np.flatnonzero((tb_idx == ti) & (wb_idx == wi))
            step = chunk or _pair_chunk(TL, WL)
            for s in range(0, len(sel), step):
                idx = sel[s : s + step]
                feats = features_kernel(
                    put(q_enc[idx, :TL]), put(q_len[idx]),
                    put(t_enc[idx, :TL]), put(np.maximum(t_len[idx], 1)),
                    put(gather_word_chars(t_enc[idx], start[idx], wlen[idx], WL)),
                    put(wlen[idx]), put(np.maximum(n_words_t[idx], 1)),
                    put(q_wo[idx, :TL]), put(np.maximum(q_wo_len[idx], 1)),
                    put(word_counts[idx].astype(np.float32)), float(n_truth),
                )
                pending.append((idx, feats))
    for idx, feats in pending:
        out[idx] = feats.cpu().numpy()
    return out
