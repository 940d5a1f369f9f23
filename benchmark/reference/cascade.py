"""Plain reference of the cascade after retrieval: the fuzzy decision, the
66 features of a (query, candidate) pair, the forest's probability and the
model decision, from the matcher's published semantics.

- Fuzzy: a candidate is considered when (|q|+|t| - ||q|-|t||) / (|q|+|t|)
  · 100 >= threshold (float32 arithmetic, as stated); its ratio is
  round-half-even(200·LCS / (|q|+|t|)), or that of the token-sorted forms
  where the plain one is not over the threshold.  The unique largest ratio
  over the threshold matches (the first column holding it); a tie drops to
  the model.
- Features (float32): [|q|, |t|, words of q, words of t, floor ratio(q,
  t), floor ratio(reconstruction, t)], then for the first 15 words of t: the best
  floor ratio of the word against every window of q without spaces (the
  first window that reaches it), the word's length, its IDF ln(N/df) over
  the truth titles, and 1 + (max IDF - IDF) / words of t; missing words are
  NaN.  The reconstruction joins, by single spaces, each word's best window
  (or a space where no window scores above 0).
- Forest: each tree walked from its root (NaN goes the stored missing way,
  else left when the value is at most the threshold) to a leaf; margin =
  logit(base score) + the leaves' values; probability = sigmoid.
- Model decision: in a batch of at least ``DEVICE_CASCADE_MIN_ROWS`` rows
  past the exact stage, wave A scores the first ``model_depth_initial``
  candidates; rows whose wave-A max lies in [widen, trust), or is tied at or
  above trust, also score the rest, and the larger max wins (ties keep A,
  and count both waves' ties); otherwise every candidate is scored at once.
  A unique max over the probability threshold matches.  A single title takes
  the first max whatever its value.

LCS is a plain dynamic programme: one row per character of the first
string, each row a running maximum over the second.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import text as T

DEVICE_CASCADE_MIN_ROWS = 2048
N_WORDS = 15
STAGE_NONE, STAGE_EXACT, STAGE_FUZZY, STAGE_MODEL = 0, 1, 2, 3
# pairs per LCS call
_PAIRS = 1 << 15


def lcs(a: torch.Tensor, la: torch.Tensor, b: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """LCS lengths (P,) of code rows a (P, La), b (P, Lb) (0 = padding)
    cut to lengths la, lb."""
    P, La = a.shape
    Lb = b.shape[1]
    dev = a.device
    b_live = (torch.arange(Lb, device=dev)[None, :] < lb[:, None]) & (b > 0)
    prev = torch.zeros((P, Lb + 1), dtype=torch.int32, device=dev)
    zero = torch.zeros((P, 1), dtype=torch.int32, device=dev)
    for i in range(La):
        eq = ((a[:, i, None] == b) & b_live).to(torch.int32)
        c = torch.maximum(prev[:, 1:], prev[:, :-1] + eq)
        new = torch.cat([zero, torch.cummax(c, dim=1).values], dim=1)
        prev = torch.where((i < la)[:, None], new, prev)
    return prev.gather(1, lb[:, None].clamp(max=Lb)).squeeze(1)


def lcs_strings(xs: Sequence[str], ys: Sequence[str], device) -> np.ndarray:
    """LCS lengths of string pairs, in chunks of similar width."""
    n = len(xs)
    out = np.zeros(n, dtype=np.int64)
    if n == 0:
        return out
    width = np.maximum([len(x) for x in xs], [len(y) for y in ys])
    order = np.argsort(width, kind="stable")
    for s in range(0, n, _PAIRS):
        idx = order[s : s + _PAIRS]
        a, la = T.codes([xs[i] for i in idx])
        b, lb = T.codes([ys[i] for i in idx])
        got = lcs(torch.from_numpy(a).to(device), torch.from_numpy(la).to(device),
                  torch.from_numpy(b).to(device), torch.from_numpy(lb).to(device))
        out[idx] = got.cpu().numpy()
    return out


def _f32_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    return num.astype(np.float32) / den.astype(np.float32)


def window_best(words: Sequence[str], qwo: Sequence[str], device) -> Tuple[np.ndarray, np.ndarray]:
    """For word i against every window of qwo[i] (the window at p: the next
    len(word) characters, fewer at the end): the best floor ratio (0 when
    none scores above 0) and the first window start reaching it."""
    n = len(words)
    best = np.zeros(n, dtype=np.float64)
    start = np.zeros(n, dtype=np.int64)
    if n == 0:
        return best, start
    wc, wl = T.codes(words)
    qc, ql = T.codes(qwo)
    item = np.repeat(np.arange(n), ql)
    if len(item) == 0:
        return best, start
    p = np.arange(len(item)) - np.repeat(np.cumsum(ql) - ql, ql)
    win_len = np.minimum(wl[item], ql[item] - p)
    width = wc.shape[1]
    j = np.arange(width)[None, :]
    src = np.minimum(p[:, None] + j, qc.shape[1] - 1)
    ratio = np.zeros(len(item), dtype=np.float64)
    for s in range(0, len(item), _PAIRS * 8):
        sl = slice(s, s + _PAIRS * 8)
        it = item[sl]
        win = np.where(j < win_len[sl, None], qc[it[:, None], src[sl]], 0)
        got = lcs(torch.from_numpy(win).to(device), torch.from_numpy(win_len[sl]).to(device),
                  torch.from_numpy(wc[it]).to(device), torch.from_numpy(wl[it]).to(device))
        tot = np.maximum(wl[it] + win_len[sl], 1)
        ratio[sl] = np.floor(_f32_div(200 * got.cpu().numpy().astype(np.int64), tot))
    # first window of the largest ratio, per word
    order = np.lexsort((p, -ratio, item))
    first = np.ones(len(order), dtype=bool)
    first[1:] = item[order[1:]] != item[order[:-1]]
    top = order[first]
    best[item[top]] = np.maximum(ratio[top], 0.0)
    start[item[top]] = p[top]
    return best, start


class Cascade:
    """The reference's stages after retrieval over transformed truth titles."""

    def __init__(self, truth: Sequence[str], settings: Dict, model: Dict[str, np.ndarray],
                 device: str = "cpu"):
        self.truth = list(truth)
        self.s = settings
        self.dev = torch.device(device)
        self.counts: Counter = Counter()
        for t in self.truth:
            self.counts.update(set(t.split()))
        self.n_truth = len(self.truth)
        nt = int(model["best_ntree_limit"]) or model["feat"].shape[0]
        nt = min(nt, model["feat"].shape[0])
        self.tree = {k: np.asarray(model[k])[:nt] for k in
                     ("feat", "threshold", "missing_left", "value", "is_leaf")}
        self.depth = int(model["depth"])
        p = float(np.float32(model["base_score"]))
        self.base_margin = math.log(p / (1.0 - p))

    # -------------------------------------------------------------- fuzzy

    def fuzzy_rows(self, qs: Sequence[str], cands: Sequence[np.ndarray]) -> List[Tuple[bool, int]]:
        """Per row (matched, column of the match)."""
        thr = int(self.s["levenshtein_ratio_threshold"])
        pq, pc = [], []
        ratio = [np.zeros(len(c), dtype=np.int64) for c in cands]
        for r, (q, cand) in enumerate(zip(qs, cands)):
            tl = np.array([len(self.truth[t]) for t in cand], dtype=np.int64)
            tot = len(q) + tl
            delta = np.abs(len(q) - tl)
            share = _f32_div(tot - delta, np.maximum(tot, 1)) * np.float32(100.0)
            for j in np.flatnonzero(share >= thr):
                pq.append(r)
                pc.append(j)
        if pq:
            xs = [qs[r] for r in pq]
            ys = [self.truth[cands[r][j]] for r, j in zip(pq, pc)]
            r1 = self._rounded(xs, ys)
            low = np.flatnonzero(r1 <= thr)
            r2 = self._rounded([T.token_sorted(xs[i]) for i in low],
                               [T.token_sorted(ys[i]) for i in low])
            final = r1.copy()
            final[low] = r2
            for (r, j), v in zip(zip(pq, pc), final):
                ratio[r][j] = v
        out = []
        for rt in ratio:
            keep = np.where(rt > thr, rt, -1)
            mx = keep.max(initial=-1)
            at = np.flatnonzero(keep == mx)
            out.append((bool(mx > -1 and len(at) == 1), int(at[0]) if len(at) else 0))
        return out

    def _rounded(self, xs, ys) -> np.ndarray:
        got = lcs_strings(xs, ys, self.dev)
        tot = np.maximum(np.array([len(x) + len(y) for x, y in zip(xs, ys)], dtype=np.int64), 1)
        return np.round(_f32_div(200 * got, tot)).astype(np.int64)

    # ----------------------------------------------------------- features

    def features(self, qs: Sequence[str], ts: Sequence[int], precision: str = "float32") -> np.ndarray:
        """float32 (P, 66) features of pairs (query string, truth row)."""
        P = len(qs)
        nan = float("nan")
        out = np.full((P, 66), nan, dtype=np.float64)
        if P == 0:
            return out.astype(np.float32)
        tt = [self.truth[t] for t in ts]
        out[:, 0] = [len(q) for q in qs]
        out[:, 1] = [len(t) for t in tt]
        out[:, 2] = [q.count(" ") + 1 for q in qs]
        out[:, 3] = [t.count(" ") + 1 for t in tt]
        out[:, 4] = self._floor_ratio(qs, tt)
        items = [(i, k, w) for i, t in enumerate(tt) for k, w in enumerate(T.words(t)[:N_WORDS])]
        qwo = [q.replace(" ", "") for q in qs]
        best, start = window_best([w for _, _, w in items], [qwo[i] for i, _, _ in items], self.dev)
        parts: List[List[str]] = [[] for _ in range(P)]
        counts = np.ones(len(items), dtype=np.float32)
        for j, ((i, k, w), b, p) in enumerate(zip(items, best, start)):
            out[i, 6 + k] = b
            out[i, 21 + k] = len(w)
            counts[j] = max(self.counts[w], 1)
            parts[i].append(qwo[i][p : p + len(w)] if b > 0 else " ")
        out[:, 5] = self._floor_ratio([" ".join(p) for p in parts], tt)
        # the IDF and rank features in float32, as stated: ln(N / df) with
        # the device's float32 log, then 1 + (max - idf) / words
        n = torch.tensor(float(self.n_truth), dtype=torch.float32, device=self.dev)
        idf = np.full((P, N_WORDS), np.nan, dtype=np.float32)
        if items:
            logs = torch.log(n / torch.from_numpy(counts).to(self.dev)).cpu().numpy()
            rows = np.array([i for i, _, _ in items])
            cols = np.array([k for _, k, _ in items])
            idf[rows, cols] = logs
        with np.errstate(invalid="ignore"):
            idf_max = np.nanmax(np.where(np.isnan(idf), np.float32(-np.inf), idf), axis=1)
        ranks = np.float32(1.0) + (idf_max[:, None] - idf) / out[:, 3:4].astype(np.float32)
        x = torch.from_numpy(out.astype(np.float32))
        x[:, 36:51] = torch.from_numpy(idf)
        x[:, 51:66] = torch.from_numpy(ranks.astype(np.float32))
        if precision == "bfloat16":
            x = x.to(torch.bfloat16)
        return x.to(torch.float32).numpy()

    def _floor_ratio(self, xs, ys) -> np.ndarray:
        got = lcs_strings(xs, ys, self.dev)
        tot = np.array([len(x) + len(y) for x, y in zip(xs, ys)], dtype=np.int64)
        return np.floor(_f32_div(200 * got, np.maximum(tot, 1))).astype(np.float64)

    # ------------------------------------------------------------- forest

    def probability(self, X: np.ndarray) -> np.ndarray:
        """float64 (P,) forest probabilities of float32 features X (P, 66)."""
        P = X.shape[0]
        tr = self.tree
        rows = np.arange(P)
        margin = np.full(P, self.base_margin, dtype=np.float64)
        for t in range(tr["feat"].shape[0]):
            node = np.zeros(P, dtype=np.int64)
            for _ in range(self.depth):
                f = tr["feat"][t, node]
                live = ~tr["is_leaf"][t, node] & (f >= 0)
                x = X[rows, np.maximum(f, 0)]
                left = np.where(np.isnan(x), tr["missing_left"][t, node], x <= tr["threshold"][t, node])
                node = np.where(live, 2 * node + np.where(left, 1, 2), node)
            margin += tr["value"][t, node].astype(np.float64)
        return 1.0 / (1.0 + np.exp(-margin))

    def probabilities(self, qs: Sequence[str], ts: Sequence[int], precision: str = "float32") -> np.ndarray:
        p = self.probability(self.features(qs, ts, precision))
        if precision == "bfloat16":
            p = torch.from_numpy(p).to(torch.bfloat16).to(torch.float64).numpy()
        return p

    # ----------------------------------------------------------- decision

    def decide(self, qs: Sequence[str], cands: Sequence[np.ndarray], waves: Sequence[bool],
               single: Sequence[bool], precision: str = "float32") -> List[Tuple[int, int, float]]:
        """Per row past the exact stage: (truth row or -1, stage, probability
        or nan) from its candidates (truth rows, in the order retrieval
        ranked them)."""
        fz = self.fuzzy_rows(qs, cands)
        todo = [r for r, (m, _) in enumerate(fz) if not m]
        pairs_q, pairs_t, owner = [], [], []
        for r in todo:
            for t in cands[r]:
                pairs_q.append(qs[r])
                pairs_t.append(int(t))
                owner.append(r)
        probs = self.probabilities(pairs_q, pairs_t, precision)
        by_row: Dict[int, np.ndarray] = {}
        o = 0
        for r in todo:
            n = len(cands[r])
            by_row[r] = probs[o : o + n]
            o += n
        out = []
        for r, (m, col) in enumerate(fz):
            if m:
                out.append((int(cands[r][col]), STAGE_FUZZY, 1.0))
                continue
            j, p = self._model(by_row[r], waves[r], single[r])
            out.append((int(cands[r][j]), STAGE_MODEL, p) if j >= 0 else (-1, STAGE_NONE, float("nan")))
        return out

    def _model(self, p: np.ndarray, waves: bool, single: bool) -> Tuple[int, float]:
        """(column or -1, probability) of one row's model decision."""
        thr = float(self.s["prediction_probability_threshold"])
        if single:
            j = int(np.argmax(p))
            return j, float(p[j])
        k1 = int(self.s["model_depth_initial"])
        K = len(p)
        if not (waves and 0 < k1 < K):
            return self._unique(p, 0, thr)
        head = p[:k1]
        mx_a = head.max()
        cnt_a = int((head == mx_a).sum())
        widen = (float(self.s["model_widen_threshold"]) <= mx_a < float(self.s["model_trust_threshold"])) \
            or (mx_a >= float(self.s["model_trust_threshold"]) and cnt_a > 1)
        if not widen:
            j = int(np.argmax(head))
            return (j, float(mx_a)) if cnt_a == 1 and mx_a > thr else (-1, float("nan"))
        tail = p[k1:]
        mx_b = tail.max()
        cnt_b = int((tail == mx_b).sum())
        if mx_a > mx_b:
            j, mx, cnt = int(np.argmax(head)), mx_a, cnt_a
        elif mx_a == mx_b:
            j, mx, cnt = int(np.argmax(head)), mx_a, cnt_a + cnt_b
        else:
            j, mx, cnt = k1 + int(np.argmax(tail)), mx_b, cnt_b
        return (j, float(mx)) if cnt == 1 and mx > thr else (-1, float("nan"))

    @staticmethod
    def _unique(p: np.ndarray, lo: int, thr: float) -> Tuple[int, float]:
        mx = p.max()
        if int((p == mx).sum()) == 1 and mx > thr:
            return lo + int(np.argmax(p)), float(mx)
        return -1, float("nan")


def exact_rows(truth: Sequence[str]) -> Dict[str, int]:
    """Each distinct truth title's last row (the exact stage)."""
    return {t: i for i, t in enumerate(truth)}


def waves_for(batch: Sequence[str], exact: Dict[str, int], single: bool,
              cascade_impl: str = "auto") -> bool:
    """Whether a batch's model stage runs in waves: the device cascade at
    every size, or under auto from DEVICE_CASCADE_MIN_ROWS rows past the
    exact stage; never for a single title."""
    if single or cascade_impl == "host":
        return False
    past = sum(1 for q in batch if q not in exact)
    return cascade_impl == "device" or past >= DEVICE_CASCADE_MIN_ROWS

