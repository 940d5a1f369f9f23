"""Plain retrieval reference: the IDF trigram index built from the truth
titles, and each query's top-k truth titles by the configuration's own
algorithm, in float64 arithmetic on weights held in the precision the
configuration states.

- The index: df over each title's distinct trigrams, IDF ln(N/df) as
  float32, a title's IDF sum as float32 (added in float64), and for the
  union bound each trigram's IDF or, unseen in truth, the largest IDF.
- Jaccard of query q and title t: num / (sum_t + maxint_q - num), num the
  weights of the trigrams they share, maxint_q the bound summed over q.
- Window select: titles in tiles of ``tb``; window s of a tile holds the
  16 offsets o whose tile-local title is 8·((o·S+s) mod tb/8) + (o·S+s)
  div tb/8 (S = tb/16 windows); a window keeps its best title (the first
  offset to reach its max) and the top-k windows by score are taken, ties
  to the lower window.
- Exact engine (below ``folded_min_titles``): the Jaccard with the IDF
  weights rounded to the coarse precision, window select, top-k.
- Folded engine (from ``folded_min_titles``): every trigram mapped into
  ``fold_dim`` df-balanced buckets by each of ``fold_hashes`` maps; a
  query's bucket weight is the float32 sum of its trigrams' IDFs there,
  rounded to the coarse precision; the coarse numerator is the least over
  the maps of the weights of the buckets the title occupies; window select
  takes the top ``rescore_depth`` windows, whose titles are scored again
  exactly (IDF weights in the rescore precision) and the top k kept, ties
  to the earlier coarse rank.

Nothing here reads the program's index, tables or weights.
"""

from __future__ import annotations

import heapq
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import text as T

# titles scored per matmul chunk (a multiple of every tile)
_CHUNK = 1 << 15


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """float32 values as held in ``precision``, returned as float64."""
    x = x.to(torch.float32)
    if precision == "float32":
        return x.to(torch.float64)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float64)
    if precision == "float8_e4m3":
        return x.to(torch.float8_e4m3fn).to(torch.float64)
    raise ValueError(f"unknown precision {precision!r}")


def fold_map(df: np.ndarray, fold_dim: int, seed: int) -> np.ndarray:
    """int64[VOCAB] trigram -> bucket: observed trigrams in descending df
    order (seed 0), or by df times a uniform(0.5, 2) jitter drawn from
    numpy's generator of ``seed``, each to the least-loaded bucket (load =
    summed df; ties to the lower bucket); unobserved trigrams round-robin in
    that order."""
    V = T.VOCAB
    if seed == 0:
        key = -df.astype(np.float64)
    else:
        key = -(df.astype(np.float64) * np.random.default_rng(seed).uniform(0.5, 2.0, V))
    order = np.argsort(key, kind="stable")
    seen = df[order] > 0
    out = np.empty(V, dtype=np.int64)
    heap = [(0, c) for c in range(fold_dim)]
    for g in order[seen]:
        load, c = heapq.heappop(heap)
        out[g] = c
        heapq.heappush(heap, (load + int(df[g]), c))
    rest = order[~seen]
    out[rest] = np.arange(len(rest)) % fold_dim
    return out


class ReferenceIndex:
    """The reference's index over transformed truth titles, and its top-k."""

    def __init__(self, truth: Sequence[str], settings: Dict, device: str = "cpu"):
        self.s = settings
        self.dev = torch.device(device)
        self.tri = T.trigram_lists(truth)                      # (nt, Wt), -1 pad
        nt = self.nt = len(truth)
        valid = self.tri >= 0
        self.df = np.bincount(self.tri[valid], minlength=T.VOCAB)
        idf = np.zeros(T.VOCAB, dtype=np.float32)
        seen = self.df > 0
        idf[seen] = np.log(nt / self.df[seen].astype(np.float64)).astype(np.float32)
        self.idf = idf
        self.fb = np.where(seen, idf, idf.max(initial=0.0)).astype(np.float32)
        w = np.where(valid, idf[np.maximum(self.tri, 0)].astype(np.float64), 0.0)
        self.sums = w.sum(axis=1).astype(np.float32)
        blk = int(settings["title_block"])
        self.ntp = -(-max(nt, blk) // blk) * blk
        self.tb = 2048 if self.ntp % 2048 == 0 else blk
        mode = settings["retrieval_mode"]
        self.folded = mode == "folded" or (mode == "auto" and nt >= int(settings["folded_min_titles"]))
        W = int(settings["fold_select_window"]) if self.folded else 0
        self.W = W or max(self.tb // 128, 1)
        self._tri_d = torch.from_numpy(self.tri).to(self.dev)
        self._sums_d = torch.from_numpy(self.sums.astype(np.float64)).to(self.dev)
        if self.folded:
            C = self.C = int(settings["fold_dim"])
            self.maps = [fold_map(self.df, C, f) for f in range(max(1, int(settings["fold_hashes"])))]

    # ------------------------------------------------------------ weights

    def _query_tables(self, q_tri: np.ndarray):
        """(ids int64 (S, LQ) -1 pad, idf float32 (S, LQ) 0 at pad and for
        trigrams unseen in truth, maxint float64 (S,))."""
        valid = q_tri >= 0
        g = np.maximum(q_tri, 0)
        w = np.where(valid, self.idf[g], 0.0).astype(np.float32)
        maxint = np.where(valid, self.fb[g].astype(np.float64), 0.0).sum(axis=1)
        return q_tri, w, maxint

    def _window_titles(self) -> torch.Tensor:
        nb = self.tb // 8
        S = self.tb // self.W
        c = torch.arange(self.W)[:, None] * S + torch.arange(S)[None, :]
        return (8 * (c % nb) + c // nb).to(self.dev)              # (W, S)

    def _windows(self, score_chunks) -> Tuple[torch.Tensor, torch.Tensor]:
        """Window maxima and their titles over every chunk of scores."""
        local = self._window_titles()
        S = local.shape[1]
        wmax, wtitle = [], []
        for t0, jacc in score_chunks:
            n_tiles = jacc.shape[1] // self.tb
            jw = jacc.reshape(jacc.shape[0], n_tiles, self.tb)[:, :, local]   # (Q, tiles, W, S)
            m = jw.max(dim=2).values
            first = (jw == m[:, :, None, :]).to(torch.int32).argmax(dim=2)
            tile0 = t0 + self.tb * torch.arange(n_tiles, device=self.dev)
            title = tile0[None, :, None] + local.reshape(-1)[first * S + torch.arange(S, device=self.dev)]
            wmax.append(m.reshape(jacc.shape[0], -1))
            wtitle.append(title.reshape(jacc.shape[0], -1))
        return torch.cat(wmax, dim=1), torch.cat(wtitle, dim=1)

    def _jaccard(self, num: torch.Tensor, maxint: torch.Tensor, t0: int) -> torch.Tensor:
        n = num.shape[1]
        t = torch.arange(t0, t0 + n, device=self.dev)
        sums = torch.zeros(n, dtype=torch.float64, device=self.dev)
        real = t < self.nt
        sums[real] = self._sums_d[t[real]]
        jacc = num / torch.clamp(sums[None, :] + maxint[:, None] - num, min=1e-9)
        return torch.where(real[None, :], jacc, torch.full_like(jacc, -1.0))

    def _occupancy(self, cols: torch.Tensor, n_cols: int, t0: int, t1: int) -> torch.Tensor:
        """float64 (n_cols, t1 - t0): 1 where a title of [t0, t1) holds a
        trigram mapped to that column (cols: int64[VOCAB], -1 unmapped)."""
        out = torch.zeros((n_cols, t1 - t0), dtype=torch.float64, device=self.dev)
        hi = min(t1, self.nt)
        if hi <= t0:
            return out
        tri = self._tri_d[t0:hi]
        c = torch.where(tri >= 0, cols[tri.clamp(min=0)], torch.full_like(tri, -1))
        t = torch.arange(hi - t0, device=self.dev)[:, None].expand_as(c)
        keep = c >= 0
        out[c[keep], t[keep]] = 1.0
        return out

    # -------------------------------------------------------------- top-k

    def topk(self, q_tri: np.ndarray, k: int, coarse: str = "bfloat16",
             rescore: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
        """(scores float64 (S, k), title rows int64 (S, k)) of queries given
        by their trigram lists (S, LQ), -1 pad; ``coarse`` and ``rescore``
        are the precisions the weights are held in."""
        ids, w, maxint = self._query_tables(q_tri)
        maxint_d = torch.from_numpy(maxint).to(self.dev)
        if not self.folded:
            vals, titles = self._exact_windows(ids, w, maxint_d, coarse, k)
            return vals.cpu().numpy(), titles.cpu().numpy()
        kprime = max(int(self.s["rescore_depth"]), k)
        _, cand = self._folded_windows(ids, w, maxint_d, coarse, kprime)
        scores = self._exact_scores(ids, w, maxint_d, cand, rescore)
        vals, order = torch.sort(scores, dim=1, descending=True, stable=True)
        return vals[:, :k].cpu().numpy(), torch.gather(cand, 1, order[:, :k]).cpu().numpy()

    def final_scores(self, q_tri: np.ndarray, titles: np.ndarray, coarse: str = "bfloat16",
                     rescore: str = "float32") -> np.ndarray:
        """float64 (S, K) the score each query's top-k reports for the title
        rows ``titles`` (S, K): the Jaccard with coarse weights (exact
        engine) or the exact rescore (folded engine)."""
        ids, w, maxint = self._query_tables(q_tri)
        maxint_d = torch.from_numpy(maxint).to(self.dev)
        cand = torch.from_numpy(np.asarray(titles, dtype=np.int64)).to(self.dev)
        prec = rescore if self.folded else coarse
        return self._exact_scores(ids, w, maxint_d, cand, prec).cpu().numpy()

    def _exact_scores(self, ids, w, maxint_d, cand: torch.Tensor, precision: str) -> torch.Tensor:
        ids_d = torch.from_numpy(ids).to(self.dev)
        w_d = round_to(torch.from_numpy(w).to(self.dev), precision)
        safe = cand.clamp(0, self.nt - 1)
        held = self._tri_d[safe]                                  # (S, K, Wt)
        num = torch.zeros(cand.shape, dtype=torch.float64, device=self.dev)
        for l in range(ids_d.shape[1]):
            g = ids_d[:, l]
            hit = (held == g[:, None, None]).any(dim=2) & (g >= 0)[:, None]
            num = num + w_d[:, l, None] * hit
        sums = self._sums_d[safe]
        jacc = num / torch.clamp(sums + maxint_d[:, None] - num, min=1e-9)
        return torch.where((cand >= 0) & (cand < self.nt), jacc, torch.full_like(jacc, -1.0))

    def _exact_windows(self, ids, w, maxint_d, precision: str, k: int):
        union = np.unique(ids[(ids >= 0) & (w > 0)])
        cols = torch.full((T.VOCAB,), -1, dtype=torch.int64, device=self.dev)
        cols[torch.from_numpy(union).to(self.dev)] = torch.arange(len(union), device=self.dev)
        S = ids.shape[0]
        wq = torch.zeros((S, len(union) + 1), dtype=torch.float64, device=self.dev)
        ids_d = torch.from_numpy(ids).to(self.dev)
        pos = torch.where(ids_d >= 0, cols[ids_d.clamp(min=0)], torch.full_like(ids_d, -1))
        pos = torch.where(pos >= 0, pos, torch.full_like(pos, len(union)))
        wq.scatter_(1, pos, round_to(torch.from_numpy(w).to(self.dev), precision))
        wq = wq[:, : len(union)]

        def chunks():
            for t0 in range(0, self.ntp, _CHUNK):
                t1 = min(t0 + _CHUNK, self.ntp)
                num = wq @ self._occupancy(cols, len(union), t0, t1)
                yield t0, self._jaccard(num, maxint_d, t0)

        wmax, wtitle = self._windows(chunks())
        vals, order = torch.sort(wmax, dim=1, descending=True, stable=True)
        return vals[:, :k], torch.gather(wtitle, 1, order[:, :k])

    def _folded_windows(self, ids, w, maxint_d, precision: str, k: int):
        S = ids.shape[0]
        C = self.C
        parts = []
        for m in self.maps:
            acc = np.zeros((S, C), dtype=np.float32)
            rows, cols = np.nonzero(ids >= 0)
            np.add.at(acc, (rows, m[ids[rows, cols]]), w[rows, cols])     # float32, in order
            parts.append(round_to(torch.from_numpy(acc).to(self.dev), precision))
        maps_d = [torch.from_numpy(m).to(self.dev) for m in self.maps]

        def chunks():
            for t0 in range(0, self.ntp, _CHUNK):
                t1 = min(t0 + _CHUNK, self.ntp)
                num = None
                for wf, md in zip(parts, maps_d):
                    part = wf @ self._occupancy(md, C, t0, t1)
                    num = part if num is None else torch.minimum(num, part)
                yield t0, self._jaccard(num, maxint_d, t0)

        wmax, wtitle = self._windows(chunks())
        vals, order = torch.sort(wmax, dim=1, descending=True, stable=True)
        return vals[:, :k], torch.gather(wtitle, 1, order[:, :k])

