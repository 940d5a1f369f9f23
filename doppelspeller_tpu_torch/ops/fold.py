"""Two-stage folded retrieval: coarse upper-bound scoring + exact rescore.

The JAX package's ``ops/fold.py`` in PyTorch.  The 37³ trigram vocabulary is
folded into ``C`` df-balanced buckets per hash; the folded occupancy matrices
``Mc[folds·C, ntp/8]`` stay resident on the device, and the coarse score (the
min over hashes of each hash's upper bound of the IDF intersection) runs in
kernel A (``ops/jaccard_kernels.py``).  The coarse top-``rescore_depth``
candidates of every query are then rescored exactly against the per-title
trigram lists ``TL[ntp, Ltw]``, and their top-k kept: on a card in kernel G
(``select_rescore``, ``csrc/fold_rescore.cu``, one launch a block), on the
CPU in its plain version (``select_rescore_plain``).
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from doppelspeller_tpu_torch import _build
from doppelspeller_tpu_torch.config import TRIGRAM_VOCAB_SIZE, Config
from doppelspeller_tpu_torch.device import resolve_device
from doppelspeller_tpu_torch.ops.index_device import build_shard, ids_width
from doppelspeller_tpu_torch.ops.jaccard_kernels import (check_launch, score_window_select,
                                                         select_topk_windowed)
from doppelspeller_tpu_torch.ops.tiles import query_block, trigram_block
from doppelspeller_tpu_torch.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)

V = TRIGRAM_VOCAB_SIZE


def build_fold_map(df: np.ndarray, fold_dim: int, seed: int = 0) -> np.ndarray:
    """int32[V+1] trigram id → bucket in [0, fold_dim); slot V (the invalid
    sentinel) → fold_dim.

    Greedy df-balancing: observed trigrams in descending-df order each go to
    the least-loaded bucket.  ``seed`` > 0 jitters the order (multiplicative
    df noise) for an independent partition with the same balance; unobserved
    ids are round-robined."""
    fold = np.empty(V + 1, dtype=np.int32)
    fold[V] = fold_dim
    if seed == 0:
        key = -df.astype(np.float64)
    else:
        r = np.random.default_rng(seed)
        key = -(df.astype(np.float64) * r.uniform(0.5, 2.0, V))
    order = np.argsort(key, kind="stable")
    heap = [(0, c) for c in range(fold_dim)]  # already a valid heap
    observed = int((df > 0).sum())
    obs_mask = df > 0
    obs_in_order = order[obs_mask[order]]
    rest = order[~obs_mask[order]]
    if len(obs_in_order) != observed:
        raise AssertionError("observed trigram count mismatch")
    for g in obs_in_order:
        load, c = heapq.heappop(heap)
        fold[g] = c
        heapq.heappush(heap, (load + int(df[g]), c))
    if observed < V:
        fold[rest] = np.arange(len(rest), dtype=np.int64) % fold_dim
    return fold


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_folded_matrix(ids: torch.Tensor, fold_map: np.ndarray, fold_dim: int,
                        ntp: int) -> torch.Tensor:
    """uint8[fold_dim, ntp/8] folded occupancy bits on the device of
    ``ids`` (int32[nt, W] per-title trigram ids, V in unused slots; see
    ``index_device.title_trigram_ids``): bit t % 8 of byte t // 8 in row c
    is set when title t holds a trigram of bucket c."""
    C = fold_dim
    device = ids.device
    fold = torch.from_numpy(fold_map.astype(np.int64)).to(device)
    f = fold[ids.long()]                                     # (nt, S), C = pad
    t = torch.arange(ids.shape[0], device=device)[:, None].expand_as(f)
    keep = f < C
    # one bit per (bucket, title): two trigrams of a title folding into one
    # bucket must not carry into the neighbouring bit
    key = torch.unique(f[keep] * ntp + t[keep])
    c, tt = key // ntp, key % ntp
    packed = torch.zeros(C * (ntp // 8), dtype=torch.int32, device=device)
    packed.index_add_(0, c * (ntp // 8) + tt // 8,
                      torch.bitwise_left_shift(torch.ones_like(tt), tt % 8).to(torch.int32))
    return packed.to(torch.uint8).reshape(C, ntp // 8)


def build_trigram_list_matrix(ids: torch.Tensor, ntp: int,
                              ltw: Optional[int] = None) -> Tuple[torch.Tensor, int]:
    """(int32[ntp, Ltw] on the device of ``ids``, Ltw): each title's row of
    ``ids`` (``index_device.title_trigram_ids``: sorted, each repeat
    replaced by V in place, the reference's layout; membership is all the
    rescore reads), V in the slots past it and in padding titles.  ``ltw``
    forces the width (a mesh's shards take the width of all the titles);
    by default it is that of ``ids`` rounded up to a multiple of 8."""
    nt, width = ids.shape
    if ltw is None:
        ltw = max(_round_up(width, 8), 8)
    out = torch.full((ntp, ltw), V, dtype=torch.int32, device=ids.device)
    out[:nt, :width] = ids
    return out, ltw


@dataclass
class IdBlockPlan:
    """One folded-retrieval block: ≤ query_block queries' trigram ids."""

    query_rows: np.ndarray    # int64[n_valid] row numbers into the query set
    ids: np.ndarray           # int32[query_block, LQ] trigram ids, V invalid
    n_valid: int


def plan_id_blocks(queries: TitleSet, config: Config,
                   rows: Optional[np.ndarray] = None) -> List[IdBlockPlan]:
    """Chunk queries into fixed-width id blocks of the engine's query block
    and LQ (``ops/tiles.py``)."""
    cfg = config
    if rows is None:
        rows = np.arange(len(queries), dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return []
    qb = query_block(cfg, folded=True)
    ids_all, lq = trigram_block(queries.trigram_ids()[rows], cfg)
    ids_all = np.minimum(ids_all[:, :lq], np.int32(V))
    plans: List[IdBlockPlan] = []
    for s in range(0, len(rows), qb):
        sel = slice(s, min(s + qb, len(rows)))
        m = sel.stop - sel.start
        blk = np.full((qb, lq), V, dtype=np.int32)
        blk[:m] = ids_all[sel]
        plans.append(IdBlockPlan(query_rows=rows[sel], ids=blk, n_valid=m))
    return plans


def coarse_weights(ids: torch.Tensor, idf_ext: torch.Tensor, fold_ext: torch.Tensor,
                   C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wfold f32 (QB, folds·C), w_val f32 (QB, LQ)).

    ``wfold[q, f·C + c]`` is the sum of the IDFs of q's trigrams that hash f
    folds into bucket c (collisions add, so the coarse score stays an upper
    bound); ``w_val`` holds each trigram's own IDF (0 for the V sentinel)."""
    qb = ids.shape[0]
    w_val = idf_ext[ids]
    parts = []
    for f in range(fold_ext.shape[0]):
        w = torch.zeros((qb, C + 1), dtype=torch.float32, device=ids.device)
        w.scatter_add_(1, fold_ext[f][ids], w_val)
        parts.append(w[:, :C])
    return torch.cat(parts, dim=1), w_val


def select_rescore_plain(wmax: torch.Tensor, warg: torch.Tensor, tl_mat: torch.Tensor,
                         sums: torch.Tensor, ids: torch.Tensor, w_val: torch.Tensor,
                         maxint: torch.Tensor, nt: int, kprime: int,
                         k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel G (``select_rescore``'s CPU route).

    The coarse top-k' of the window maxima ``wmax`` f32 (QB, NW), ties to
    the lower window (``lax.top_k``'s order), stand for the titles
    ``warg`` i32 (QB, NW) of their windows; each is rescored by the exact
    IDF-weighted Jaccard against the trigram lists ``tl_mat`` (ntp, Ltw),
    and the top-k of those scores (ties to the lower coarse rank) are
    returned: (scores f32 (QB, k), title positions i32 (QB, k)).

    Numerator: Σ_l w_val[q, l] · [ids[q, l] ∈ TL[pos]], accumulated over l in
    ascending order as the reference does; positions outside [0, nt) score
    -1."""
    _, order = torch.sort(wmax, dim=1, descending=True, stable=True)
    pos_c = torch.gather(warg, 1, order[:, :kprime])
    safe = pos_c.clamp(min=0).to(torch.int64)
    tlg = tl_mat[safe]                                       # (QB, k', Ltw)
    c = torch.zeros(pos_c.shape, dtype=torch.float32, device=pos_c.device)
    for l in range(ids.shape[1]):
        hit = (tlg == ids[:, l, None, None]).any(dim=2)
        c = c + w_val[:, l, None] * hit
    s = sums[safe]
    denom = (s + maxint[:, None]) - c
    jacc = c / torch.clamp(denom, min=1e-9)
    jacc = torch.where((pos_c >= 0) & (pos_c < nt), jacc, torch.full_like(jacc, -1.0))
    vals, order = torch.sort(jacc, dim=1, descending=True, stable=True)
    order = order[:, :k]
    return vals[:, :k], torch.gather(pos_c, 1, order)


# kernel G: the most candidates and query slots it takes, and the bytes of
# the candidate rows it holds on chip at once
_G_MAX_KPRIME, _G_MAX_SLOTS, _G_ROW_BYTES = 1024, 256, 64 * 1024


def select_rescore(wmax: torch.Tensor, warg: torch.Tensor, tl_mat: torch.Tensor, sums: torch.Tensor,
                   ids: torch.Tensor, w_val: torch.Tensor, maxint: torch.Tensor, nt: int,
                   kprime: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded engine's select and exact rescore after kernel A:
    ``select_rescore_plain``'s results, bit for bit.

    wmax f32 and warg i32 (QB, NW) are kernel A's window maxima and their
    titles; tl_mat i32 (ntp, Ltw) the trigram lists and sums f32 (ntp,);
    ids int64 and w_val f32 (QB, LQ) the block's trigram ids and weights,
    maxint f32 (QB,).  Returns (scores f32, positions i32), each (QB,
    min(k, k', NW)).  CPU tensors take the plain version; CUDA tensors
    launch kernel G (``csrc/fold_rescore.cu``) on the current stream, which
    takes k' ≤ 1,024, LQ ≤ 256, NW and Ltw multiples of 4, Ltw ≤ 16,384,
    nt ≤ ntp and finite weights; any other input raises."""
    QB, NW = wmax.shape if wmax.dim() == 2 else (-1, -1)
    LQ = ids.shape[1] if ids.dim() == 2 else -1
    if (wmax.dtype != torch.float32 or warg.dtype != torch.int32 or tl_mat.dtype != torch.int32
            or sums.dtype != torch.float32 or w_val.dtype != torch.float32
            or maxint.dtype != torch.float32 or ids.dtype != torch.int64):
        raise TypeError("kernel G takes f32 maxima, sums, weights and bounds, i32 titles and "
                        "trigram lists, and int64 ids")
    if (QB < 0 or LQ < 0 or warg.shape != (QB, NW) or tl_mat.dim() != 2
            or sums.shape != (tl_mat.shape[0],) or ids.shape[0] != QB or w_val.shape != (QB, LQ)
            or maxint.shape != (QB,)):
        raise ValueError(f"shape mismatch: wmax {tuple(wmax.shape)}, warg {tuple(warg.shape)}, "
                         f"tl {tuple(tl_mat.shape)}, sums {tuple(sums.shape)}, ids "
                         f"{tuple(ids.shape)}, w_val {tuple(w_val.shape)}, "
                         f"maxint {tuple(maxint.shape)}")
    dev = wmax.device
    if any(t.device != dev for t in (warg, tl_mat, sums, ids, w_val, maxint)):
        raise ValueError("kernel G inputs must be on one device")
    if dev.type == "cpu":
        return select_rescore_plain(wmax, warg, tl_mat, sums, ids, w_val, maxint, nt, kprime, k)
    if dev.type != "cuda":
        raise RuntimeError(f"kernel G runs on CUDA tensors, not {dev}")
    ntp, ltw = tl_mat.shape
    kp = min(kprime, NW)
    kk = min(k, kp)
    if (kk < 1 or kp > _G_MAX_KPRIME or LQ > _G_MAX_SLOTS or NW % 4 or ltw % 4
            or not 4 <= ltw * 4 <= _G_ROW_BYTES or not 0 <= nt <= ntp):
        raise ValueError(f"kernel G takes 1 <= k <= k' <= {_G_MAX_KPRIME}, LQ <= {_G_MAX_SLOTS}, "
                         f"window and list widths of multiples of 4 (lists of at most "
                         f"{_G_ROW_BYTES // 4}) and nt <= titles, got k={k}, k'={kprime}, "
                         f"LQ={LQ}, NW={NW}, Ltw={ltw}, nt={nt}, {ntp} titles")
    check_launch("kernel G", wmax, warg, tl_mat, sums, ids, w_val, maxint)
    vals = torch.empty((QB, kk), dtype=torch.float32, device=dev)
    pos = torch.empty((QB, kk), dtype=torch.int32, device=dev)
    if QB == 0:
        return vals, pos
    with torch.cuda.device(dev):          # the launch goes to the tensors' card
        rc = _build.lib().doppel_select_rescore(
            wmax.data_ptr(), warg.data_ptr(), ids.data_ptr(), w_val.data_ptr(), maxint.data_ptr(),
            tl_mat.data_ptr(), sums.data_ptr(), vals.data_ptr(), pos.data_ptr(), QB, NW, LQ, ltw,
            int(nt), kp, kk,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "doppel_select_rescore")
    _build.count(select_rescore)
    return vals, pos


select_rescore.launches = 0


class FoldedEngine(nn.Module):
    """Device-resident folded-retrieval state for one truth set."""

    def __init__(self, index, truth: TitleSet, cfg: Config, device="cuda", *, tb: int,
                 ltw: Optional[int] = None):
        """The folded matrices and the trigram lists are built from one set
        of per-title ids, computed on the device from ``truth``'s encodings.
        ``ltw``: the width of the trigram lists (default: that of these
        titles; see ``build_trigram_list_matrix``)."""
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.C = int(cfg.fold_dim)
        self.kprime = int(cfg.rescore_depth)
        self.folds = max(1, int(cfg.fold_hashes))
        self.tb = tb
        self.W = int(cfg.fold_select_window) or max(tb // 128, 1)
        self.nt = index.num_titles
        ntp = index.padded_titles
        ids, _ = build_shard(truth.encoded, truth.lengths, device, ids_width(truth.lengths))
        fold_maps = [build_fold_map(index.df, self.C, seed=f) for f in range(self.folds)]
        mc = torch.cat([build_folded_matrix(ids, fm, self.C, ntp) for fm in fold_maps], dim=0)
        self.register_buffer("mc", mc)
        self.register_buffer("fold_ext", torch.from_numpy(np.stack(fold_maps).astype(np.int64)).to(device))
        if self.kprime > 0:
            tl, self.ltw = build_trigram_list_matrix(ids, ntp, ltw=ltw)
        else:
            tl, self.ltw = None, 0
        self.register_buffer("tl", tl)
        zero = np.zeros(1, np.float32)
        self.register_buffer("idf_ext", torch.from_numpy(np.concatenate([index.idf, zero])).to(device))
        self.register_buffer("fb_ext", torch.from_numpy(
            np.concatenate([index.fallback_idf(), zero])).to(device))
        self.register_buffer("sums", torch.from_numpy(index.sums).to(device))
        LOGGER.info("[FoldedEngine] C=%d hashes=%d kprime=%d ltw=%d: Mc %.1f MB",
                    self.C, self.folds, self.kprime, self.ltw, mc.numel() / 1e6)

    def topk_block(self, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k (scores f32, title positions i32) for one block of trigram
        ids int64 (QB, LQ) with V in unused slots."""
        wfold, w_val = coarse_weights(ids, self.idf_ext, self.fold_ext, self.C)
        maxint = self.fb_ext[ids].sum(dim=1)
        wmax, warg = score_window_select(
            self.mc, wfold, self.sums, maxint, self.nt,
            tb=self.tb, W=self.W, folds=self.folds, score_dtype=self.cfg.score_dtype,
        )
        if self.kprime <= 0:
            return select_topk_windowed(wmax, warg, k)
        return select_rescore(wmax, warg, self.tl, self.sums, ids, w_val, maxint, self.nt,
                              max(self.kprime, k), k)
