"""Retrieval: top-k IDF-weighted Jaccard candidates per query.

The JAX package's ``JaccardScorer`` with both of its engines:

- **exact** (``ExactEngine``, the JAX ``_topk_multiblock`` with
  ``impl="pallas"``): per block of ``query_block`` queries, the union of
  their trigram ids is scored either with the per-window pre-selection
  (``retrieval_window_select``, the default: kernel A with ``folds=1``) or
  as the full matrix (kernel D) followed by an exact top-k.  Both kernels
  read the union's rows straight from the packed index, so no gathered
  copy of them exists.  ``"exact"`` takes it at any size,
  ``"auto"`` below ``folded_min_titles`` or when no truth encodings are
  given;
- **folded** (``ops/fold.py``): ``"folded"``, and ``"auto"`` at or above
  ``folded_min_titles`` titles.
"""

from __future__ import annotations

import logging
from collections import Counter
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.device import resolve_device
from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
from doppelspeller_tpu_torch.ops.fold import FoldedEngine, plan_id_blocks
from doppelspeller_tpu_torch.ops.ngram_index import (
    QueryBlockPlan,
    TruthIndex,
    build_packed_matrix,
    plan_query_blocks,
)
from doppelspeller_tpu_torch.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)


class ExactEngine(nn.Module):
    """Device-resident exact-retrieval state: the packed (V, ntp/8) index,
    the IDF tables and the per-title sums."""

    def __init__(self, index: TruthIndex, cfg: Config, device="cuda", *, tb: int):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        self.tb = tb
        self.nt = index.num_titles
        self.register_buffer("packed", build_packed_matrix(index, device))
        self.register_buffer("idf", torch.from_numpy(index.idf).to(device))
        self.register_buffer("fb", torch.from_numpy(index.fallback_idf()).to(device))
        self.register_buffer("sums", torch.from_numpy(index.sums).to(device))
        self.union_sizes: Counter = Counter()     # blocks scored, by union size
        LOGGER.info("[ExactEngine] packed index %.2f GB, tb=%d", self.packed.numel() / 1e9, tb)

    def check_plan(self, plan: QueryBlockPlan) -> None:
        """The host part of a block: the kernels read packed[id] unchecked,
        so the plan's union ids are held to the index here, where they are
        still on the host; the block is counted under its union size."""
        V = self.packed.shape[0]
        if plan.union_ids.size and not (0 <= plan.union_ids.min() and plan.union_ids.max() < V):
            raise ValueError(f"union ids outside the packed index's {V} rows")
        self.union_sizes[plan.union_ids.shape[0]] += 1

    def topk_block(self, plan: QueryBlockPlan, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k (scores f32, title positions i32) of one plan's block."""
        self.check_plan(plan)
        dev = self.packed.device
        return self.topk_union(torch.from_numpy(plan.union_ids).to(dev),
                               torch.from_numpy(plan.w_pos).to(dev), k)

    def topk_union(self, union_ids: torch.Tensor, w_pos: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device part of a block: top-k of the queries whose trigrams
        sit at ``w_pos`` (QB, LQ) in the union ``union_ids`` (U,), integer
        tensors on the device that ``check_plan`` passed.  No host sync.

        Weights and the max-intersection bound are rebuilt from the resident
        tables as the reference does on the device: w_val = (idf[union] ‖
        0)[min(w_pos, U)] and maxint = Σ (fb[union] ‖ 0)[min(w_pos, U)] in
        f32, slot U standing for a query's unused trigram slots.  The
        union's own padding rows (id 0) get no weight."""
        dev = self.packed.device
        uid = union_ids.to(torch.int64)
        u = uid.shape[0]
        wp = w_pos.to(torch.int64).clamp(max=u)
        zero = torch.zeros(1, dtype=torch.float32, device=dev)
        w_val = torch.cat([self.idf[uid], zero])[wp]
        maxint = torch.cat([self.fb[uid], zero])[wp].sum(dim=1)
        w = jk.densify_weights(wp, w_val, u)
        sd = self.cfg.score_dtype
        if self.cfg.retrieval_window_select:
            W = max(self.tb // 128, 1)
            wmax, warg = jk.score_window_select(self.packed, w, self.sums, maxint, self.nt,
                                                tb=self.tb, W=W, folds=1, score_dtype=sd,
                                                union_ids=uid)
            return jk.select_topk_windowed(wmax, warg, k)
        jacc = jk.score_full(self.packed, uid, w, self.sums, maxint, self.nt, tb=self.tb,
                             score_dtype=sd)
        return jk.select_topk_permuted(jacc, k, self.tb)


class JaccardScorer:
    """Device-resident retrieval engine over a TruthIndex.  ``truth`` (the
    encodings) is needed by the folded engine only."""

    def __init__(self, index: TruthIndex, config: Config, device="cuda",
                 truth: Optional[TitleSet] = None):
        self.cfg = config
        self.index = index
        self.device = resolve_device(device)
        folded = self._wants_folded(index, config, truth)
        tb = 2048 if index.padded_titles % 2048 == 0 else config.title_block
        self.folded = FoldedEngine(index, truth, config, self.device, tb=tb) if folded else None
        self.exact = None if folded else ExactEngine(index, config, self.device, tb=tb)

    @staticmethod
    def _wants_folded(index: TruthIndex, config: Config, truth: Optional[TitleSet]) -> bool:
        """Whether ``retrieval_mode`` takes the folded engine: ``"folded"``,
        or ``"auto"`` given the truth encodings at ``folded_min_titles``
        titles or more."""
        mode = config.retrieval_mode
        if mode not in ("auto", "exact", "folded"):
            raise ValueError(f"unknown retrieval_mode {mode!r}")
        folded = mode == "folded" or (
            mode == "auto" and truth is not None
            and index.num_titles >= config.folded_min_titles
        )
        if folded and truth is None:
            raise ValueError("retrieval_mode='folded' needs the truth TitleSet "
                             "(encodings): pass truth= to the scorer")
        return folded

    def topk_device(self, queries: TitleSet, k: Optional[int] = None,
                    rows: Optional[np.ndarray] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores f32 (R, k), title positions i32 (R, k)) on the device, one
        row per entry of ``rows`` (default: every query), sorted by
        descending score."""
        k = k or self.cfg.top_n_predicting
        if self.index.num_titles < k:
            raise ValueError(f"index has {self.index.num_titles} titles < k={k}")
        vals: List[torch.Tensor] = []
        pos: List[torch.Tensor] = []
        if self.exact is not None:
            # plans keep the order of ``rows`` (overflowing blocks split in order)
            for p in plan_query_blocks(queries, self.index, self.cfg, rows=rows):
                v, ps = self.exact.topk_block(p, k)
                vals.append(v[: p.n_valid])
                pos.append(ps[: p.n_valid])
        else:
            plans = plan_id_blocks(queries, self.cfg, rows=rows)
            if plans:
                ids = torch.from_numpy(np.concatenate([p.ids for p in plans])).to(self.device)
                ids = ids.to(torch.int64)
                qb = plans[0].ids.shape[0]
                for j, p in enumerate(plans):
                    v, ps = self.folded.topk_block(ids[j * qb : (j + 1) * qb], k)
                    vals.append(v[: p.n_valid])
                    pos.append(ps[: p.n_valid])
        if not vals:
            empty = torch.zeros((0, k), device=self.device)
            return empty, empty.to(torch.int32)
        return torch.cat(vals), torch.cat(pos)

    def topk(self, queries: TitleSet, k: Optional[int] = None,
             rows: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Host (scores float32[N, k], positions int32[N, k]) into
        ``index.title_ids``, sorted by descending score."""
        vals, pos = self.topk_device(queries, k=k, rows=rows)
        return vals.cpu().numpy(), pos.cpu().numpy()

    def topk_title_ids(self, queries: TitleSet, k: Optional[int] = None,
                       rows: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Like :meth:`topk` but with the positions mapped to the external
        title ids."""
        scores, pos = self.topk(queries, k=k, rows=rows)
        return scores, self.index.title_ids[pos]
