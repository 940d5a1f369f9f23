"""Retrieval: top-k IDF-weighted Jaccard candidates per query.

The JAX package's ``JaccardScorer`` for its folded engine (``ops/fold.py``).
The exact union path is not ported yet (ROADMAP queue 1): a configuration
that resolves to it raises ``NotImplementedError`` rather than running
anything else.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.device import resolve_device
from doppelspeller_tpu_torch.ops.fold import FoldedEngine, plan_id_blocks
from doppelspeller_tpu_torch.ops.ngram_index import TruthIndex
from doppelspeller_tpu_torch.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)


class JaccardScorer:
    """Device-resident retrieval engine over a TruthIndex."""

    def __init__(self, index: TruthIndex, config: Config, device, truth: TitleSet):
        self.cfg = config
        self.index = index
        self.device = resolve_device(device)
        mode = config.retrieval_mode
        folded = mode == "folded" or (
            mode == "auto" and index.num_titles >= config.folded_min_titles
        )
        if not folded:
            raise NotImplementedError(
                f"retrieval_mode={mode!r} at {index.num_titles} titles resolves to the "
                "exact retrieval path, which the PyTorch port does not have yet "
                "(ROADMAP queue 1: exact retrieval, kernel A with row ids)"
            )
        tb = 2048 if index.padded_titles % 2048 == 0 else config.title_block
        self.folded = FoldedEngine(index, truth, config, self.device, tb)

    def topk_device(self, queries: TitleSet, k: Optional[int] = None,
                    rows: Optional[np.ndarray] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores f32 (R, k), title positions i32 (R, k)) on the device, one
        row per entry of ``rows`` (default: every query), sorted by
        descending score."""
        k = k or self.cfg.top_n_predicting
        if self.index.num_titles < k:
            raise ValueError(f"index has {self.index.num_titles} titles < k={k}")
        plans = plan_id_blocks(queries, self.cfg, rows=rows)
        if not plans:
            empty = torch.zeros((0, k), device=self.device)
            return empty, empty.to(torch.int32)
        ids = torch.from_numpy(np.concatenate([p.ids for p in plans])).to(self.device)
        ids = ids.to(torch.int64)
        qb = plans[0].ids.shape[0]
        vals, pos = [], []
        for j, p in enumerate(plans):
            v, ps = self.folded.topk_block(ids[j * qb : (j + 1) * qb], k)
            vals.append(v[: p.n_valid])
            pos.append(ps[: p.n_valid])
        return torch.cat(vals), torch.cat(pos)

    def topk(self, queries: TitleSet, k: Optional[int] = None,
             rows: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Host (scores float32[N, k], positions int32[N, k]) into
        ``index.title_ids``, sorted by descending score."""
        vals, pos = self.topk_device(queries, k=k, rows=rows)
        return vals.cpu().numpy(), pos.cpu().numpy()
