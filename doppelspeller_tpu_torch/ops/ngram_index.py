"""Truth-index statistics: trigram document frequencies, IDF, per-title sums.

The JAX package's ``TruthIndex`` without its bit-packed (V, ntp/8) occupancy
matrix: the folded retrieval path never reads it (it builds its own folded
matrix, ``ops/fold.py``), and at 500k titles it would take 3.2 GB.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from doppelspeller_tpu_torch.config import TRIGRAM_VOCAB_SIZE, Config
from doppelspeller_tpu_torch.utils import text as T
from doppelspeller_tpu_torch.utils.io import TitleSet


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class TruthIndex:
    idf: np.ndarray         # float32[V] ln(N/df), 0 for unobserved trigrams
    df: np.ndarray          # int32[V] document frequency
    sums: np.ndarray        # float32[ntp] per-title IDF sum (0 for padding)
    title_ids: np.ndarray   # int64[nt] external title ids
    num_titles: int         # nt
    padded_titles: int      # ntp, a multiple of title_block
    max_idf: float          # fallback IDF for query trigrams absent in truth

    @property
    def vocab_size(self) -> int:
        return self.idf.shape[0]

    def fallback_idf(self) -> np.ndarray:
        """float32[V] per-trigram weight of the max-intersection bound: the
        IDF where the trigram is observed in truth, else ``max_idf``."""
        return np.where(self.df > 0, self.idf, np.float32(self.max_idf)).astype(np.float32)


def build_truth_index(truth: TitleSet, config: Config) -> TruthIndex:
    """IDF = ln(N/df) over per-title-unique trigrams; per-title IDF sums
    accumulated in float64 and stored as float32."""
    nt = len(truth)
    ntp = _round_up(max(nt, config.title_block), config.title_block)
    ids = truth.trigram_ids()                                # (nt, W), BIG pad
    valid = ids != T.BIG_TRIGRAM
    df = np.bincount(ids[valid], minlength=TRIGRAM_VOCAB_SIZE).astype(np.int32)
    idf = T.idf_table_from_df(df, nt)
    max_idf = float(idf.max()) if nt > 0 else 0.0
    w = np.where(valid, idf[np.minimum(ids, TRIGRAM_VOCAB_SIZE - 1)].astype(np.float64), 0.0)
    sums = np.zeros(ntp, dtype=np.float32)
    sums[:nt] = w.sum(axis=1).astype(np.float32)
    return TruthIndex(
        idf=idf, df=df, sums=sums, title_ids=truth.ids.copy(), num_titles=nt,
        padded_titles=ntp, max_idf=max_idf,
    )
