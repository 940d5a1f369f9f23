"""Training-side helpers.  Only ``WordCounts`` is ported so far: the model
stage needs the truth-DB word document counts."""

from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np

from doppelspeller_tpu_torch.utils import text as T
from doppelspeller_tpu_torch.utils.io import TitleSet


class WordCounts:
    """Truth-DB word document counts → uint32[*, 15] rows."""

    def __init__(self, truth: TitleSet, w_slots: int = 15):
        self.counter: Counter = T.get_words_counter(truth.words)
        self.w_slots = w_slots

    def for_title(self, transformed: str) -> np.ndarray:
        out = np.zeros(self.w_slots, dtype=np.uint32)
        for k, w in enumerate(transformed.split()[: self.w_slots]):
            out[k] = self.counter[w]
        return out

    def matrix(self, titles: List[str]) -> np.ndarray:
        """uint32[len(titles), 15]."""
        return np.stack([self.for_title(t) for t in titles])
