"""``TitleSet``: a batch of titles with every derived encoding, as numpy.

The JAX package's ``utils/io.py`` without pandas: the CSV loaders come with
the port's command-line verbs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.utils import text as T


@dataclass
class TitleSet:
    """A collection of titles with all derived encodings."""

    titles: List[str]                 # raw input titles
    transformed: List[str]            # normalized titles
    ids: np.ndarray                   # int64[B] external ids
    encoded: np.ndarray               # uint8[B, max_chars] char codes
    lengths: np.ndarray               # int32[B] transformed lengths
    labels: Optional[np.ndarray] = None
    _words: Optional[List[List[str]]] = field(default=None, repr=False)
    _wo: Optional[tuple] = field(default=None, repr=False)
    _ts: Optional[tuple] = field(default=None, repr=False)
    _tri: Optional[np.ndarray] = field(default=None, repr=False)

    def __len__(self) -> int:
        return len(self.transformed)

    @property
    def words(self) -> List[List[str]]:
        if self._words is None:
            self._words = [t.split() for t in self.transformed]
        return self._words

    @property
    def encoded_wo(self) -> tuple:
        """Spaceless encodings (enc uint8[B, L], len int32[B]), built once."""
        if self._wo is None:
            L = self.encoded.shape[1]
            wo = [t[:L].replace(" ", "") for t in self.transformed]
            enc = T.encode_titles(wo, L)
            ln = np.array([min(len(t), L) for t in wo], dtype=np.int32)
            self._wo = (enc, ln)
        return self._wo

    @property
    def encoded_token_sorted(self) -> tuple:
        """Token-sorted encodings (enc uint8[B, L], len int32[B]), built once."""
        if self._ts is None:
            L = self.encoded.shape[1]
            ts = [" ".join(sorted(t.split())) for t in self.transformed]
            enc = T.encode_titles(ts, L)
            ln = np.array([min(len(t), L) for t in ts], dtype=np.int32)
            self._ts = (enc, ln)
        return self._ts

    def trigram_ids(self) -> np.ndarray:
        """int32[B, W] per-title sorted unique trigram ids, built once."""
        if self._tri is None:
            self._tri = T.trigram_ids_matrix(self.encoded, self.lengths)
        return self._tri

    @classmethod
    def from_titles(
        cls,
        titles: List[str],
        ids: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        config: Optional[Config] = None,
    ) -> "TitleSet":
        max_chars = config.max_characters if config else T.MAX_CHARACTERS
        n_grams = config.n_grams if config else T.N_GRAMS
        transformed = T.transform_titles(titles, max_chars, n_grams)
        encoded = T.encode_titles(transformed, max_chars)
        lengths = np.array([min(len(t), max_chars) for t in transformed], dtype=np.int32)
        if ids is None:
            ids = np.arange(len(titles), dtype=np.int64)
        return cls(
            titles=list(titles),
            transformed=transformed,
            ids=np.asarray(ids, dtype=np.int64),
            encoded=encoded,
            lengths=lengths,
            labels=None if labels is None else np.asarray(labels, dtype=np.int64),
        )
