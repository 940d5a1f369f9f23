"""CSV ingestion → ``TitleSet``: a batch of titles with every derived
encoding, as numpy.

The JAX package's ``utils/io.py`` with the standard library's ``csv`` in
place of pandas, which this package does not depend on.  A file reads as
``pandas.read_csv(path, delimiter=...)`` reads it, and the loaders then take
``str`` of each title and ``astype(np.int64)`` of each id as the reference
does: pandas' quoting (``"`` with doubled quotes inside), blank lines
skipped, an empty field or one of pandas' default NA strings read as
missing (so the title ``"nan"``), and a column whose every value is a
number or a boolean read as one (``007`` as ``7``, ``12`` beside a missing
value as ``12.0``, ``true`` as ``True``).
"""

from __future__ import annotations

import csv
import logging
import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from doppelspeller_tpu_torch.config import Config, get_config
from doppelspeller_tpu_torch.utils import text as T
from doppelspeller_tpu_torch.utils import timing

LOGGER = logging.getLogger(__name__)

# pandas' default NA strings (``keep_default_na``)
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?((\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|inf|infinity)\s*", re.IGNORECASE)
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}
_INT64_MAX = 2 ** 63 - 1


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
        """Spaceless encodings (enc uint8[B, L], len int32[B]), built once
        from the codes."""
        if self._wo is None:
            with timing.span("doppel.encode.wo", titles=len(self)) as sp:
                if len(self) < T.FLAT_MIN_TITLES:
                    self._wo = T.spaceless_codes_plain(self.transformed, self.encoded.shape[1])
                    sp.set(per_title=len(self))
                else:
                    self._wo = T.spaceless_codes(self.encoded, self.lengths)
                    sp.set(per_title=0)
        return self._wo

    @property
    def encoded_token_sorted(self) -> tuple:
        """Token-sorted encodings (enc uint8[B, L], len int32[B]), built once."""
        if self._ts is None:
            with timing.span("doppel.encode.token_sort", titles=len(self)) as sp:
                self._ts = T.token_sorted_codes(self.transformed, self.encoded.shape[1])
                sp.set(per_title=len(self) if len(self) < T.FLAT_MIN_TITLES else 0)
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
        with timing.span("doppel.encode", titles=len(titles)) as sp:
            transformed, encoded, lengths, per_title = T.transform_encode_titles(
                titles, max_chars, n_grams)
            sp.set(per_title=per_title)
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


def _column(fields: List[Optional[str]]) -> List[object]:
    """The values pandas' type inference gives one column: ``None`` for a
    missing value, else ints, floats (ints too where a value is missing),
    bools or the strings as written."""
    present = [v for v in fields if v is not None]
    if not present:
        return [None] * len(fields)
    if all(_INT.fullmatch(v) for v in present) and all(
            abs(int(v)) <= _INT64_MAX for v in present):
        conv = (lambda v: int(v)) if len(present) == len(fields) else (lambda v: float(int(v)))
    elif all(_FLOAT.fullmatch(v) for v in present):
        conv = float
    elif all(v in _BOOL for v in present):
        conv = _BOOL.__getitem__
    else:
        return list(fields)
    return [None if v is None else conv(v) for v in fields]


def read_csv(path: str, delimiter: str) -> Dict[str, List[object]]:
    """Columns of a delimited file with a header row, by name (the first
    of duplicate names), as ``pandas.read_csv(path, delimiter=...)`` types
    them (see the module docstring)."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f, delimiter=delimiter, quotechar='"', doublequote=True,
                                      strict=False) if r]
    if not rows:
        raise ValueError(f"Invalid input file {path}: no header row")
    header = rows[0]
    width = len(header)
    cols: List[List[Optional[str]]] = [[] for _ in header]
    for line, r in enumerate(rows[1:], start=2):
        if len(r) > width:
            raise ValueError(f"Invalid input file {path}: expected {width} fields in row {line}, "
                             f"saw {len(r)}")
        r = r + [""] * (width - len(r))
        for c, v in zip(cols, r):
            c.append(None if v in NA_STRINGS else v)
    out: Dict[str, List[object]] = {}
    for name, c in zip(header, cols):
        out.setdefault(name, _column(c))
    return out


def _read_csv(path: str, delimiter: str, required_columns: tuple) -> Dict[str, List[object]]:
    """Load + validate schema: a clear error on a missing column."""
    df = read_csv(path, delimiter)
    missing = [c for c in required_columns if c not in df]
    if missing:
        raise ValueError(
            f"Invalid input file {path}: missing required column(s) "
            f"{missing} (found {list(df)}, delimiter {delimiter!r})"
        )
    return df


def as_titles(values: List[object]) -> List[str]:
    """``str`` of each value, a missing one ``"nan"`` (pandas' NaN)."""
    return ["nan" if v is None else str(v) for v in values]


def as_int64(values: List[object]) -> np.ndarray:
    """int64 ids as ``Series.astype(np.int64)`` gives them: floats truncate,
    a missing value or a string that is not an integer raises ValueError."""
    if any(v is None or (isinstance(v, float) and not math.isfinite(v)) for v in values):
        raise ValueError("Cannot convert non-finite values (NA or inf) to integer")
    if any(isinstance(v, float) for v in values):
        return np.asarray(values, dtype=np.float64).astype(np.int64)
    return np.asarray([int(v) for v in values], dtype=np.int64)


def load_ground_truth(config: Optional[Config] = None) -> TitleSet:
    """Truth DB loader: ids from ``truth_id_column``."""
    cfg = config or get_config()
    LOGGER.info("Reading and transforming the ground truth data!")
    df = _read_csv(cfg.ground_truth_path, cfg.delimiter,
                   (cfg.truth_id_column, cfg.truth_title_column))
    ts = TitleSet.from_titles(as_titles(df[cfg.truth_title_column]),
                              ids=as_int64(df[cfg.truth_id_column]), config=cfg)
    LOGGER.info("Read %d rows from the ground truth data input!", len(ts))
    return ts


def load_train_data(config: Optional[Config] = None) -> TitleSet:
    """Train loader; ``labels`` holds the title id column (−1 = not in truth)."""
    cfg = config or get_config()
    LOGGER.info("Reading and transforming the train data!")
    df = _read_csv(cfg.train_path, cfg.delimiter,
                   (cfg.train_index_column, cfg.truth_title_column, cfg.truth_id_column))
    ts = TitleSet.from_titles(as_titles(df[cfg.truth_title_column]),
                              ids=as_int64(df[cfg.train_index_column]),
                              labels=as_int64(df[cfg.truth_id_column]), config=cfg)
    LOGGER.info("Read %d rows from the train data input!", len(ts))
    return ts


def load_test_data(config: Optional[Config] = None) -> TitleSet:
    """Test loader: ids from ``test_index_column``."""
    cfg = config or get_config()
    LOGGER.info("Reading and transforming the test data!")
    df = _read_csv(cfg.test_path, cfg.delimiter, (cfg.test_index_column, cfg.truth_title_column))
    ts = TitleSet.from_titles(as_titles(df[cfg.truth_title_column]),
                              ids=as_int64(df[cfg.test_index_column]), config=cfg)
    LOGGER.info("Read %d rows from the test data input!", len(ts))
    return ts


def single_title_set(title: str, config: Optional[Config] = None) -> TitleSet:
    """One-row TitleSet for single-title search."""
    return TitleSet.from_titles([title], ids=np.array([0], dtype=np.int64), config=config)
