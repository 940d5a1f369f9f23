"""Host-side text primitives: normalization, char codec, trigram ids, IDF.

numpy and pure Python, equal to the JAX package's ``utils/text.py`` (its C++
fast path is not carried; the tests hold this module equal to it).
"""

from __future__ import annotations

import math
import re
import unicodedata
from collections import Counter
from typing import Iterable, List, Sequence

import numpy as np

from doppelspeller_tpu_torch.config import ALPHABET, N_TEXT_CHARS, PAD_CODE, TRIGRAM_VOCAB_SIZE

MAX_CHARACTERS = 255
N_GRAMS = 3

_KEEP_RE = re.compile(r"[^a-zA-Z0-9\s]+")
_WS_RE = re.compile(r"\s")
_SPACES_RE = re.compile(r" +")

# char -> uint8 code ('-'=0 pad, ' '=1, 'a'..'z'=2..27, '0'..'9'=28..37)
CHAR_ENCODING = {ch: i for i, ch in enumerate(ALPHABET)}
CHAR_DECODING = {i: ch for ch, i in CHAR_ENCODING.items()}

# uint8 code -> trigram text-char id (space=0, a..z=1..26, 0..9=27..36);
# the pad code maps to -1
_FEATURE_TO_TEXT = np.full(256, -1, dtype=np.int32)
for _ch, _code in CHAR_ENCODING.items():
    if _ch == "-":
        continue
    if _ch == " ":
        _FEATURE_TO_TEXT[_code] = 0
    elif "a" <= _ch <= "z":
        _FEATURE_TO_TEXT[_code] = 1 + (ord(_ch) - ord("a"))
    else:
        _FEATURE_TO_TEXT[_code] = 27 + (ord(_ch) - ord("0"))

_ASCII_LUT = np.zeros(128, dtype=np.uint8)
for _ch, _code in CHAR_ENCODING.items():
    _ASCII_LUT[ord(_ch)] = _code

BIG_TRIGRAM = np.int32(1 << 30)  # sorts after every real trigram id


def transform_title(title: str, max_characters: int = MAX_CHARACTERS,
                    n_grams: int = N_GRAMS) -> str:
    """Lower-case alphanumeric normal form: NFD, drop non-ascii, '-' → space,
    keep [a-z0-9 ], collapse spaces, trim, truncate, left-pad with '0' to at
    least ``n_grams`` characters."""
    text = unicodedata.normalize("NFD", title)
    text = text.encode("ascii", "ignore").decode("utf-8").lower().replace("-", " ")
    text = _KEEP_RE.sub("", text)
    text = _WS_RE.sub(" ", text)
    text = _SPACES_RE.sub(" ", text).strip()
    n_chars = len(text)
    text = text[:max_characters].strip()
    if n_chars < n_grams:
        return text.rjust(n_grams, "0")
    return text


def transform_titles(titles: Iterable[str], max_characters: int = MAX_CHARACTERS,
                     n_grams: int = N_GRAMS) -> List[str]:
    return [transform_title(t, max_characters, n_grams) for t in titles]


def get_n_grams(title: str, n: int = N_GRAMS) -> set:
    """Set of all character n-grams of ``title``."""
    return {title[i : i + n] for i in range(len(title) - n + 1)}


def get_words_counter(words_lists: Iterable[Sequence[str]]) -> Counter:
    """Document-frequency counter: each word counted once per title."""
    counter: Counter = Counter()
    for words in words_lists:
        counter.update(set(words))
    return counter


def idf_word(word: str, words_counter: Counter, number_of_titles: int) -> float:
    """Natural-log inverse document frequency of ``word``."""
    return math.log(number_of_titles / words_counter[word])


def encode_title(title: str, max_characters: int = MAX_CHARACTERS) -> np.ndarray:
    """uint8[max_characters] char codes, zero-padded."""
    return encode_titles([title], max_characters)[0]


def decode_title(codes: np.ndarray) -> str:
    """The title of ``encode_title``'s codes (pads dropped)."""
    return "".join(CHAR_DECODING[int(c)] for c in codes if c != PAD_CODE)


def encode_titles(titles: Sequence[str], max_characters: int = MAX_CHARACTERS) -> np.ndarray:
    """uint8[B, max_characters] char codes, zero-padded."""
    out = np.zeros((len(titles), max_characters), dtype=np.uint8)
    for i, t in enumerate(titles):
        b = np.frombuffer(t[:max_characters].encode("ascii"), dtype=np.uint8)
        out[i, : len(b)] = _ASCII_LUT[b]
    return out


def trigram_ids_from_codes(codes: np.ndarray, length: int) -> np.ndarray:
    """Sorted unique trigram ids (int32) of one encoded title:
    id(c0, c1, c2) = c0·37² + c1·37 + c2 over the text-char ids."""
    if length < 3:
        raise ValueError("transformed titles are always >= 3 chars")
    text = _FEATURE_TO_TEXT[codes[:length]]
    ids = text[:-2] * (N_TEXT_CHARS * N_TEXT_CHARS) + text[1:-1] * N_TEXT_CHARS + text[2:]
    return np.unique(ids.astype(np.int32))


def trigram_ids_matrix(encoded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """int32[B, L_eff-2] per-title unique trigram ids, sorted ascending, with
    invalid and duplicate slots set to BIG_TRIGRAM (L_eff = longest title)."""
    B, L = encoded.shape
    L_eff = int(lengths.max(initial=3)) if B else 3
    if L_eff < L:
        encoded = encoded[:, :L_eff]
        L = L_eff
    text = _FEATURE_TO_TEXT[encoded]
    ids = (
        text[:, :-2] * (N_TEXT_CHARS * N_TEXT_CHARS)
        + text[:, 1:-1] * N_TEXT_CHARS
        + text[:, 2:]
    ).astype(np.int64)
    pos = np.arange(L - 2, dtype=np.int32)[None, :]
    valid = pos <= (lengths[:, None] - 3)
    ids = np.where(valid, ids, np.int64(BIG_TRIGRAM))
    ids.sort(axis=1)
    dup = np.zeros_like(ids, dtype=bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    ids = np.where(dup, np.int64(BIG_TRIGRAM), ids)
    ids.sort(axis=1)
    return ids.astype(np.int32)


def trigram_df(ids: np.ndarray) -> np.ndarray:
    """int32[V] document frequency of every trigram id in ``ids``
    (``trigram_ids_matrix``'s rows): the titles that hold it."""
    return np.bincount(ids[ids != BIG_TRIGRAM], minlength=TRIGRAM_VOCAB_SIZE).astype(np.int32)


def trigram_df_table(encoded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """``trigram_df`` of these encoded titles."""
    return trigram_df(trigram_ids_matrix(encoded, lengths))


def idf_table_from_df(df: np.ndarray, number_of_titles: int) -> np.ndarray:
    """float32[V] IDF table: ln(N/df) where df > 0, else 0."""
    idf = np.zeros_like(df, dtype=np.float32)
    nz = df > 0
    idf[nz] = np.log(number_of_titles / df[nz].astype(np.float64)).astype(np.float32)
    return idf
