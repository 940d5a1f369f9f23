"""Text for the plain reference: the title normal form, character codes and
trigram ids, written from the matcher's published semantics.

A title's normal form: NFD, non-ASCII dropped, lower case, '-' as a space,
only [a-z0-9 ] kept, runs of white space as one space, trimmed, cut to 255
characters and left-padded with '0' to three.  A trigram is three
consecutive characters of the normal form; over the 37 characters (space,
a-z, 0-9) its id is c0·37² + c1·37 + c2 with space 0, a-z 1-26, 0-9 27-36.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Sequence, Tuple

import numpy as np

MAX_CHARACTERS = 255
N_TEXT_CHARS = 37
VOCAB = N_TEXT_CHARS ** 3

_KEEP = re.compile(r"[^a-zA-Z0-9\s]+")
_WS = re.compile(r"\s")
_SPACES = re.compile(r" +")

# ASCII byte -> trigram character id (space 0, a-z 1-26, 0-9 27-36), -1 else
_TEXT_ID = np.full(256, -1, dtype=np.int64)
_TEXT_ID[ord(" ")] = 0
for _i in range(26):
    _TEXT_ID[ord("a") + _i] = 1 + _i
for _i in range(10):
    _TEXT_ID[ord("0") + _i] = 27 + _i
# ASCII byte -> LCS code (0 is padding and never matches)
_CODE = np.where(_TEXT_ID >= 0, _TEXT_ID + 1, 0).astype(np.int16)


def transform_title(title: str) -> str:
    text = unicodedata.normalize("NFD", title)
    text = text.encode("ascii", "ignore").decode("utf-8").lower().replace("-", " ")
    text = _KEEP.sub("", text)
    text = _WS.sub(" ", text)
    text = _SPACES.sub(" ", text).strip()
    n_chars = len(text)
    text = text[:MAX_CHARACTERS].strip()
    if n_chars < 3:
        return text.rjust(3, "0")
    return text


def token_sorted(title: str) -> str:
    return " ".join(sorted(title.split()))[:MAX_CHARACTERS]


def _bytes(titles: Sequence[str], width: int) -> np.ndarray:
    out = np.zeros((len(titles), max(width, 1)), dtype=np.uint8)
    for i, t in enumerate(titles):
        b = t.encode("ascii")
        out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


def codes(titles: Sequence[str], width: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(int16 (n, width) LCS codes zero-padded, int64 (n,) lengths); width
    defaults to the longest title."""
    lengths = np.array([len(t) for t in titles], dtype=np.int64)
    width = max(width, int(lengths.max(initial=1)))
    return _CODE[_bytes(titles, width)], lengths


def trigram_lists(titles: Sequence[str]) -> np.ndarray:
    """int64 (n, W) each title's distinct trigram ids ascending, -1 after
    them."""
    lengths = np.array([len(t) for t in titles], dtype=np.int64)
    width = int(lengths.max(initial=3))
    ids = _TEXT_ID[_bytes(titles, width)]
    tri = ids[:, :-2] * N_TEXT_CHARS ** 2 + ids[:, 1:-1] * N_TEXT_CHARS + ids[:, 2:]
    valid = np.arange(width - 2)[None, :] < (lengths[:, None] - 2)
    big = np.int64(1) << 40
    tri = np.sort(np.where(valid, tri, big), axis=1)
    dup = np.zeros_like(valid)
    dup[:, 1:] = tri[:, 1:] == tri[:, :-1]
    tri = np.sort(np.where(dup, big, tri), axis=1)
    keep = int((tri < big).sum(axis=1).max(initial=1))
    tri = tri[:, :keep]
    return np.where(tri < big, tri, -1)


def words(title: str) -> List[str]:
    return title.split(" ")
