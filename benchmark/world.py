"""The benchmark's synthetic world: company-name-like truth titles and
queries drawn from one ``random.Random(seed)`` stream.

A frozen copy of the program's bench generator (``synthetic.py`` and
``utils/misspell.py``), kept here so that the yardstick does not move when
the program changes: the same seed gives the same stems, titles, queries
and actual ids.  Queries continue the stream after the titles; each is an
exact copy of a truth title, a misspelling of one (1-2 of: QWERTY-adjacent
letter insert or replace, letter removal, word swap, space insert or
removal, then the normal form), or a fresh title absent from truth (actual
-1), by the mix's shares.  With the shares 0.1 / 0.6 / 0.3 the draws are
the program generator's, draw for draw.
"""

from __future__ import annotations

import math
import random
import string
from typing import Dict, List, Optional, Tuple

from benchmark.reference.text import transform_title

COMMON_WORDS = (
    "limited", "ltd", "holdings", "group", "services", "international",
    "solutions", "consulting", "partners", "industries", "systems",
    "technologies", "ventures", "capital", "global", "management",
)


class World:
    """Truth titles (ids 1..n) and a stream that draws queries after them."""

    def __init__(self, n_titles: int, seed: int):
        rng = self.rng = random.Random(seed)
        self.stems = [
            "".join(rng.choice(string.ascii_lowercase) for _ in range(rng.randint(4, 10)))
            for _ in range(max(n_titles // 12, 1000))
        ]
        self.titles = [self.make_title() for _ in range(n_titles)]
        self._transformed: Optional[List[str]] = None

    def make_title(self) -> str:
        rng = self.rng
        words = [rng.choice(self.stems) for _ in range(rng.randint(1, 3))]
        if rng.random() < 0.75:
            words.append(rng.choice(COMMON_WORDS))
        if rng.random() < 0.15:
            words.append(str(rng.randint(1, 99)))
        return " ".join(words)

    def transformed(self, j: int) -> str:
        if self._transformed is None:
            self._transformed = [None] * len(self.titles)
        t = self._transformed[j]
        if t is None:
            t = self._transformed[j] = transform_title(self.titles[j])
        return t

    def queries(self, n: int, mix: Dict[str, float]) -> Tuple[List[str], List[int]]:
        """``n`` raw query titles and their actual truth ids (-1 absent);
        ``mix`` gives the shares of "exact" and "misspelled" (the rest is
        absent)."""
        rng = self.rng
        exact = float(mix["exact"])
        misspelled = exact + float(mix["misspelled"])
        n_titles = len(self.titles)
        out, actual = [], []
        for _ in range(n):
            r = rng.random()
            if r < exact:
                j = rng.randrange(n_titles)
                out.append(self.titles[j])
                actual.append(j + 1)
            elif r < misspelled:
                j = rng.randrange(n_titles)
                out.append(generate_misspelled_name(self.transformed(j), rng))
                actual.append(j + 1)
            else:
                out.append(self.make_title())
                actual.append(-1)
        return out, actual


KEYBOARD_CARTESIAN: Dict[str, tuple] = {
    "q": (0, 0), "w": (1, 0), "e": (2, 0), "r": (3, 0), "t": (4, 0),
    "y": (5, 0), "u": (6, 0), "i": (7, 0), "o": (8, 0), "p": (9, 0),
    "a": (0, 1), "s": (1, 1), "d": (2, 1), "f": (3, 1), "g": (4, 1),
    "h": (5, 1), "j": (6, 1), "k": (7, 1), "l": (8, 1),
    "z": (0, 2), "x": (1, 2), "c": (2, 2), "v": (3, 2), "b": (4, 2),
    "n": (5, 2), "m": (5, 2),
}


def _euclidean(a: str, b: str) -> float:
    ax, ay = KEYBOARD_CARTESIAN[a]
    bx, by = KEYBOARD_CARTESIAN[b]
    return math.sqrt((ax - bx) ** 2 + (ay - by) ** 2)


def _build_neighbours() -> Dict[str, List[str]]:
    out: Dict[str, set] = {}
    keys = list(KEYBOARD_CARTESIAN)
    for i in keys:
        for j in keys:
            if i != j and _euclidean(i, j) <= 1.0:
                out.setdefault(i, set()).add(j)
                out.setdefault(j, set()).add(i)
    return {k: sorted(v) for k, v in out.items()}


EUCLIDEAN_NEIGHBOURS = _build_neighbours()

_PROTECTED = " 0123456789"
_MAX_RETRIES = 10


def _pick_letter_index(x: str, rng: random.Random, avoid: str) -> Optional[int]:
    length = len(x)
    idx = rng.randint(0, length - 1)
    tries = 0
    while x[idx] in avoid:
        tries += 1
        if tries > _MAX_RETRIES:
            return None
        idx = rng.randint(0, length - 1)
    return idx


def remove_letter(x: str, rng: random.Random) -> str:
    idx = _pick_letter_index(x, rng, avoid=" ")
    if idx is None:
        return x
    return x[:idx] + x[idx + 1 :]


def add_letter(x: str, rng: random.Random) -> str:
    idx = _pick_letter_index(x, rng, avoid=_PROTECTED)
    if idx is None:
        return x
    neighbour = rng.choice(EUCLIDEAN_NEIGHBOURS[x[idx]])
    return x[:idx] + neighbour + x[idx:]


def replace_letter(x: str, rng: random.Random) -> str:
    idx = _pick_letter_index(x, rng, avoid=_PROTECTED)
    if idx is None:
        return x
    neighbour = rng.choice(EUCLIDEAN_NEIGHBOURS[x[idx]])
    return x[:idx] + neighbour + x[idx + 1 :]


def add_space(x: str, rng: random.Random) -> str:
    length = len(x)

    def bad(i: int) -> bool:
        return x[i] == " " or x[i - 1 : i] in ("", " ") or x[i + 1 : i + 2] in ("", " ")

    idx = rng.randint(1, length - 1)
    tries = 0
    while bad(idx):
        tries += 1
        if tries > _MAX_RETRIES:
            return x
        idx = rng.randint(1, length - 1)
    return x[:idx] + " " + x[idx:]


def remove_space(x: str, rng: random.Random) -> str:
    spaces = [i for i, ch in enumerate(x) if ch == " "]
    if not spaces:
        return x
    idx = rng.choice(spaces)
    return x[:idx] + x[idx + 1 :]


def swap_word(x: str, rng: random.Random) -> str:
    words = x.split()
    idx = list(range(len(words)))
    a, b = rng.choice(idx), rng.choice(idx)
    words[a], words[b] = words[b], words[a]
    return " ".join(words)


def generate_misspelled_name(title: str, rng: random.Random) -> str:
    """Apply 1-2 random mutations and re-normalize."""
    ops = [
        rng.choice([swap_word, add_letter, remove_letter]),
        replace_letter,
        rng.choice([add_space, remove_space]),
    ]
    selected = rng.sample(ops, rng.randint(1, 2))
    out = str(title)
    for op in selected:
        out = op(out, rng)
    return transform_title(out)
