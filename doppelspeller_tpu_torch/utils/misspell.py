"""Synthetic misspelling generator.

The JAX package's ``utils/misspell.py``: QWERTY-adjacent letter insert and
replace, letter and space removal, space insertion, word swap, 1-2 random
operations per title.  Every draw goes through the given ``random.Random``
in the same order, so one seed gives the same misspellings in both packages.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

from doppelspeller_tpu_torch.utils.text import transform_title

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
