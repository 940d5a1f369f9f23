"""The bench's synthetic world: company-name-like titles with known truth.

The same generator as the JAX package's ``bench.make_synthetic_world``
(without its on-disk cache): one ``random.Random(seed)`` stream draws the
stems, the titles and the queries in the same order, so a seed gives the
same titles, queries and ``q_actual`` in both packages.  Queries are ~10 %
exact copies, ~60 % misspelled truth titles and ~30 % titles not in truth
(``q_actual`` −1).
"""

from __future__ import annotations

import random
import string
from typing import Optional, Tuple

import numpy as np

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.utils.io import TitleSet
from doppelspeller_tpu_torch.utils.misspell import generate_misspelled_name

COMMON_WORDS = (
    "limited", "ltd", "holdings", "group", "services", "international",
    "solutions", "consulting", "partners", "industries", "systems",
    "technologies", "ventures", "capital", "global", "management",
)


def make_synthetic_world(
    n_titles: int, n_queries: int, seed: int = 7, config: Optional[Config] = None,
) -> Tuple[Config, TitleSet, TitleSet, np.ndarray]:
    """Returns (config, truth, queries, q_actual int64[n_queries]); truth ids
    are 1..n_titles."""
    cfg = config or Config()
    rng = random.Random(seed)
    stems = [
        "".join(rng.choice(string.ascii_lowercase) for _ in range(rng.randint(4, 10)))
        for _ in range(max(n_titles // 12, 1000))
    ]
    common = list(COMMON_WORDS)

    def make_title() -> str:
        n_words = rng.randint(1, 3)
        words = [rng.choice(stems) for _ in range(n_words)]
        if rng.random() < 0.75:
            words.append(rng.choice(common))
        if rng.random() < 0.15:
            words.append(str(rng.randint(1, 99)))
        return " ".join(words)

    titles = [make_title() for _ in range(n_titles)]
    truth = TitleSet.from_titles(
        titles, ids=np.arange(1, n_titles + 1, dtype=np.int64), config=cfg
    )
    q_titles, q_actual = [], []
    for _ in range(n_queries):
        r = rng.random()
        if r < 0.10:
            j = rng.randrange(n_titles)
            q_titles.append(titles[j])
            q_actual.append(j + 1)
        elif r < 0.70:
            j = rng.randrange(n_titles)
            q_titles.append(generate_misspelled_name(truth.transformed[j], rng))
            q_actual.append(j + 1)
        else:
            q_titles.append(make_title())
            q_actual.append(-1)
    queries = TitleSet.from_titles(
        q_titles, ids=np.arange(n_queries, dtype=np.int64), config=cfg
    )
    return cfg, truth, queries, np.asarray(q_actual, dtype=np.int64)
