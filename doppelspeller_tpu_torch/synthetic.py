"""The bench's synthetic world: company-name-like titles with known truth.

The same generator as the JAX package's ``bench.make_synthetic_world``
(without its on-disk cache): one ``random.Random(seed)`` stream draws the
stems, the titles and the queries in the same order, so a seed gives the
same titles, queries and ``q_actual`` in both packages.  Queries are ~10 %
exact copies, ~60 % misspelled truth titles and ~30 % titles not in truth
(``q_actual`` −1).

``quick_train_model`` is the bench's small-but-real training run on such a
world, on the rows of ``quick_train_rows``: the bench's own draws, so both
packages train on the same rows.
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


def quick_train_rows(cfg: Config, truth: TitleSet) -> Tuple[TitleSet, TitleSet]:
    """(truth subset, train rows) of the bench's quick training run, the JAX
    package's ``bench.quick_train_model`` draw for draw: the first 50,000
    titles of a larger truth DB (the model does not depend on the index
    size) and min(2000, titles) train rows from ``random.Random(13)``, half
    of them misspelled truth titles and half two random 6-letter words
    labelled not-found."""
    rng = random.Random(13)
    if len(truth) > 50_000:
        truth = TitleSet.from_titles(truth.titles[:50_000], ids=truth.ids[:50_000], config=cfg)
    n_train = min(2000, len(truth))
    rows = rng.sample(range(len(truth)), n_train)
    t_titles, labels = [], []
    for j in rows[: n_train // 2]:
        t_titles.append(generate_misspelled_name(truth.transformed[j], rng))
        labels.append(int(truth.ids[j]))
    for _ in range(n_train // 2):
        t_titles.append(" ".join(
            "".join(rng.choice(string.ascii_lowercase) for _ in range(6)) for _ in range(2)))
        labels.append(-1)
    train = TitleSet.from_titles(
        t_titles, ids=np.arange(len(t_titles)), labels=np.asarray(labels), config=cfg)
    return truth, train


def quick_train_model(cfg: Config, truth: TitleSet, rounds: int, device="cuda"):
    """Train a small but real model on synthetic pairs, on ``device``: the
    rows of ``quick_train_rows``, ``rounds`` boosting rounds with early
    stopping as late as the last round.  Returns ``train_model``'s
    (model, report); the report holds the phase timings and the pair
    counts."""
    from doppelspeller_tpu_torch.models.gbt import GBTParams
    from doppelspeller_tpu_torch.models.trainer import train_model

    truth, train = quick_train_rows(cfg, truth)
    params = GBTParams.from_config(cfg)
    params.num_boost_round = rounds
    params.early_stopping_rounds = rounds
    return train_model(cfg, train=train, truth=truth, params=params, save=False, device=device)
