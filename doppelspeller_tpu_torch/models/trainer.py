"""Training pipeline: assemble pairs → features → boosted trees.

The JAX package's ``models/trainer.py`` on one device (the card unless the
caller names the CPU) or a mesh (``parallel/sharded.py``):

* GENERATED pairs: every truth title with a transformed length > 9 is
  misspelled once → target 1;
* candidate retrieval: the exact top-``top_n_predicting`` weighted-Jaccard
  candidates of every train row, ``top_n_training`` of them sampled;
* NEGATIVE pairs: rows labelled −1 → the sampled candidates, target 0;
* POSITIVE pairs: labelled rows → the sampled candidates with the true
  label forced into the set (replacing the last), target = (candidate ==
  label);
* evaluation split: per-kind random subsets whose sizes are the configured
  fractions of the *total* row count;
* boosting with the custom weighted objective and early stopping on the
  custom error.

Every random draw comes from ``random.Random(cfg.seed)`` and
``np.random.RandomState(cfg.seed)``, in the reference's order, so a seed
gives the same pairs and the same split in both packages wherever retrieval
returns the same candidates in the same order.
"""

from __future__ import annotations

import logging
import random
import time
from collections import Counter
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from doppelspeller_tpu_torch import constants as c
from doppelspeller_tpu_torch.config import Config, get_config
from doppelspeller_tpu_torch.device import resolve_device, synchronize
from doppelspeller_tpu_torch.models.gbt import GBTModel, GBTParams, custom_error, train_gbt
from doppelspeller_tpu_torch.ops.features import features_for_pairs
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
from doppelspeller_tpu_torch.utils import text as T
from doppelspeller_tpu_torch.utils.io import TitleSet, load_ground_truth, load_train_data
from doppelspeller_tpu_torch.utils.misspell import generate_misspelled_name

LOGGER = logging.getLogger(__name__)


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

    def for_titles(self, titles: List[str]) -> np.ndarray:
        return np.stack([self.for_title(t) for t in titles])

    def matrix(self, titles: List[str]) -> np.ndarray:
        """uint32[len(titles), 15] — computed once, gathered per pair."""
        return self.for_titles(titles)


@dataclass
class TrainingPairs:
    kind: np.ndarray          # uint8[M] TRAINING_KIND_*
    target: np.ndarray        # float32[M]
    pair_q: np.ndarray        # int32[M] indices into q_titles
    t_pos: np.ndarray         # int32[M] truth row positions
    q_titles: List[str]       # UNIQUE transformed query-side titles


def assemble_training_pairs(
    train: TitleSet,
    truth: TitleSet,
    scorer: JaccardScorer,
    config: Config,
    rng: Optional[random.Random] = None,
) -> TrainingPairs:
    cfg = config
    rng = rng or random.Random(cfg.seed)

    # the truth side of every pair is a truth ROW: candidates come back as
    # positions, labels map through id → position, and generated pairs
    # misspell row p itself
    pos_of_id = {int(i): p for p, i in enumerate(truth.ids)}

    kinds: List[int] = []
    targets: List[float] = []
    pair_q: List[int] = []
    t_pos: List[int] = []
    q_titles: List[str] = []
    q_index: dict = {}

    def q_id(title: str) -> int:
        j = q_index.get(title)
        if j is None:
            j = len(q_titles)
            q_index[title] = j
            q_titles.append(title)
        return j

    # --- NEGATIVE + POSITIVE: retrieval candidates for every train row ---
    LOGGER.info("Retrieving top-%d candidates for %d train rows",
                cfg.top_n_predicting, len(train))
    _, cand_pos = scorer.topk(train, k=cfg.top_n_predicting)

    n_sample = cfg.top_n_training
    for row in range(len(train)):
        label = int(train.labels[row])
        # sample() draws by list position, so the candidates' order feeds the pairs
        cands = rng.sample(list(cand_pos[row]), n_sample)
        qi = q_id(train.transformed[row])
        if label == cfg.train_not_found_value:
            for cp in cands:
                kinds.append(c.TRAINING_KIND_NEGATIVE)
                targets.append(0.0)
                pair_q.append(qi)
                t_pos.append(int(cp))
        else:
            label_pos = pos_of_id[label]
            if label_pos not in [int(x) for x in cands]:
                if len(cands) == n_sample:
                    cands.pop()
                cands.append(label_pos)
            for cp in cands:
                kinds.append(c.TRAINING_KIND_POSITIVE)
                targets.append(1.0 if int(cp) == label_pos else 0.0)
                pair_q.append(qi)
                t_pos.append(int(cp))

    # --- GENERATED: misspell every truth title longer than 9 chars ---
    LOGGER.info("Generating misspelled training data")
    for p, t in enumerate(truth.transformed):
        if len(t) > 9:
            kinds.append(c.TRAINING_KIND_GENERATED)
            targets.append(1.0)
            pair_q.append(q_id(generate_misspelled_name(t, rng)))
            t_pos.append(p)

    return TrainingPairs(
        kind=np.asarray(kinds, dtype=np.uint8),
        target=np.asarray(targets, dtype=np.float32),
        pair_q=np.asarray(pair_q, dtype=np.int32),
        t_pos=np.asarray(t_pos, dtype=np.int32),
        q_titles=q_titles,
    )


def evaluation_indexes(kind: np.ndarray, config: Config, seed: Optional[int] = None) -> np.ndarray:
    """Per-kind evaluation samples whose sizes are fractions of the TOTAL
    row count (the reference's quirk), clipped to the kind's size."""
    cfg = config
    rs = np.random.RandomState(cfg.seed if seed is None else seed)
    total = len(kind)
    picks = []
    for k, frac in (
        (c.TRAINING_KIND_GENERATED, cfg.evaluation_fraction_generated),
        (c.TRAINING_KIND_NEGATIVE, cfg.evaluation_fraction_negative),
        (c.TRAINING_KIND_POSITIVE, cfg.evaluation_fraction_positive),
    ):
        cand = np.flatnonzero(kind == k)
        size = min(int(total * frac), len(cand))
        if size > 0:
            picks.append(rs.choice(cand, size=size, replace=False))
    if not picks:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(picks))


def build_feature_matrix(pairs: TrainingPairs, word_counts: WordCounts, truth: TitleSet,
                         config: Config, device="cuda") -> np.ndarray:
    """float32[M, 66] features of the pairs: the unique query encodings and
    the truth-side tables go to the device once, then each chunk sends only
    (query row, truth row) index pairs."""
    cfg = config
    q_enc = T.encode_titles(pairs.q_titles, cfg.max_characters)
    q_len = np.array([min(len(t), cfg.max_characters) for t in pairs.q_titles], np.int32)
    counts = word_counts.matrix(truth.transformed)
    LOGGER.info("Constructing features for %d pairs (%d unique queries)",
                len(pairs.kind), len(pairs.q_titles))
    return features_for_pairs(
        pairs.pair_q, pairs.t_pos, q_enc, q_len,
        truth.encoded, np.minimum(truth.lengths, cfg.max_characters).astype(np.int32),
        counts, cfg, device,
    )


def error_matrix(pred: np.ndarray, target: np.ndarray, threshold: float):
    """(TP, TN, FP, FN) at the probability threshold."""
    pos = pred > threshold
    tp = int(((target == 1) & pos).sum())
    tn = int(((target == 0) & ~pos).sum())
    fp = int(((target == 0) & pos).sum())
    fn = int(((target == 1) & ~pos).sum())
    return tp, tn, fp, fn


def train_model(
    config: Optional[Config] = None,
    train: Optional[TitleSet] = None,
    truth: Optional[TitleSet] = None,
    scorer: Optional[JaccardScorer] = None,
    params: Optional[GBTParams] = None,
    save: bool = True,
    device="cuda",
    mesh=None,
) -> Tuple[GBTModel, dict]:
    """End-to-end training on ``device``.  Returns the model and a report
    dict (error matrix, eval custom error, feature importance, history,
    pair counts, timings).  ``save`` writes the model to
    ``config.model_path``.

    ``config`` defaults to ``get_config()``, ``truth`` and ``train`` to
    the CSV files it names.  Candidate retrieval is exact at any size: the
    scorer is built without the truth encodings, which only the folded
    engine needs.

    ``mesh`` (``parallel.sharded.Mesh``; ``device`` is then its first
    device): retrieval over the title-sharded index and data-parallel
    boosting (``train_gbt(mesh=)``); the features are computed on the first
    device."""
    cfg = config or get_config()
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)

    def clock() -> float:
        synchronize(dev)
        return time.time()

    timings = {}
    t0 = clock()
    truth = truth or load_ground_truth(cfg)
    train = train or load_train_data(cfg)
    own_scorer = scorer is None
    if own_scorer and mesh is not None:
        from doppelspeller_tpu_torch.parallel.sharded import ShardedJaccardScorer

        scorer = ShardedJaccardScorer(build_truth_index(truth, cfg, dev), mesh, cfg)
    elif own_scorer:
        scorer = JaccardScorer(build_truth_index(truth, cfg, dev), cfg, dev)
    timings["setup_seconds"] = clock() - t0

    rng = random.Random(cfg.seed)
    t0 = clock()
    pairs = assemble_training_pairs(train, truth, scorer, cfg, rng)
    if own_scorer:
        scorer.close()
    timings["candidates_seconds"] = clock() - t0
    kind_counts = {
        "generated": int((pairs.kind == c.TRAINING_KIND_GENERATED).sum()),
        "negative": int((pairs.kind == c.TRAINING_KIND_NEGATIVE).sum()),
        "positive": int((pairs.kind == c.TRAINING_KIND_POSITIVE).sum()),
    }
    LOGGER.info("Assembled %d pairs (generated %d / negative %d / positive %d)",
                len(pairs.kind), kind_counts["generated"], kind_counts["negative"],
                kind_counts["positive"])

    word_counts = WordCounts(truth)
    t0 = clock()
    X = build_feature_matrix(pairs, word_counts, truth, cfg, dev)
    timings["features_seconds"] = clock() - t0
    y = pairs.target

    eval_idx = evaluation_indexes(pairs.kind, cfg)
    train_mask = np.ones(len(y), dtype=bool)
    train_mask[eval_idx] = False
    X_train, y_train = X[train_mask], y[train_mask]
    X_eval, y_eval = X[eval_idx], y[eval_idx]
    LOGGER.info("Train %d rows / eval %d rows", len(y_train), len(y_eval))

    params = params or GBTParams.from_config(cfg)
    t0 = clock()
    model = train_gbt(X_train, y_train, X_eval, y_eval, params, device=dev, mesh=mesh)
    timings["boosting_seconds"] = clock() - t0
    LOGGER.info(
        "train timings: setup %.1fs | candidates %.1fs | features %.1fs | boosting %.1fs",
        timings["setup_seconds"], timings["candidates_seconds"],
        timings["features_seconds"], timings["boosting_seconds"],
    )

    pred_eval = model.predict(X_eval, device=dev)
    tp, tn, fp, fn = error_matrix(pred_eval, y_eval, cfg.prediction_probability_threshold)
    LOGGER.info(
        "\n\nEvaluation Data Error Matrix:\n"
        "    True Positives     %d\n"
        "    True Negatives     %d\n"
        "    False Positives    %d\n"
        "    False Negatives    %d\n",
        tp, tn, fp, fn,
    )
    report = {
        "error_matrix": {"tp": tp, "tn": tn, "fp": fp, "fn": fn},
        "eval_custom_error": custom_error(
            pred_eval, y_eval, cfg.false_positive_penalty_factor,
            cfg.prediction_probability_threshold,
        ),
        "feature_importance": model.feature_importance(),
        "history": model.history,
        "n_pairs": len(y),
        "pairs_by_kind": kind_counts,
        "n_train_rows": int(len(y_train)),
        "n_eval_rows": int(len(y_eval)),
        "timings": timings,
    }
    if save:
        model.save(cfg.model_path)
        LOGGER.info("Model saved to %s", cfg.model_path)
    return model, report
