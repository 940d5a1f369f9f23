"""Configuration for the PyTorch port of the matcher.

Field-for-field the JAX package's ``Config`` (same names, same defaults, same
validation), so a configuration written for one package runs the other.  The
port reads the fields on its path (the index build, retrieval, fuzzy, model
stage, the cascade knobs, ``serve_fused`` and ``fuzzy_tile_cap``, and
``dispatch_blocks``: retrieval's group of query blocks, one upload each,
on one device and on a mesh, as in the JAX package's ``topk_device`` and
``shard_map`` programs).  Fields that only shape the TPU
programs are kept so configurations stay interchangeable, and the port
ignores them:

``window_impl``, ``retrieval_impl``, ``topk_recall_target``,
``fold_recall_target`` (the port's top-k is exact), ``pallas_union_chunk``,
``pair_block``, ``rerank_chunk_cap``, ``mesh_axis``.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field, replace
from typing import Tuple


def _default_data_path() -> str:
    path = os.environ.get("PROJECT_DATA_PATH")
    if not path:
        path = os.path.abspath("./data/")
        warnings.warn(
            f"Environment variable PROJECT_DATA_PATH not set! Using {path} as default!"
        )
    return os.path.abspath(path)


# Post-transform character alphabet; index 0 is the pad character.
ALPHABET = "- abcdefghijklmnopqrstuvwxyz0123456789"
PAD_CODE = 0
SPACE_CODE = 1
# characters that can appear in a transformed title ([a-z0-9] and space);
# every trigram over them has a static id in a vocabulary of 37**3
N_TEXT_CHARS = 37
TRIGRAM_VOCAB_SIZE = N_TEXT_CHARS ** 3  # 50653


@dataclass(frozen=True)
class Config:
    # ---- paths / IO ----
    data_path: str = field(default_factory=_default_data_path)
    ground_truth_file: str = "example_truth.csv"
    train_file: str = "example_train.csv"
    test_file: str = "example_test.csv"
    test_with_actuals_file: str = "example_test_with_actuals.csv"
    final_output_file: str = "final_output.csv"
    model_file: str = "model.npz"
    index_file: str = "index.npz"
    delimiter: str = "|"
    truth_id_column: str = "company_id"
    truth_title_column: str = "name"
    train_index_column: str = "train_index"
    test_index_column: str = "test_index"

    # ---- text / n-grams ----
    n_grams: int = 3
    max_characters: int = 255
    number_of_words_features: int = 15

    # ---- retrieval ----
    top_n_training: int = 10
    top_n_predicting: int = 100

    # ---- thresholds ----
    levenshtein_ratio_threshold: int = 94
    prediction_probability_threshold: float = 0.9
    false_positive_penalty_factor: float = 5.0
    train_not_found_value: int = -1

    # ---- training ----
    evaluation_fraction_generated: float = 0.05
    evaluation_fraction_negative: float = 0.1
    evaluation_fraction_positive: float = 0.05
    gbt_max_depth: int = 5
    gbt_eta: float = 0.1
    gbt_min_child_weight: float = 1.0
    gbt_num_boost_round: int = 1000
    gbt_early_stopping_rounds: int = 50
    gbt_lambda: float = 1.0
    gbt_max_bins: int = 256
    seed: int = 0

    # ---- execution knobs ----
    # coarse-pass weight dtype: "bfloat16" rounds the folded weights to bf16
    # and accumulates in f32; "float32" is true f32 (TF32 off)
    score_dtype: str = "bfloat16"
    window_impl: str = "auto"            # ignored by the port
    retrieval_impl: str = "auto"         # ignored by the port
    # fused per-window pre-selection in the scoring kernel (kernel A); off,
    # the exact path scores the full matrix (kernel D) and takes its top-k
    retrieval_window_select: bool = True
    # "auto" → folded at >= folded_min_titles titles (given the truth
    # encodings), exact below; "folded" and "exact" force one engine
    retrieval_mode: str = "auto"
    fold_dim: int = 512
    fold_hashes: int = 2
    rescore_depth: int = 128
    fold_recall_target: float = 0.95     # ignored: the port's select is exact
    folded_min_titles: int = 200_000
    fold_query_block: int = 0            # 0 → query_block
    fold_select_window: int = 0          # 0 → max(tb // 128, 1)
    # "auto" → the device build on a CUDA device, the host build on the
    # CPU; "device" / "host" force one (ngram_index.index_build_impl)
    index_build_impl: str = "auto"
    topk_recall_target: float = 0.99     # ignored: the port's select is exact
    query_block: int = 128
    max_query_trigrams: int = 64
    title_block: int = 32768
    union_buckets: Tuple[int, ...] = (1024, 1536, 2048, 3072, 4096, 6144, 8192)
    dispatch_blocks: int = 32
    pallas_union_chunk: int = 2048
    pair_block: int = 8192
    # rows per stage-3 slab
    model_slab: int = 2048
    # adaptive candidate depth (waves A/B), see the JAX package's Config
    model_depth_initial: int = 32
    model_widen_threshold: float = 0.3
    model_trust_threshold: float = 0.995
    # nonzero caps the device fuzzy tile at the widest length bucket within
    # it; rows with a considered pair past the tile go to the host stage
    fuzzy_tile_cap: int = 0
    rerank_chunk_cap: int = 512
    length_buckets: Tuple[int, ...] = (32, 64, 128, 256)
    mesh_axis: str = "titles"
    # "device": adaptive-depth waves A/B at every size; "host": every
    # candidate scored; "auto": waves at >= 2,048 rows past the exact stage
    cascade_impl: str = "auto"
    # "auto": a batch of at most one query block takes the one-dispatch path
    # (a CUDA graph on the card); "off": the staged path
    serve_fused: str = "auto"

    def __post_init__(self):
        if self.top_n_training > self.top_n_predicting:
            raise ValueError(
                "top_n_training cannot be greater than top_n_predicting"
            )
        if self.n_grams != 3:
            raise ValueError("only 3-grams are supported (fixed trigram vocab)")
        if self.max_characters > 255:
            raise ValueError("titles are limited to 255 chars (uint8 encoding)")

    # -- derived paths --
    def path(self, name: str) -> str:
        return os.path.join(self.data_path, name)

    @property
    def ground_truth_path(self) -> str:
        return self.path(self.ground_truth_file)

    @property
    def train_path(self) -> str:
        return self.path(self.train_file)

    @property
    def test_path(self) -> str:
        return self.path(self.test_file)

    @property
    def test_with_actuals_path(self) -> str:
        return self.path(self.test_with_actuals_file)

    @property
    def final_output_path(self) -> str:
        return self.path(self.final_output_file)

    @property
    def model_path(self) -> str:
        return self.path(self.model_file)

    @property
    def index_path(self) -> str:
        return self.path(self.index_file)

    def with_(self, **kwargs) -> "Config":
        return replace(self, **kwargs)


_DEFAULT: Config | None = None


def get_config() -> Config:
    """The process's configuration: ``set_config``'s, else a default
    ``Config()`` (built on first use, so ``PROJECT_DATA_PATH`` is read then)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Config()
    return _DEFAULT


def set_config(config: Config) -> None:
    global _DEFAULT
    _DEFAULT = config
