"""PyTorch port: the tile rules (``ops/tiles.py``) and the package's layering.

The fuzzy tile bound is held to the length-delta prefilter it stands for
(``pipeline.Matcher._stage_fuzzy``'s rule), brute-forced over every query
and truth length a title can have; the grids, LQ and the query block to the
values the modules wrote inline before.  The layering test reads each
module below the cascade and asserts that none imports the cascade
(``pipeline``) or the command line (``cli``).
"""

import ast
import math
import pathlib

import numpy as np
import pytest

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.ops import tiles
from doppelspeller_tpu_torch.utils.text import BIG_TRIGRAM

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "doppelspeller_tpu_torch"
LOWER = sorted(p for d in ("ops", "parallel", "models", "utils") for p in (PACKAGE / d).glob("*.py"))
UPPER = {"doppelspeller_tpu_torch.pipeline", "doppelspeller_tpu_torch.cli"}


def _imported(tree: ast.AST):
    """Every module an ``import`` or ``from … import`` names, with each name
    a ``from`` imports taken as a module too."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", LOWER, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_lower_layers_import_no_upper_layer(path):
    names = set(_imported(ast.parse(path.read_text(), str(path))))
    assert not any(n == u or n.startswith(u + ".") for n in names for u in UPPER), sorted(names)
    assert not any(isinstance(n, ast.ImportFrom) and n.level for n in ast.walk(ast.parse(path.read_text())))


@pytest.mark.parametrize("thr", [90, 94, 99])
def test_fuzzy_tile_bound_holds_every_considered_length(thr):
    """For every query length 0–255: every truth length up to 255 that the
    prefilter considers lies within the bound, and the bound is
    ⌈q·(200−thr)/thr⌉ capped at 255."""
    cfg = Config(levenshtein_ratio_threshold=thr)
    L = cfg.max_characters
    q = np.arange(256, dtype=np.int64)
    bound = tiles.fuzzy_tile_bound(q, cfg)
    t = np.arange(256, dtype=np.int64)
    tot = q[:, None] + t[None, :]
    delta = np.abs(q[:, None] - t[None, :])
    consider = (tot - delta) / np.maximum(tot, 1) * 100.0 >= thr
    qi, ti = np.nonzero(consider)
    assert len(qi) > 1000
    assert (t[ti] <= bound[qi]).all()
    assert bound.tolist() == [min(math.ceil(n * (200 - thr) / thr), L) for n in range(256)]


@pytest.mark.parametrize("width", [255, 128, 64, 40, 8])
def test_grids(width):
    cfg = Config()
    assert tiles.title_grid(cfg, width) == [b for b in (32, 64, 128, 256) if b < width] + [width]
    assert tiles.device_word_grid(width) == [b for b in (16, 32, 64) if b < width] + [width]
    assert tiles.host_word_grid(width) == [b for b in (8, 16, 32, 64) if b < width] + [width]
    assert tiles.host_word_grid(width, every=True) == [8, 16, 32, 64, width]


@pytest.mark.parametrize("fold_query_block", [0, 16])
def test_query_block(fold_query_block):
    cfg = Config(query_block=128, fold_query_block=fold_query_block)
    assert tiles.query_block(cfg, folded=False) == 128
    assert tiles.query_block(cfg, folded=True) == (fold_query_block or 128)


@pytest.mark.parametrize("need,lq", [(0, 64), (1, 64), (64, 64), (65, 128), (128, 128), (129, 253),
                                     (253, 253), (300, 253)])
def test_trigram_block(need, lq):
    """LQ is the smallest of (max_query_trigrams, 128, 253) holding the most
    trigrams of a query (253 past them all); narrower ids are padded to it."""
    width = max(need, 5)
    ids = np.full((3, width), BIG_TRIGRAM, np.int32)
    ids[1, :need] = np.arange(need)
    out, got = tiles.trigram_block(ids, Config(max_query_trigrams=64))
    assert got == lq
    assert out.shape == (3, max(width, lq)) and out.dtype == np.int32
    np.testing.assert_array_equal(out[:, :width], ids)
    assert (out[:, width:] == BIG_TRIGRAM).all()
