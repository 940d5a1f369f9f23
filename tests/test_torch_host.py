"""PyTorch port, host layer: config, text codec, TitleSet, misspeller,
synthetic world, index statistics, fold maps and the resident folded and
trigram-list matrices, each held equal to the JAX package."""

import dataclasses
import os
import pathlib
import random
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from doppelspeller_tpu.config import Config as JConfig
from doppelspeller_tpu.ops import fold as jfold
from doppelspeller_tpu.ops.ngram_index import build_truth_index as j_build_index
from doppelspeller_tpu.utils import text as JT
from doppelspeller_tpu.utils.io import TitleSet as JTitleSet
from doppelspeller_tpu.utils.misspell import generate_misspelled_name as j_misspell
from doppelspeller_tpu_torch import synthetic
from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.ops import fold
from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
from doppelspeller_tpu_torch.utils import text as T
from doppelspeller_tpu_torch.utils.io import TitleSet
from doppelspeller_tpu_torch.utils.misspell import generate_misspelled_name

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "doppelspeller_tpu_torch"


@pytest.fixture(scope="module")
def small_world():
    cfg, truth, queries, actual = synthetic.make_synthetic_world(3000, 400)
    return cfg.with_(title_block=2048), truth, queries, actual


def test_config_fields_and_defaults_equal():
    fj = {f.name: f for f in dataclasses.fields(JConfig)}
    fp = {f.name: f for f in dataclasses.fields(Config)}
    assert list(fj) == list(fp)
    cj = JConfig(data_path="/tmp/x")
    cp = Config(data_path="/tmp/x")
    for name in fj:
        assert getattr(cj, name) == getattr(cp, name), name


def test_titleset_encodings_equal_native():
    rng = random.Random(3)
    titles = [
        "Coolblue B.V.", "  Heyside -- Cricket   Club ", "Zoë Café & Co", "ab",
        "tab\tseparated\nline", "x" * 300, "International House Newcastle 42",
        "", "ÅÄÖ åäö", "a-b-c-d",
    ]
    for _ in range(200):
        titles.append(" ".join(
            "".join(rng.choice("abcdefghijklmnopqrstuvwxyz0123456789-.,") for _ in range(rng.randint(1, 12)))
            for _ in range(rng.randint(1, 5))))
    cfg = Config(data_path="/tmp/x")
    tj = JTitleSet.from_titles(titles, config=JConfig(data_path="/tmp/x"))
    tp = TitleSet.from_titles(titles, config=cfg)
    assert tj.transformed == tp.transformed
    np.testing.assert_array_equal(tj.encoded, tp.encoded)
    np.testing.assert_array_equal(tj.lengths, tp.lengths)
    for a, b in zip(tj.encoded_wo + tj.encoded_token_sorted, tp.encoded_wo + tp.encoded_token_sorted):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tj.trigram_ids(), tp.trigram_ids())
    for i in range(0, len(titles), 7):
        np.testing.assert_array_equal(JT.trigram_ids_from_codes(tj.encoded[i], int(tj.lengths[i])),
                                      T.trigram_ids_from_codes(tp.encoded[i], int(tp.lengths[i])))


def test_misspeller_consumes_the_same_stream():
    base = ["coolblue bv", "international house newcastle", "heyside cricket club 7", "a b"]
    rj, rp = random.Random(9), random.Random(9)
    for i in range(300):
        t = base[i % len(base)]
        assert j_misspell(t, rj) == generate_misspelled_name(t, rp)
    assert rj.random() == rp.random()


def test_synthetic_world_equals_bench():
    _, tj, qj, aj = bench.make_synthetic_world(3000, 400)
    _, tp, qp, ap = synthetic.make_synthetic_world(3000, 400)
    assert tj.titles == tp.titles
    assert qj.titles == qp.titles
    np.testing.assert_array_equal(aj, ap)
    np.testing.assert_array_equal(tj.ids, tp.ids)


def test_index_statistics_and_fold_maps_equal(small_world):
    cfg, truth, *_ = small_world
    jtruth = JTitleSet.from_titles(truth.titles, ids=truth.ids, config=JConfig(data_path="/tmp/x"))
    ij = j_build_index(jtruth, JConfig(data_path="/tmp/x", title_block=2048))
    ip = build_truth_index(truth, cfg)
    np.testing.assert_array_equal(ij.df, ip.df)
    np.testing.assert_array_equal(ij.idf, ip.idf)
    np.testing.assert_array_equal(ij.sums, ip.sums)
    np.testing.assert_array_equal(ij.title_ids, ip.title_ids)
    assert (ij.num_titles, ij.padded_titles, ij.max_idf) == (ip.num_titles, ip.padded_titles, ip.max_idf)
    for seed in (0, 1):
        np.testing.assert_array_equal(jfold.build_fold_map(ij.df, 512, seed=seed),
                                      fold.build_fold_map(ip.df, 512, seed=seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_folded_and_trigram_list_matrices_equal_device_builders(small_world, seed):
    cfg, truth, *_ = small_world
    ip = build_truth_index(truth, cfg)
    fm = fold.build_fold_map(ip.df, 512, seed=seed)
    mc_j = np.asarray(jfold.build_folded_matrix(truth.encoded, truth.lengths, fm, 512, ip.padded_titles))
    mc_p = fold.build_folded_matrix(truth.encoded, truth.lengths, fm, 512, ip.padded_titles, "cpu")
    np.testing.assert_array_equal(mc_j, mc_p.numpy())
    tl_j, ltw_j = jfold.build_trigram_list_matrix(truth.encoded, truth.lengths, ip.padded_titles)
    tl_p, ltw_p = fold.build_trigram_list_matrix(truth.encoded, truth.lengths, ip.padded_titles, "cpu")
    assert ltw_j == ltw_p
    np.testing.assert_array_equal(np.asarray(tl_j).astype(np.int32), tl_p.numpy())


def test_plan_id_blocks_equal(small_world):
    cfg, _, queries, _ = small_world
    jq = JTitleSet.from_titles(queries.titles, config=JConfig(data_path="/tmp/x"))
    jcfg = JConfig(data_path="/tmp/x", query_block=64)
    rows = np.arange(5, 300, 2)
    pj = jfold.plan_id_blocks(jq, jcfg, rows=rows)
    pp = fold.plan_id_blocks(queries, cfg.with_(query_block=64), rows=rows)
    assert len(pj) == len(pp)
    for a, b in zip(pj, pp):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.query_rows, b.query_rows)


def test_package_never_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|doppelspeller_tpu)\b", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pattern.search(p.read_text())]
    assert offenders == []
    code = ("import sys, doppelspeller_tpu_torch.pipeline, doppelspeller_tpu_torch.synthetic; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'doppelspeller_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env, timeout=120)


def test_cuda_device_without_cuda_raises():
    from doppelspeller_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device(None)


@pytest.mark.parametrize("entry", ["Matcher", "JaccardScorer", "ExactEngine"])
def test_entry_points_default_to_the_card(small_world, entry):
    """Without a device, the entry points and the engines they build target
    CUDA; where there is none they raise, with no CPU fallback."""
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.ops.jaccard import ExactEngine, JaccardScorer
    from doppelspeller_tpu_torch.pipeline import Matcher
    from test_torch_helpers import MODEL

    cfg, truth, _queries, _actual = small_world

    def build():
        if entry == "Matcher":
            return Matcher(cfg, truth, GBTModel.load(str(MODEL))).device
        if entry == "JaccardScorer":
            return JaccardScorer(build_truth_index(truth, cfg), cfg, truth=truth).device
        return ExactEngine(build_truth_index(truth, cfg), cfg, tb=2048).packed.device

    if torch.cuda.is_available():
        assert build().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
