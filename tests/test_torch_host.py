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
from doppelspeller_tpu_torch.ops import fold, index_device
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
    ids, _ = index_device.build_shard(truth.encoded, truth.lengths, "cpu",
                                      index_device.ids_width(truth.lengths))
    mc_p = fold.build_folded_matrix(ids, fm, 512, ip.padded_titles)
    np.testing.assert_array_equal(mc_j, mc_p.numpy())
    tl_j, ltw_j = jfold.build_trigram_list_matrix(truth.encoded, truth.lengths, ip.padded_titles)
    tl_p, ltw_p = fold.build_trigram_list_matrix(ids, ip.padded_titles)
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
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|doppelspeller_tpu|bench)\b", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert offenders == []
    code = ("import sys, doppelspeller_tpu_torch.pipeline, doppelspeller_tpu_torch.synthetic, "
            "doppelspeller_tpu_torch.cli; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'doppelspeller_tpu', 'bench')]; "
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


# ------------------------------------------------------------- CSV loaders

TRICKY_NAMES = [
    "Coolblue B.V.", "", "NA", "N/A", "NULL", "None", "nan", "NaN", "#N/A", "<NA>", "n/a",
    "null", '"quoted | with the delimiter"', '"doubled ""quotes"" inside"', '"two\nlines"',
    "a\"quote in the middle", " leading and trailing spaces ", "Zoë Café & Co", "12345",
]


def _write(path, header, rows):
    with open(path, "w", newline="") as f:
        f.write(header + "\n" + "".join(r + "\n" for r in rows))


def _loader_configs(tmp_path):
    from doppelspeller_tpu.utils import io as jio
    from doppelspeller_tpu_torch.utils import io as pio

    return jio, pio, JConfig(data_path=str(tmp_path)), Config(data_path=str(tmp_path))


def _assert_same_titleset(tj, tp):
    assert tj.titles == tp.titles
    assert tj.transformed == tp.transformed
    np.testing.assert_array_equal(tj.ids, tp.ids)
    np.testing.assert_array_equal(tj.encoded, tp.encoded)
    np.testing.assert_array_equal(tj.lengths, tp.lengths)
    assert (tj.labels is None) == (tp.labels is None)
    if tp.labels is not None:
        np.testing.assert_array_equal(tj.labels, tp.labels)
        assert tp.labels.dtype == np.int64
    assert tp.ids.dtype == np.int64


@pytest.mark.parametrize("kind", ["ground_truth", "train_data", "test_data"])
def test_csv_loaders_equal_jax(tmp_path, kind):
    """Empty names and pandas' NA strings become the title "nan", quoted
    fields follow pandas' quoting, blank lines are skipped, and \\r\\n
    endings and a byte-order mark read as pandas reads them."""
    jio, pio, jcfg, cfg = _loader_configs(tmp_path)
    n = len(TRICKY_NAMES)
    if kind == "ground_truth":
        rows = [f"{i + 1}|{t}" for i, t in enumerate(TRICKY_NAMES)]
        _write(cfg.ground_truth_path, "company_id|name", rows[:5] + [""] + rows[5:])
    elif kind == "train_data":
        rows = [f"{i}|{t}|{(i % 3) - 1}" for i, t in enumerate(TRICKY_NAMES)]
        _write(cfg.train_path, "\ufefftrain_index|name|company_id", rows)
    else:
        rows = [f"{n - i}|{t}\r" for i, t in enumerate(TRICKY_NAMES)]
        _write(cfg.test_path, "test_index|name\r", rows)
    tj = getattr(jio, f"load_{kind}")(jcfg)
    tp = getattr(pio, f"load_{kind}")(cfg)
    _assert_same_titleset(tj, tp)
    assert len(tp) == n and tp.titles.count("nan") == 11


@pytest.mark.parametrize("name", [
    ["12", "007", "-3"],            # an integer column: str of the int
    ["12", "", "4"],                # integers beside a missing value: floats
    ["1.5", "1e3", ".5", "5."],     # floats
    ["inf", "-Infinity", "2"],
    ["True", "false", "TRUE"],      # booleans
    ["True", "", "False"],
    ["1_000", "0x10", "3"],         # not numbers to pandas: strings
    ["", "NA", "null"],             # nothing but missing values
])
def test_name_column_typed_as_pandas(tmp_path, name):
    jio, pio, jcfg, cfg = _loader_configs(tmp_path)
    _write(cfg.ground_truth_path, "company_id|name", [f"{i}|{t}" for i, t in enumerate(name)])
    _assert_same_titleset(jio.load_ground_truth(jcfg), pio.load_ground_truth(cfg))


@pytest.mark.parametrize("ids,error", [
    (["1.0", "2.7", "-3.2"], None),         # floats truncate, as astype(np.int64)
    (["1", "", "3"], "non-finite"),
    (["1", "x", "3"], "invalid literal"),
])
def test_id_column_as_astype_int64(tmp_path, ids, error):
    jio, pio, jcfg, cfg = _loader_configs(tmp_path)
    _write(cfg.ground_truth_path, "company_id|name", [f"{i}|title {k}" for k, i in enumerate(ids)])
    if error is None:
        _assert_same_titleset(jio.load_ground_truth(jcfg), pio.load_ground_truth(cfg))
        return
    with pytest.raises(ValueError):
        jio.load_ground_truth(jcfg)
    with pytest.raises(ValueError, match=error):
        pio.load_ground_truth(cfg)


@pytest.mark.parametrize("kind,header", [
    ("ground_truth", "id|name"), ("train_data", "train_index|name"), ("test_data", "index|name"),
])
def test_csv_loader_missing_column_raises_as_jax(tmp_path, kind, header):
    jio, pio, jcfg, cfg = _loader_configs(tmp_path)
    path = getattr(cfg, {"ground_truth": "ground_truth_path", "train_data": "train_path",
                         "test_data": "test_path"}[kind])
    _write(path, header, ["1|abc"])
    with pytest.raises(ValueError) as ej:
        getattr(jio, f"load_{kind}")(jcfg)
    with pytest.raises(ValueError) as ep:
        getattr(pio, f"load_{kind}")(cfg)
    assert str(ep.value) == str(ej.value)


def test_config_paths_and_singleton_equal(tmp_path, monkeypatch):
    from doppelspeller_tpu_torch import config as pconfig

    jc, pc = JConfig(data_path=str(tmp_path)), Config(data_path=str(tmp_path))
    for name in ("ground_truth_path", "train_path", "test_path", "test_with_actuals_path",
                 "final_output_path", "model_path", "index_path"):
        assert getattr(jc, name) == getattr(pc, name), name
    assert jc.path("x.csv") == pc.path("x.csv")
    monkeypatch.setattr(pconfig, "_DEFAULT", None)
    monkeypatch.setenv("PROJECT_DATA_PATH", str(tmp_path))
    first = pconfig.get_config()
    assert first is pconfig.get_config() and first.data_path == str(tmp_path)
    pconfig.set_config(pc.with_(top_n_predicting=17))
    assert pconfig.get_config().top_n_predicting == 17


def test_index_checkpoint_round_trip_and_hash(small_world, tmp_path):
    from doppelspeller_tpu.ops.ngram_index import title_content_hash as j_hash
    from doppelspeller_tpu_torch.ops.ngram_index import TruthIndex, title_content_hash

    cfg, truth, *_ = small_world
    ip = build_truth_index(truth, cfg)
    assert ip.content_hash == title_content_hash(truth.encoded, truth.lengths) \
        == j_hash(truth.encoded, truth.lengths)
    assert ip.packed_nbytes == 50653 * ip.padded_titles // 8
    ip.save(str(tmp_path / "index.npz"))
    back = TruthIndex.load(str(tmp_path / "index.npz"))
    for name in ("idf", "df", "sums", "title_ids", "trigrams"):
        np.testing.assert_array_equal(getattr(back, name), getattr(ip, name))
    assert (back.num_titles, back.padded_titles, back.max_idf, back.content_hash) == \
        (ip.num_titles, ip.padded_titles, ip.max_idf, ip.content_hash)
    np.savez(tmp_path / "other.npz", idf=ip.idf)
    with pytest.raises(ValueError, match="not a doppelspeller_tpu_torch.TruthIndex"):
        TruthIndex.load(str(tmp_path / "other.npz"))
