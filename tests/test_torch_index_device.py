"""PyTorch port, the device-built truth index (``ops/index_device.py``) on
the CPU: the trigram ids, the index, the engines' matrices, the mesh's
shards, the ``Matcher``, the checkpoint and ``build-index``, each against
the port's host build and the JAX package (its host build, its device
build and its mesh build).  Tolerances:

- the port's device build against its host build: **bit for bit**, every
  array (the sums add in one order on both);
- against the JAX host build: bit for bit (``df``, ``idf``, ``sums``);
- against the JAX device build: ``df`` and the packed bytes bit for bit,
  the sums to ``tests/test_jaccard.py``'s rtol 1e-5 (that build adds them
  in float32);
- against the JAX mesh build as ``tests/test_torch_sharded.py`` holds it:
  ``df`` equal, ``idf`` to 1e-6, sums to 1e-5.
"""

import random
import string
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doppelspeller_tpu.config import Config as JConfig
from doppelspeller_tpu.ops import fold as jfold
from doppelspeller_tpu.ops.index_device import _device_trigram_ids as j_device_ids
from doppelspeller_tpu.ops.index_device import build_truth_index_device as j_build_device
from doppelspeller_tpu.ops.ngram_index import build_truth_index as j_build_index
from doppelspeller_tpu.parallel import sharded as jsharded
from doppelspeller_tpu.utils import text as JT
from doppelspeller_tpu.utils.io import TitleSet as JTitleSet
from doppelspeller_tpu_torch import cli as pcli
from doppelspeller_tpu_torch import config as pconfig
from doppelspeller_tpu_torch import synthetic
from doppelspeller_tpu_torch.config import TRIGRAM_VOCAB_SIZE as V
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.ops import fold, index_device
from doppelspeller_tpu_torch.ops.jaccard import JaccardScorer
from doppelspeller_tpu_torch.ops.ngram_index import (
    TruthIndex,
    build_packed_matrix,
    build_truth_index,
    index_build_impl,
)
from doppelspeller_tpu_torch.parallel.sharded import ShardedJaccardScorer, build_sharded_index, make_mesh
from doppelspeller_tpu_torch.pipeline import Matcher
from doppelspeller_tpu_torch.utils import text as T
from doppelspeller_tpu_torch.utils.io import TitleSet
from test_cli import _make_tiny_dataset
from test_torch_helpers import MODEL, port_config

INDEX_ARRAYS = ("df", "idf", "sums", "trigrams", "title_ids")
INDEX_SCALARS = ("num_titles", "padded_titles", "max_idf", "content_hash")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _same_index(a, b):
    for f in INDEX_ARRAYS:
        _bits_equal(getattr(a, f), getattr(b, f))
    for f in INDEX_SCALARS:
        assert getattr(a, f) == getattr(b, f), f


@pytest.fixture(scope="module")
def small_world():
    """3,000 synthetic titles at ``title_block`` 2,048: 1,096 padding titles
    past the last one."""
    cfg, truth, queries, _ = synthetic.make_synthetic_world(3000, 64)
    return cfg.with_(title_block=2048), truth, queries


def _random_titles(n, rng):
    alphabet = string.ascii_lowercase + "  0123456789"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(3, 40))) for _ in range(n)]


# ------------------------------------------------------------- trigram ids

ID_CASES = {
    "three_chars": ["abc", "a b", "xyz12", "q"],
    "repeated_trigrams": ["aaaaaaa", "abababab ab", "zzz zzz zzz", "aaa"],
    "255_chars": ["k" * 300, "".join(random.Random(1).choice("abc ") for _ in range(255)), "short one"],
    "random": _random_titles(200, random.Random(5)),
}


@pytest.mark.parametrize("case", sorted(ID_CASES))
def test_device_trigram_ids_equal_the_host_and_jax_ids(case):
    cfg = pconfig.Config(data_path="/tmp/x")
    ts = TitleSet.from_titles(ID_CASES[case], config=cfg)
    enc, lens = torch.from_numpy(ts.encoded), torch.from_numpy(ts.lengths)
    host = T.trigram_ids_matrix(ts.encoded, ts.lengths)
    _bits_equal(host, JT.trigram_ids_matrix(ts.encoded, ts.lengths))
    width = index_device.ids_width(ts.lengths)
    assert host.shape[1] == width
    if case == "255_chars":
        assert width == 253
    _bits_equal(index_device.device_trigram_ids(enc, lens), host)
    # the JAX ids: full width L - 2, V in place of repeats and unused slots
    jids = np.asarray(j_device_ids(jnp.asarray(ts.encoded), jnp.asarray(ts.lengths)))
    raw = index_device.title_trigram_ids(enc, lens, width).numpy()
    _bits_equal(raw, jids[:, :width])
    assert (jids[:, width:] == V).all()
    _bits_equal(np.sort(np.where(jids == V, T.BIG_TRIGRAM, jids), axis=1)[:, :width], host)


# ------------------------------------------------------------------- index

@pytest.mark.parametrize("block", [64, 777, None])
def test_device_build_equals_the_host_builds_and_the_jax_device_build(small_world, block):
    cfg, truth, _ = small_world
    host = build_truth_index(truth, cfg)
    if block is None:      # through build_truth_index, at the default block
        dev = build_truth_index(truth, cfg.with_(index_build_impl="device"), "cpu")
    else:
        dev = index_device.build_truth_index_device(truth, cfg, "cpu", block=block)
    assert (host.built_on, dev.built_on) == ("host", "device")
    _same_index(dev, host)
    jcfg = JConfig(data_path="/tmp/x", title_block=2048, index_build_impl="host")
    jtruth = JTitleSet.from_titles(truth.titles, ids=truth.ids, config=jcfg)
    jhost = j_build_index(jtruth, jcfg)
    for f in ("df", "idf", "sums", "title_ids"):
        _bits_equal(getattr(dev, f), getattr(jhost, f))
    for f in INDEX_SCALARS:
        assert getattr(dev, f) == getattr(jhost, f), f
    jdev = j_build_device(jtruth, jcfg, block=64)
    _bits_equal(dev.df, jdev.df)
    _bits_equal(build_packed_matrix(dev, "cpu").numpy(), np.asarray(jdev.packed))
    np.testing.assert_allclose(dev.sums, jdev.sums, rtol=1e-5, atol=1e-5)


def _host_trigram_lists(encoded, lengths, ntp):
    """The trigram lists as the host built them before the device build:
    ids sorted with V for unused slots, each repeat replaced by V in place."""
    nt = encoded.shape[0]
    l_eff = int(lengths.max(initial=3))
    ltw = max(-(-(l_eff - 2) // 8) * 8, 8)
    out = np.full((ntp, ltw), V, dtype=np.int32)
    text = T._FEATURE_TO_TEXT[encoded[:, :l_eff]].astype(np.int64)
    ids = text[:, :-2] * 37 ** 2 + text[:, 1:-1] * 37 + text[:, 2:]
    valid = np.arange(l_eff - 2)[None, :] <= (lengths[:, None] - 3)
    ids = np.sort(np.where(valid, ids, V), axis=1)
    ids[:, 1:] = np.where(ids[:, 1:] == ids[:, :-1], V, ids[:, 1:])
    out[:nt, : ids.shape[1]] = ids
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_matrices_from_device_ids_equal_the_host_id_builds_and_jax(small_world, seed):
    cfg, truth, _ = small_world
    host = build_truth_index(truth, cfg)
    dev = index_device.build_truth_index_device(truth, cfg, "cpu", block=1000)
    ids, df = index_device.build_shard(truth.encoded, truth.lengths, "cpu",
                                       index_device.ids_width(truth.lengths), block=1000)
    _bits_equal(df.numpy().astype(np.int32), host.df)
    ntp = host.padded_titles
    # packed: from the device ids, from the host ids, the JAX host build
    packed = build_packed_matrix(dev, "cpu").numpy()
    _bits_equal(packed, build_packed_matrix(host, "cpu").numpy())
    jcfg = JConfig(data_path="/tmp/x", title_block=2048, index_build_impl="host")
    _bits_equal(packed, j_build_index(JTitleSet.from_titles(truth.titles, ids=truth.ids, config=jcfg),
                                      jcfg).packed)
    # folded matrix: from the device ids, from the host ids, the JAX builder
    fm = fold.build_fold_map(dev.df, 512, seed=seed)
    mc = fold.build_folded_matrix(ids, fm, 512, ntp).numpy()
    host_ids = torch.from_numpy(np.minimum(T.trigram_ids_matrix(truth.encoded, truth.lengths), V))
    _bits_equal(mc, fold.build_folded_matrix(host_ids, fm, 512, ntp).numpy())
    _bits_equal(mc, np.asarray(jfold.build_folded_matrix(truth.encoded, truth.lengths, fm, 512, ntp)))
    # trigram lists
    tl, ltw = fold.build_trigram_list_matrix(ids, ntp)
    _bits_equal(tl.numpy(), _host_trigram_lists(truth.encoded, truth.lengths, ntp))
    tl_j, ltw_j = jfold.build_trigram_list_matrix(truth.encoded, truth.lengths, ntp)
    assert ltw == ltw_j
    _bits_equal(tl.numpy(), np.asarray(tl_j).astype(np.int32))
    # the engines: a device-built index's against a host-built one's
    cfg_f = cfg.with_(retrieval_mode="folded", fold_hashes=2)
    a = JaccardScorer(dev, cfg_f, "cpu", truth).folded
    b = JaccardScorer(host, cfg_f, "cpu", truth).folded
    for name in ("mc", "tl", "fold_ext", "sums", "idf_ext"):
        _bits_equal(getattr(a, name).numpy(), getattr(b, name).numpy())
    _bits_equal(a.mc[seed * 512 : (seed + 1) * 512].numpy(), mc)


# -------------------------------------------------------------------- mesh

def _mesh_titles(n, rng):
    alphabet = string.ascii_lowercase + "  01"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(5, 30))).strip() or "abc"
            for _ in range(n)]


@pytest.fixture(scope="module")
def mesh_world():
    """``tests/test_torch_sharded.py``'s world: 600 titles, ``title_block``
    128, ``query_block`` 8."""
    rng = random.Random(9)
    jcfg = JConfig(data_path="/tmp/x", title_block=128, query_block=8, score_dtype="float32")
    jtruth = JTitleSet.from_titles(_mesh_titles(600, rng), config=jcfg)
    jq = JTitleSet.from_titles(_mesh_titles(33, rng) + [jtruth.transformed[4]], config=jcfg)
    cfg = port_config(jcfg)
    truth = TitleSet.from_titles(jtruth.titles, ids=jtruth.ids, config=cfg)
    queries = TitleSet.from_titles(jq.titles, ids=jq.ids, config=cfg)
    return jcfg, jtruth, cfg, truth, queries


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_mesh_build_equals_build_truth_index_and_the_host_shards(mesh_world, n_dev):
    jcfg, jtruth, cfg, truth, queries = mesh_world
    host = build_truth_index(truth, cfg)
    mesh = make_mesh(n_dev, platform="cpu")
    for mode in ("exact", "folded"):
        c = cfg.with_(retrieval_mode=mode)
        built = build_sharded_index(truth, mesh, c)
        _same_index(built.index, host)
        assert built.index.trigrams.shape[1] == index_device.ids_width(truth.lengths)
        before = ShardedJaccardScorer(host, mesh, c, truth=truth)
        if mode == "exact":
            assert built.exact is not None
            for x, y in zip(built.exact, before.exact):
                _bits_equal(x.packed.numpy(), y.packed.numpy())
                _bits_equal(x.sums.numpy(), y.sums.numpy())
        else:
            assert built.folded is not None
            for x, y in zip(built.folded, before.folded):
                for name in ("mc", "tl", "sums"):
                    _bits_equal(getattr(x, name).numpy(), getattr(y, name).numpy())
        for x, y in zip(built.topk(queries, k=15), before.topk(queries, k=15)):
            _bits_equal(x, y)
        if mode == "exact":
            for x, y in zip(built.topk(queries, k=15), JaccardScorer(host, c, "cpu").topk(queries, k=15)):
                _bits_equal(x, y)
    jbuilt = jsharded.build_sharded_index(jtruth, jsharded.make_mesh(n_dev), jcfg)
    np.testing.assert_array_equal(built.index.df, jbuilt.index.df)
    np.testing.assert_allclose(built.index.idf, jbuilt.index.idf, rtol=1e-6)
    np.testing.assert_allclose(built.index.sums, jbuilt.index.sums, rtol=1e-5, atol=1e-5)


def test_a_device_built_index_is_sharded_from_its_device_ids(mesh_world):
    """``ShardedJaccardScorer`` over an index built on a device (as the
    trainer gives it) builds each shard's matrices bit for bit as over the
    host index."""
    *_, cfg, truth, queries = mesh_world
    host = build_truth_index(truth, cfg)
    dev = build_truth_index(truth, cfg.with_(index_build_impl="device"), "cpu")
    mesh = make_mesh(4, platform="cpu")
    for mode in ("exact", "folded"):
        c = cfg.with_(retrieval_mode=mode)
        a = ShardedJaccardScorer(dev, mesh, c, truth=truth)
        b = ShardedJaccardScorer(host, mesh, c, truth=truth)
        for x, y in zip(a.topk(queries, k=15), b.topk(queries, k=15)):
            _bits_equal(x, y)


# ------------------------------------------------- Matcher and checkpoint

@pytest.mark.parametrize("mode", ["exact", "folded"])
def test_matcher_with_the_device_build_predicts_as_the_host_build(mode):
    cfg, truth, queries, _ = synthetic.make_synthetic_world(2048, 96)
    cfg = cfg.with_(retrieval_mode=mode, title_block=2048)
    model = GBTModel.load(str(MODEL))
    res = {}
    for impl in ("host", "device"):
        t = time.perf_counter()
        m = Matcher(cfg.with_(index_build_impl=impl), truth, model, device="cpu",
                    use_index_checkpoint=False)
        total = time.perf_counter() - t
        assert m.index.built_on == impl
        assert set(m.init_seconds) == {"load", "index", "retrieval", "words", "token_sort",
                                       "fuzzy_engine", "rest"}
        # the pieces follow one another: they sum to the construction's
        # seconds, less the microseconds before the first and after the last
        assert 0.0 <= total - sum(m.init_seconds.values()) < 0.005 + 0.01 * total
        res[impl] = m.predict(queries)
        del m                   # freed here, not inside the next construction's seconds
    a, b = res["host"], res["device"]
    _bits_equal(a.match_title_id, b.match_title_id)
    _bits_equal(a.stage, b.stage)
    _bits_equal(a.prediction, b.prediction)
    assert a.match_transformed == b.match_transformed


def test_device_built_checkpoint_loads_as_the_host_built_one(small_world, tmp_path):
    cfg, truth, queries = small_world
    host = build_truth_index(truth, cfg)
    dev = build_truth_index(truth, cfg.with_(index_build_impl="device"), "cpu")
    host.save(str(tmp_path / "host.npz"))
    dev.save(str(tmp_path / "dev.npz"))
    a, b = TruthIndex.load(str(tmp_path / "host.npz")), TruthIndex.load(str(tmp_path / "dev.npz"))
    _same_index(a, b)
    _same_index(a, host)
    with np.load(tmp_path / "host.npz") as za, np.load(tmp_path / "dev.npz") as zb:
        assert za.files == zb.files
        for name in za.files:
            _bits_equal(za[name], zb[name])


def test_build_index_verb_writes_the_same_arrays_with_the_device_build(tmp_path, monkeypatch, capsys):
    files = {}
    for impl in ("host", "device"):
        cfg = pconfig.Config(data_path=str(tmp_path / impl), title_block=128, index_build_impl=impl)
        (tmp_path / impl).mkdir()
        _make_tiny_dataset(cfg)
        monkeypatch.setattr(pconfig, "_DEFAULT", cfg)
        assert pcli.main(["build-index", "--device", "cpu"]) == 0
        files[impl] = np.load(cfg.index_path)
    assert "index saved to" in capsys.readouterr().out
    assert files["host"].files == files["device"].files
    for name in files["host"].files:
        _bits_equal(files["host"][name], files["device"][name])


@pytest.mark.parametrize("impl,device,card,want", [
    ("auto", "cpu", True, "host"),
    ("auto", "cuda", True, "device"),
    ("auto", torch.device("cuda", 1), True, "device"),
    ("auto", None, False, "host"),
    ("auto", None, True, "device"),
    ("device", "cpu", True, "device"),
    ("device", "cuda", True, "device"),
    ("device", None, False, "device"),
    ("host", "cpu", True, "host"),
    ("host", "cuda", True, "host"),
    ("host", None, True, "host"),
    ("native", "cuda", True, "host"),
])
def test_index_build_impl_resolves_as_the_jax_package(impl, device, card, want, monkeypatch):
    """No device: the default device, the card where there is one (``card``),
    as the JAX package resolves on its default backend."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    assert index_build_impl(pconfig.Config(data_path="/tmp/x", index_build_impl=impl), device) == want


@pytest.mark.parametrize("impl", ["device", "auto"])
def test_build_truth_index_without_a_device_builds_on_the_default_device(small_world, impl):
    """Without a device on a host with no card, ``"device"`` takes the
    device build on the CPU and ``"auto"`` the host build, each equal to
    the host build bit for bit."""
    cfg, truth, _ = small_world
    host = build_truth_index(truth, cfg.with_(index_build_impl="host"))
    got = build_truth_index(truth, cfg.with_(index_build_impl=impl))
    want = "device" if impl == "device" or torch.cuda.is_available() else "host"
    assert (host.built_on, got.built_on) == ("host", want)
    _same_index(got, host)


# --------------------------------------------------------------- text layer

def _text_case(name, ts):
    if name == "trigram_df_table":
        _bits_equal(T.trigram_df_table(ts.encoded, ts.lengths),
                    JT.trigram_df_table(ts.encoded, ts.lengths))
    elif name == "encode_decode_title":
        for t in ts.transformed:
            _bits_equal(T.encode_title(t), JT.encode_title(t, 255))
            assert T.decode_title(T.encode_title(t)) == JT.decode_title(JT.encode_title(t, 255)) == t[:255]
        _bits_equal(T.encode_title("ab c", 6), JT.encode_title("ab c", 6))
    elif name == "get_n_grams":
        for t in ts.transformed:
            assert T.get_n_grams(t) == JT.get_n_grams(t, 3)
            assert T.get_n_grams(t, 2) == JT.get_n_grams(t, 2)
    else:
        counter = T.get_words_counter(ts.words)
        assert counter == JT.get_words_counter(ts.words)
        for w in counter:
            assert T.idf_word(w, counter, len(ts)) == JT.idf_word(w, counter, len(ts))


@pytest.mark.parametrize("name", ["trigram_df_table", "encode_decode_title", "get_n_grams", "idf_word"])
def test_text_layer_equals_the_jax_text_module(name):
    cfg = pconfig.Config(data_path="/tmp/x")
    titles = _random_titles(150, random.Random(11)) + ["aaaaaaa", "k" * 300, "ab"]
    _text_case(name, TitleSet.from_titles(titles, config=cfg))
