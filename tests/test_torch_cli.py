"""PyTorch port: the command-line verbs against the JAX package's CLI.

Both CLIs run on the CPU over two data directories that hold the same CSVs
(the tiny dataset of ``tests/test_cli.py``) and the same ``model.npz``: the
JAX package's ``train-model`` writes it and it is copied across, since the
port's trees may part from the reference's at tied splits.  The reference
runs the Pallas kernels in interpret mode, as the other parity tests do.
Its verbs run through ``click.testing.CliRunner``, the port's through
``cli.main([... "--device", "cpu"])``.  Output files and printed lines must
be equal byte for byte; ``serve``'s replies key for key but for
``latency_ms``.
"""

import io
import json
import logging
import shutil

import pytest
import torch
from click.testing import CliRunner

from doppelspeller_tpu import config as jconfig
from doppelspeller_tpu.cli import cli as jcli
from doppelspeller_tpu_torch import cli as pcli
from doppelspeller_tpu_torch import config as pconfig
from test_cli import _make_tiny_dataset
from test_torch_helpers import port_config

SERVE_REQUESTS = [
    "alpha holdings 0",
    json.dumps({"id": 42, "title": "bravo holdngs 1"}),
    json.dumps({"titles": ["carlo holdings 2", "zzz no such co"]}),
    "{not json",
    json.dumps({"titles": "carlo holdings 2"}),
    json.dumps({"titles": ["ok", 7]}),
    json.dumps({"titles": []}),
    "",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(tmp, name):
    jcfg = jconfig.Config(
        data_path=str(tmp / name), title_block=128, query_block=8, pair_block=64,
        top_n_predicting=15, top_n_training=5, gbt_num_boost_round=15,
        gbt_early_stopping_rounds=15, score_dtype="float32", retrieval_impl="pallas_interpret",
    )
    (tmp / name).mkdir()
    return jcfg, port_config(jcfg)


def _jax(jcfg, args, stdin=None):
    jconfig.set_config(jcfg)
    r = CliRunner().invoke(jcli, args, input=stdin, catch_exceptions=False)
    assert r.exit_code == 0, r.output
    return r.output


def _port(cfg, args, capsys, monkeypatch, stdin=None):
    monkeypatch.setattr(pconfig, "_DEFAULT", cfg)
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    capsys.readouterr()
    rc = pcli.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Two data directories with the same CSVs and the reference's model;
    the JAX CLI has run ``build-index`` and ``generate-predictions`` in its
    own."""
    tmp = tmp_path_factory.mktemp("cli")
    jcfg, _ = _configs(tmp, "jax")
    jcfg_p, cfg = _configs(tmp, "port")
    _make_tiny_dataset(jcfg)
    _make_tiny_dataset(jcfg_p)
    try:
        _jax(jcfg, ["-v", "train-model"])
        shutil.copy(jcfg.model_path, cfg.model_path)
        _jax(jcfg, ["-v", "build-index"])
        _jax(jcfg, ["-v", "generate-predictions"])
    finally:
        jconfig.set_config(jconfig.Config())
    return jcfg, cfg


def _lines(out):
    return [ln for ln in out.splitlines() if not ln.startswith("[")]     # log lines out


def test_generate_predictions_file_equal(dirs, capsys, monkeypatch):
    jcfg, cfg = dirs
    out = _port(cfg, ["-v", "generate-predictions"], capsys, monkeypatch)
    assert _lines(out) == [f"output saved to {cfg.final_output_path}"]
    with open(jcfg.final_output_path, "rb") as a, open(cfg.final_output_path, "rb") as b:
        assert a.read() == b.read()


def test_get_predictions_accuracy_lines_equal(dirs, capsys, monkeypatch):
    jcfg, cfg = dirs
    _port(cfg, ["generate-predictions"], capsys, monkeypatch)
    try:
        ref = _jax(jcfg, ["get-predictions-accuracy"])
    finally:
        jconfig.set_config(jconfig.Config())
    out = _port(cfg, ["get-predictions-accuracy"], capsys, monkeypatch)
    assert out == ref
    assert "Correctly matched titles            10" in out


@pytest.mark.parametrize("title", ["alpha holdings 0", "bravo holdngs 1", "zzz unknown holdings"])
def test_closest_search_single_title_line_equal(dirs, capsys, monkeypatch, title):
    jcfg, cfg = dirs
    try:
        ref = _jax(jcfg, ["closest-search-single-title", "-t", title])
    finally:
        jconfig.set_config(jconfig.Config())
    out = _port(cfg, ["closest-search-single-title", "-t", title], capsys, monkeypatch)
    assert out == ref and out.startswith("Closest match: {")


@pytest.mark.parametrize("profile", ["latency", "throughput"])
def test_serve_replies_equal(dirs, capsys, monkeypatch, profile):
    jcfg, cfg = dirs
    stdin = "\n".join(SERVE_REQUESTS) + "\n"
    args = ["serve", "--no-warmup", "--profile", profile]
    try:
        ref = [json.loads(ln) for ln in _jax(jcfg, args, stdin).splitlines() if ln.startswith("{")]
    finally:
        jconfig.set_config(jconfig.Config())
    out = [json.loads(ln) for ln in _port(cfg, args, capsys, monkeypatch, stdin).splitlines()
           if ln.startswith("{")]
    assert len(out) == len(ref) == 7
    for a, b in zip(ref, out):
        a.pop("latency_ms", None), b.pop("latency_ms", None)
        assert list(a) == list(b) and a == b
    assert out[0]["match_title_id"] == 1 and out[1]["test_index"] == 42
    assert "JSONDecodeError" in out[3]["error"] and "list of strings" in out[4]["error"]


def test_serve_warms_up_and_says_ready(dirs, capsys, monkeypatch):
    _jcfg, cfg = dirs
    out = _port(cfg, ["serve"], capsys, monkeypatch, "alpha holdings 0\n")
    assert json.loads(out.splitlines()[-1])["match_title_id"] == 1
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    assert pcli.main(["serve", "--device", "cpu"]) == 0
    assert capsys.readouterr().err.startswith("# ready: 100 titles indexed, engine warm in ")


def test_build_index_then_a_changed_truth_rebuilds(dirs, tmp_path, capsys, monkeypatch, caplog):
    _jcfg, cfg = dirs
    cfg = cfg.with_(data_path=str(tmp_path))
    for f in ("example_truth.csv", "example_test.csv", "model.npz"):
        shutil.copy(f"{dirs[1].data_path}/{f}", tmp_path / f)
    out = _port(cfg, ["build-index"], capsys, monkeypatch)
    assert _lines(out) == [f"index saved to {cfg.index_path} (100 titles, 1 MB packed)"]
    caplog.set_level(logging.INFO, logger="doppelspeller_tpu_torch.pipeline")
    _port(cfg, ["generate-predictions"], capsys, monkeypatch)
    assert "loaded index checkpoint from" in caplog.text
    first = (tmp_path / "final_output.csv").read_bytes()
    truth = (tmp_path / "example_truth.csv").read_text().replace("alpha holdings 0", "alpha holdinx 0")
    (tmp_path / "example_truth.csv").write_text(truth)
    caplog.clear()
    _port(cfg, ["generate-predictions"], capsys, monkeypatch)
    assert "does not match the truth data; rebuilding" in caplog.text
    assert "loaded index checkpoint" not in caplog.text
    assert (tmp_path / "final_output.csv").read_bytes() != first


def test_jax_format_index_is_rebuilt_not_read(dirs, tmp_path, capsys, monkeypatch, caplog):
    jcfg, cfg = dirs
    cfg = cfg.with_(data_path=str(tmp_path))
    for f in ("example_truth.csv", "example_test.csv", "model.npz"):
        shutil.copy(f"{dirs[1].data_path}/{f}", tmp_path / f)
    shutil.copy(jcfg.index_path, cfg.index_path)                    # the JAX CLI's build-index
    caplog.set_level(logging.INFO, logger="doppelspeller_tpu_torch.pipeline")
    _port(cfg, ["generate-predictions"], capsys, monkeypatch)
    assert "unreadable" in caplog.text and "rebuilding" in caplog.text
    assert (tmp_path / "final_output.csv").read_bytes() == open(jcfg.final_output_path, "rb").read()


@pytest.mark.parametrize("verb", ["build-index", "generate-predictions", "train-model", "serve"])
def test_devices_other_than_one_fail_with_the_sharding_message(dirs, capsys, monkeypatch, verb):
    """A mesh of more cards than the machine has fails with ``make_mesh``'s
    message (the mesh itself: ``tests/test_torch_sharded_train.py``)."""
    monkeypatch.setattr(pconfig, "_DEFAULT", dirs[1])
    n = torch.cuda.device_count() + 1
    assert pcli.main([verb, "--devices", str(n), "--platform", "cuda", "--device", "cpu"]) == 1
    assert f"Error: --devices {n}: need {n} devices, have {n - 1}" in capsys.readouterr().err


def test_train_model_and_stage_run(dirs, tmp_path, capsys, monkeypatch):
    """``train-model`` on the port's own trees prints the reference's two
    lines and writes a model the JAX package loads; ``stage-example-data-set``
    unpacks the gzipped CSVs."""
    import gzip

    from doppelspeller_tpu.models.gbt import GBTModel as JGBTModel

    _jcfg, cfg = dirs
    cfg = cfg.with_(data_path=str(tmp_path / "data"))
    src = tmp_path / "src"
    src.mkdir()
    for f in ("example_truth.csv", "example_train.csv"):
        with open(f"{dirs[1].data_path}/{f}", "rb") as a, gzip.open(src / f"{f}.gz", "wb") as b:
            b.write(a.read())
    out = _port(cfg, ["stage-example-data-set", "--source", str(src)], capsys, monkeypatch)
    assert sorted(out.split()) == sorted(["staged", "staged", cfg.ground_truth_path, cfg.train_path])
    out = _lines(_port(cfg, ["train-model"], capsys, monkeypatch))
    assert out[0].startswith("trees=15 best=") and " TP=" in out[0]
    assert out[1].startswith("top features: f") and out[1].count("=") == 10
    assert JGBTModel.load(cfg.model_path).num_trees == 15


def test_version(capsys):
    with pytest.raises(SystemExit) as e:
        pcli.main(["--version"])
    assert e.value.code == 0 and capsys.readouterr().out.strip() == "doppel-tpu-torch, version 0.1.0"


def test_profile_dir_writes_a_trace_and_the_verb_is_timed(dirs, tmp_path, capsys, monkeypatch, caplog):
    """``DOPPEL_PROFILE_DIR`` runs a verb under ``torch.profiler`` and writes
    a Chrome trace there; every timed verb logs its elapsed time."""
    _jcfg, cfg = dirs
    monkeypatch.setenv("DOPPEL_PROFILE_DIR", str(tmp_path / "prof"))
    caplog.set_level(logging.INFO, logger="doppelspeller_tpu_torch.utils.timing")
    _port(cfg, ["generate-predictions"], capsys, monkeypatch)
    traces = list((tmp_path / "prof").glob("generate_predictions.*.trace.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    assert "Elapsed time [generate_predictions]: 0h | 0m | " in caplog.text


@pytest.mark.parametrize("argv,env,level", [
    ([], None, logging.WARNING), (["-v"], None, logging.WARNING), (["-vv"], None, logging.INFO),
    (["-vvv"], None, logging.DEBUG), ([], "2", logging.INFO), (["-v"], "3", logging.WARNING),
])
def test_verbosity_as_the_jax_cli(monkeypatch, argv, env, level):
    """-v/-vv/-vvv (or ``LOGGING_LEVEL`` where none is given) log at
    WARNING/INFO/DEBUG, as ``doppelspeller_tpu/cli.py:26-38``."""
    if env is None:
        monkeypatch.delenv("LOGGING_LEVEL", raising=False)
    else:
        monkeypatch.setenv("LOGGING_LEVEL", env)
    assert pcli._log_level(pcli._parser().parse_args(argv + ["build-index"]).verbose) == level


def test_one_device_is_accepted(dirs, capsys, monkeypatch):
    out = _port(dirs[1], ["build-index", "--devices", "1", "--platform", "cpu"], capsys, monkeypatch)
    assert "titles, 1 MB packed)" in out
