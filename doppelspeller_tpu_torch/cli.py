"""Command-line interface of the PyTorch port.

The JAX package's verbs with the same output lines, on ``argparse``:

    python -m doppelspeller_tpu_torch.cli [-v|-vv|-vvv] [--device cuda|cpu] VERB ...

``-v``/``-vv``/``-vvv`` log at WARNING/INFO/DEBUG (``LOGGING_LEVEL`` sets
the count where no ``-v`` is given).  ``--device`` names the device every
verb runs on: the card, ``cuda``, unless the caller asks for ``cpu``.
``build-index``, ``train-model``, ``generate-predictions`` and ``serve``
take ``--devices N``: 0 (the default) runs on that one device, N ≥ 1 on a
mesh of N devices (``parallel/sharded.py``) of ``--platform`` (``cuda`` or
``cpu``; default the type of ``--device``), as the JAX CLI's mesh.

Verbs: ``stage-example-data-set``, ``build-index``, ``train-model``,
``generate-predictions``, ``closest-search-single-title``, ``serve`` and
``get-predictions-accuracy``.  Also installed as the ``doppel-tpu-torch``
script.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import List, Optional

from doppelspeller_tpu_torch import __build__, __version__
from doppelspeller_tpu_torch.utils.timing import time_usage

LOGGER = logging.getLogger(__name__)

# the serve loop's request-sized shapes under --profile latency
LATENCY_PROFILE = dict(
    query_block=8,
    dispatch_blocks=1,
    union_buckets=(128, 256, 512, 1024, 2048, 4096, 8192),
    model_slab=128,
    rerank_chunk_cap=128,
)


class CLIError(Exception):
    """A usage error: printed as ``Error: ...``, exit code 1."""


def _echo(text: str = "") -> None:
    print(text, flush=True)


def _mesh(args, cfg):
    """The mesh of ``--devices`` (None for 0: one device)."""
    if not args.devices:
        return None
    import torch

    from doppelspeller_tpu_torch.parallel.sharded import make_mesh

    platform = args.platform or torch.device(args.device).type
    try:
        return make_mesh(args.devices, axis=cfg.mesh_axis, platform=platform)
    except ValueError as exc:                   # fewer cards than asked for
        raise CLIError(f"--devices {args.devices}: {exc}") from exc


def stage_example_data_set(args) -> None:
    """Copy + decompress the example dataset's *.csv.gz into PROJECT_DATA_PATH."""
    import glob
    import gzip
    import shutil

    from doppelspeller_tpu_torch.config import get_config

    cfg = get_config()
    os.makedirs(cfg.data_path, exist_ok=True)
    for gz in glob.glob(os.path.join(args.source, "*.csv.gz")):
        dest = os.path.join(cfg.data_path, os.path.basename(gz)[:-3])
        with gzip.open(gz, "rb") as f_in, open(dest, "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
        _echo(f"staged {dest}")


@time_usage
def build_index(args) -> None:
    """Build and checkpoint the truth index."""
    from doppelspeller_tpu_torch.config import get_config
    from doppelspeller_tpu_torch.ops.ngram_index import build_truth_index
    from doppelspeller_tpu_torch.utils.io import load_ground_truth

    cfg = get_config()
    truth = load_ground_truth(cfg)
    mesh = _mesh(args, cfg)
    if mesh is not None:
        from doppelspeller_tpu_torch.parallel.sharded import build_sharded_index

        scorer = build_sharded_index(truth, mesh, cfg)
        scorer.save(cfg.index_path)
        index = scorer.index
    else:
        index = build_truth_index(truth, cfg, args.device)
        index.save(cfg.index_path)
    _echo(f"index saved to {cfg.index_path} "
          f"({index.num_titles} titles, {index.packed_nbytes / 1e6:.0f} MB packed)")


@time_usage
def train_model(args) -> None:
    """Train the model and save it to the config's model path."""
    from doppelspeller_tpu_torch.config import get_config
    from doppelspeller_tpu_torch.models.trainer import train_model as _train

    LOGGER.info("Training the model!")
    model, report = _train(device=args.device, mesh=_mesh(args, get_config()))
    em = report["error_matrix"]
    _echo(
        f"trees={model.num_trees} best={model.best_ntree_limit} "
        f"eval custom-error={report['eval_custom_error']:.0f} "
        f"TP={em['tp']} TN={em['tn']} FP={em['fp']} FN={em['fn']}"
    )
    imp = report["feature_importance"]
    top = sorted(enumerate(imp), key=lambda kv: -kv[1])[:10]
    _echo("top features: " + ", ".join(f"f{i}={v:.3f}" for i, v in top))


@time_usage
def generate_predictions(args) -> None:
    """Generate predictions for the test file."""
    from doppelspeller_tpu_torch.config import get_config
    from doppelspeller_tpu_torch.pipeline import Matcher
    from doppelspeller_tpu_torch.utils.io import load_test_data

    cfg = get_config()
    LOGGER.info("Generating the predictions!")
    matcher = Matcher(cfg, device=args.device, mesh=_mesh(args, cfg))
    result = matcher.predict(load_test_data(cfg))
    result.save_csv(cfg.final_output_path, cfg.delimiter)
    _echo(f"output saved to {cfg.final_output_path}")


@time_usage
def closest_search_single_title(args) -> None:
    """Closest match for a single title."""
    from doppelspeller_tpu_torch.config import get_config
    from doppelspeller_tpu_torch.pipeline import Matcher
    from doppelspeller_tpu_torch.utils.io import single_title_set

    title = args.title.strip()
    if not title:
        raise CLIError("empty --title-to-search")
    cfg = get_config()
    matcher = Matcher(cfg, device=args.device)
    result = matcher.predict(single_title_set(title, cfg), single=True)
    _echo(f"Closest match: {result.single_result()}")


def serve(args) -> None:
    """Persistent matching service over stdin/stdout (JSON lines).

    The engine (index, model, device tables) is built once; each request
    ships only the query.  One request per input line:

      acme holdigns ltd                     bare title
      {"id": 7, "title": "acme holdigns"}   single title with caller id
      {"titles": ["a co", "b co"]}          small batch

    One JSON response per line.  A single title returns its best candidate
    whatever its probability; a batch takes the full decision (threshold,
    −1 for not found).  Requests of at most one query block take the
    one-dispatch path: on the card a CUDA graph per static shape, captured
    at the shape's first request and replayed after."""
    import numpy as np

    from doppelspeller_tpu_torch.config import get_config
    from doppelspeller_tpu_torch.pipeline import Matcher
    from doppelspeller_tpu_torch.utils.io import TitleSet, single_title_set

    cfg = get_config()
    if args.profile == "latency":
        cfg = cfg.with_(**LATENCY_PROFILE)
    t0 = time.time()
    matcher = Matcher(cfg, device=args.device, mesh=_mesh(args, cfg))
    if args.warmup:
        # captures the graphs of the first shapes: short and long single
        # titles and a small batch
        matcher.predict(single_title_set("wrmup exampl compani", cfg), single=True)
        matcher.predict(single_title_set(
            "wrmup exampl compani with a much longer title form", cfg), single=True)
        matcher.predict(TitleSet.from_titles(
            ["wrmup alpha co", "wrmup bravo ltd", "wrmup carlo inc"],
            ids=np.arange(3, dtype=np.int64), config=cfg))
    print(f"# ready: {matcher.index.num_titles} titles indexed, "
          f"engine warm in {time.time() - t0:.1f}s", file=sys.stderr, flush=True)

    def _single(title, req_id=None):
        t = time.time()
        out = matcher.predict(single_title_set(title, cfg), single=True).single_result()
        if req_id is not None:
            out["test_index"] = req_id
        out["title"] = title
        out["latency_ms"] = round((time.time() - t) * 1e3, 2)
        return out

    def _batch(titles):
        t = time.time()
        qs = TitleSet.from_titles(list(titles), ids=np.arange(len(titles), dtype=np.int64),
                                  config=cfg)
        res = matcher.predict(qs)
        return {
            "results": [
                {
                    "title": titles[i],
                    "transformed_title": res.transformed[i],
                    "match_title_id": int(res.match_title_id[i]),
                    "match_transformed_title": res.match_transformed[i],
                    "prediction": float(res.prediction[i]),
                }
                for i in range(len(titles))
            ],
            "latency_ms": round((time.time() - t) * 1e3, 2),
        }

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            if line.startswith("{"):
                req = json.loads(line)
                if "titles" in req:
                    titles = req["titles"]
                    # a bare string is iterable: {"titles": "acme co"} would
                    # otherwise match per character
                    if not isinstance(titles, list) or not all(isinstance(t, str) for t in titles):
                        out = {"error": "'titles' must be a list of strings"}
                    elif not titles:
                        out = {"results": [], "latency_ms": 0.0}
                    else:
                        out = _batch(titles)
                else:
                    out = _single(str(req["title"]), req.get("id"))
            else:
                out = _single(line)
        except Exception as exc:  # the serve loop must survive any bad request
            out = {"error": f"{type(exc).__name__}: {exc}"}
        print(json.dumps(out), flush=True)


@time_usage
def get_predictions_accuracy(args) -> None:
    """Print the predictions' accuracy against the actuals file."""
    from doppelspeller_tpu_torch.config import get_config
    from doppelspeller_tpu_torch.pipeline import accuracy_report

    cfg = get_config()
    report = accuracy_report(cfg.test_with_actuals_path, cfg.final_output_path, cfg.delimiter)
    _echo(
        f"\nCorrectly matched titles            {report['correctly_matched']}\n"
        f"Incorrectly matched titles          {report['incorrectly_matched']}\n"
        f"Correctly marked as not-found       {report['correctly_not_found']}\n"
        f"Incorrectly marked as not-found     {report['incorrectly_not_found']}\n\n"
        f"Custom Error                        {report['custom_error']}"
    )


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="doppel-tpu-torch", description=__doc__.split("\n\n")[0])
    p.add_argument("--version", action="version", version=f"%(prog)s, version {__version__}")
    p.add_argument("-v", "--verbose", action="count", default=None,
                   help="Make output more verbose. Use more v's for more verbosity.")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: 'cuda' (the card, default) or 'cpu'.")
    sub = p.add_subparsers(dest="verb", required=True, metavar="VERB")

    def verb(fn, devices=True):
        sp = sub.add_parser(fn.__name__.replace("_", "-"), help=(fn.__doc__ or "").split("\n")[0])
        sp.set_defaults(run=fn)
        # also after the verb; SUPPRESS keeps the global value where absent
        sp.add_argument("--device", default=argparse.SUPPRESS, help=argparse.SUPPRESS)
        if devices:
            sp.add_argument("--devices", type=int, default=0,
                            help="Run on a mesh of N devices: the truth index sharded over "
                                 "the title axis, boosting and the fuzzy and model stages "
                                 "data-parallel. 0 = one device (--device).")
            sp.add_argument("--platform", default=None, choices=["cuda", "cpu"],
                            help="The mesh's devices: 'cuda' (cards 0..N-1) or 'cpu' "
                                 "(default: the type of --device).")
        return sp

    verb(stage_example_data_set, devices=False).add_argument(
        "--source", required=True, help="Directory holding the gzipped example dataset.")
    verb(build_index)
    verb(train_model)
    verb(generate_predictions)
    verb(closest_search_single_title, devices=False).add_argument(
        "-t", "--title-to-search", dest="title", required=True)
    sp = verb(serve)
    sp.add_argument("--warmup", action=argparse.BooleanOptionalAction, default=True,
                    help="Run three predicts before reading input (default: on).")
    sp.add_argument("--profile", default="latency", choices=["latency", "throughput"],
                    help="'latency' (default) takes request-sized shapes (8-query blocks, "
                         "small union buckets and slabs); 'throughput' the batch shapes.")
    verb(get_predictions_accuracy, devices=False)
    return p


def _log_level(count: Optional[int]) -> int:
    if count is None:
        count = int(os.environ.get("LOGGING_LEVEL") or 0)
    if count <= 1:
        return logging.WARNING
    return logging.INFO if count == 2 else logging.DEBUG


def main(argv: Optional[List[str]] = None) -> int:
    """Run one verb; returns the exit code."""
    args = _parser().parse_args(argv)
    logging.basicConfig(stream=sys.stdout, level=_log_level(args.verbose),
                        format="[%(asctime)s]%(levelname)s|%(name)s|%(message)s")
    LOGGER.info("doppelspeller-tpu-torch v%s-%s", __version__, __build__)
    if os.environ.get("DOPPEL_DEBUG_NANS"):
        LOGGER.warning("DOPPEL_DEBUG_NANS is a switch of the JAX package; this package ignores it")
    try:
        args.run(args)
    except CLIError as exc:
        print(f"Error: {exc}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
