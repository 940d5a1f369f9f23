"""The per-layer metrics read from the program's spans: a tiny traced
rehearsal reports each of them in its batch and serve cells, each stage's
host seconds and its waits make up its span, which is its
``stage_seconds`` entry; with nothing recorded every reader returns
None."""

import time

import pytest

from benchmark.drive import Run, run_cell
from benchmark.spans import children, off_host_ns, program_spans
from benchmark.tests.helpers import one_thread, tiny_catalog

BATCH = ("retrieval_host_s.batch", "fuzzy_host_s.batch", "model_host_s.batch",
         "model_widened_pct.batch", "matcher_text_s")
SERVE = ("host_ms.serve", "matcher_text_s")


def test_a_traced_rehearsal_reports_the_span_metrics(tmp_path):
    one_thread()
    cat = tiny_catalog(str(tmp_path))
    runs = []
    out = run_cell("tiny-exact.batch", 2**31 + 5, 0.5, True, device="cpu", catalog=cat,
                   log=lambda s: None, on_run=runs.append)
    assert out["correct"], out["checks"]
    for name in BATCH:
        assert out["metrics"][name]["value"] >= 0.0, name
    assert "host_ms.serve" not in out["metrics"]
    run = runs[0]
    traced = [p for p in run.predicts if p.get("traced")]
    spans = program_spans(run)
    kids = children(spans)
    for stage in ("retrieval", "fuzzy", "model"):
        stage_spans = [s for s in spans if s.name == f"doppel.{stage}"]
        assert len(stage_spans) == len(traced) >= 1
        for s, p in zip(stage_spans, traced):
            assert s.duration_ns / 1e9 == p["stages"][stage]
            assert 0 < off_host_ns(s, kids) < s.duration_ns
    out = run_cell("tiny-exact.serve", 2**31 + 6, 0.5, True, device="cpu", catalog=cat,
                   log=lambda s: None)
    assert out["correct"], out["checks"]
    for name in SERVE:
        assert out["metrics"][name]["value"] > 0.0, name
    assert not set(BATCH[:4]) & set(out["metrics"])


@pytest.mark.parametrize("kind", ["batch", "serve"])
def test_every_reader_returns_none_on_an_empty_store(tmp_path, kind):
    from doppelspeller_tpu_torch.utils import timing

    cat = tiny_catalog(str(tmp_path))
    timing.clear()
    run = Run(cell="tiny", kind=kind, t_start=time.time(), trace_units=3)
    for name in BATCH + SERVE:
        assert cat.reader(name)(run) is None, name
