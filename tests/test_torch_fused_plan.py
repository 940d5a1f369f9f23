"""The one-dispatch request's plan span and the benchmark's readers of it.

A traced single title on the one-dispatch path records ``doppel.fused.plan``
under ``doppel.fused``: on the folded engine with ``folded`` 1, its one
query row and kernel A's 128-query tile, on the exact engine with
``folded`` 0 and no A tile counted.  ``kernel_a_roofline_pct.serve`` and
``fused_plan_ms.serve`` (``benchmark/metrics/``) read the expected values
from hand-recorded spans and a hand-built trace of the 500k served cell,
and None without a trace or without spans.  Torch on one thread.
"""

import os
import sys
import time

import pytest
import torch

from doppelspeller_tpu_torch.config import Config
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.pipeline import Matcher
from doppelspeller_tpu_torch.synthetic import make_synthetic_world
from doppelspeller_tpu_torch.utils import timing
from doppelspeller_tpu_torch.utils.io import single_title_set
from test_torch_helpers import MODEL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.catalog import Catalog  # noqa: E402
from benchmark.drive import Run  # noqa: E402
from benchmark.trace import TraceReading  # noqa: E402

CELL = "titles-500k-latency.serve"
A_NAME = "void__anonymous_namespace_::score_window_kernel_1__2__unsigned_c"
# one folded block of the cell: 2 hashes x 512 buckets x 500,000 titles / 8
BLOCK_BYTES = 2 * 512 * 500_000 / 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def serve_world():
    cfg, truth, queries, _ = make_synthetic_world(2048, 64, config=Config(data_path="data"))
    return cfg, truth, queries


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("mode, folded, a_queries", [("folded", 1, 128), ("exact", 0, 0)])
def test_a_traced_request_records_its_plan(serve_world, mode, folded, a_queries):
    cfg, truth, queries = serve_world
    cfg = cfg.with_(retrieval_mode=mode, query_block=8)
    m = Matcher(cfg, truth, GBTModel.load(str(MODEL)), device="cpu", use_index_checkpoint=False)
    assert m._fused_engine().mode == mode
    title = next(t for t, tr in zip(queries.titles, queries.transformed) if tr not in m.reverse)
    m.predict(single_title_set(title, cfg), single=True)
    timing.clear()
    with _profile():
        m.predict(single_title_set(title, cfg), single=True)
    spans = timing.recorded()
    by_id = {s.id: s for s in spans}
    fused = [s for s in spans if s.name == "doppel.fused"]
    plans = [s for s in spans if s.name == "doppel.fused.plan"]
    assert len(fused) == len(plans) == 1
    assert fused[0].counts["rows"] == 1 and fused[0].counts["folded"] == folded
    assert by_id[plans[0].parent] is fused[0]
    assert plans[0].counts["folded"] == folded
    assert plans[0].counts["a_queries"] == a_queries
    assert plans[0].counts["query_rows"] == 1
    assert plans[0].counts["lq"] in (cfg.max_query_trigrams, 128, 253)
    assert 0 < plans[0].duration_ns < fused[0].duration_ns
    table = timing.span_table(spans)
    row = next(line for line in table.splitlines() if line.startswith("doppel.fused.plan "))
    assert f"folded={folded}" in row and f"a_queries={a_queries}" in row and "query_rows=1" in row


def _recorded(requests: int, folded: int = 1, wait_s: float = 0.002):
    """Spans as the program records ``requests`` traced one-dispatch
    requests: each a ``doppel.fused`` holding a plan that waits once."""
    with _profile():
        for _ in range(requests):
            with timing.span("doppel.fused", rows=1, folded=folded):
                with timing.span("doppel.fused.plan", folded=folded, lq=64, query_rows=1,
                                 a_queries=128 * folded):
                    time.sleep(0.001)
                    with timing.span("doppel.fused.plan.wait"):
                        time.sleep(wait_s)


def _run(t_start=None, trace_units=4, a_seconds=1e-3, kind="serve", cell=CELL, traced=True):
    trace = TraceReading(window_s=1.0, busy_s=0.01, launches=3,
                         device_ops=[(A_NAME, a_seconds), ("void_at::native::copy", 5e-4)])
    return Run(cell=cell, kind=kind, t_start=time.time() if t_start is None else t_start,
               trace=trace if traced else None, trace_units=trace_units if traced else 0)


def test_the_readers_on_a_hand_built_run():
    cat = Catalog()
    timing.clear()
    run = _run()
    _recorded(2)
    _recorded(1, folded=0)                         # an exact-engine request scans no folded block
    want = 100.0 * 2 * BLOCK_BYTES / 3.35e12 / 1e-3
    assert cat.reader("kernel_a_roofline_pct.serve")(run) == pytest.approx(want, rel=1e-12)
    assert 3.8 < want < 3.9
    plans = [s for s in timing.recorded() if s.name == "doppel.fused.plan"]
    waits = [s for s in timing.recorded() if s.name == "doppel.fused.plan.wait"]
    host_ns = sum(s.duration_ns for s in plans) - sum(s.duration_ns for s in waits)
    got = cat.reader("fused_plan_ms.serve")(run)
    assert got == pytest.approx(host_ns / 1e6 / run.trace_units, rel=1e-12)
    assert got < sum(s.duration_ns for s in plans) / 1e6 / run.trace_units


def test_the_readers_return_none_without_a_trace_or_spans():
    cat = Catalog()
    a_reader, plan_reader = cat.reader("kernel_a_roofline_pct.serve"), cat.reader("fused_plan_ms.serve")
    timing.clear()
    empty = _run()
    assert a_reader(empty) is None and plan_reader(empty) is None
    t0 = time.time()
    _recorded(2)
    assert a_reader(_run(t0)) > 0.0 and plan_reader(_run(t0)) > 0.0
    assert a_reader(_run(t0, traced=False)) is None and plan_reader(_run(t0, traced=False)) is None
    assert a_reader(_run(t0, a_seconds=0.0)) is None            # no kernel A in the slice
    assert a_reader(_run(t0, kind="batch")) is None and plan_reader(_run(t0, kind="batch")) is None
    assert a_reader(_run(t0, cell="no-such-cell")) is None
