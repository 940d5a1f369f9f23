"""The port's program spans (``utils/timing.py``): nothing is recorded and no
profiler range is opened while no profiler runs; under ``torch.profiler``
a predict's spans nest as the cascade runs, carry its call id, agree with
``stage_seconds`` and the model waves' rows, and lie on the profiler's
clock; spans on many threads keep their own parents in a bounded store;
the verbs' exporter logs the spans by name with their counts summed."""

import logging
import os
import pathlib
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from doppelspeller_tpu_torch import synthetic
from doppelspeller_tpu_torch.models.gbt import GBTModel
from doppelspeller_tpu_torch.pipeline import STAGE_EXACT, Matcher
from doppelspeller_tpu_torch.utils import timing
from doppelspeller_tpu_torch.utils.io import single_title_set

MODEL = pathlib.Path(__file__).resolve().parents[1] / "doppelspeller_tpu_torch" / "assets" / "bench_model_r60.npz"
STAGES = ("exact", "retrieval", "fuzzy", "model")
# a span's start (time.time_ns) and end (its start plus a perf_counter
# duration) against its parent's: two clocks, read microseconds apart
CLOCKS_NS = 50_000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 2,048-title world's matcher (waves forced), built and run once under
    the profiler with ``DOPPEL_DUMP_WAVES`` set."""
    cfg, truth, queries, actual = synthetic.make_synthetic_world(2048, 96)
    cfg = cfg.with_(cascade_impl="device")
    model = GBTModel.load(str(MODEL))
    dump = str(tmp_path_factory.mktemp("waves") / "waves.npz")
    timing.clear()
    os.environ["DOPPEL_DUMP_WAVES"] = dump
    try:
        with _profile() as prof:
            t = time.perf_counter()
            m = Matcher(cfg, truth, model, device="cpu", use_index_checkpoint=False)
            built_s = time.perf_counter() - t
            res = m.predict(queries)
    finally:
        os.environ.pop("DOPPEL_DUMP_WAVES", None)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("doppel.") and str(e.device_type()).endswith("CPU")]
    return SimpleNamespace(cfg=cfg, queries=queries, actual=actual, matcher=m, built_s=built_s,
                           res=res, spans=timing.recorded(), events=events, waves=dict(np.load(dump)))


def _predict_spans(spans):
    """The last ``doppel.predict`` root and every span of its call, by id."""
    root = [s for s in spans if s.name == "doppel.predict"][-1]
    return root, {s.id: s for s in spans if s.call == root.id}


def _children(parent, spans):
    return sorted((s for s in spans.values() if s.parent == parent.id), key=lambda s: s.start_ns)


def test_no_profiler_records_nothing_and_opens_no_range(world, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler active")

    monkeypatch.setattr(timing._profiler, "record_function", refuse)
    timing.clear()
    m = world.matcher
    res = m.predict(world.queries)
    single = m.predict(single_title_set(world.queries.titles[1], world.cfg), single=True)
    assert timing.recorded() == []
    for r in (res, single):
        assert set(r.stage_seconds) == set(STAGES)
        assert all(v >= 0.0 for v in r.stage_seconds.values())
    assert all(res.stage_seconds[k] > 0.0 for k in STAGES)
    np.testing.assert_array_equal(res.match_title_id, world.res.match_title_id)


def test_waves_predict_spans_nest_in_stage_order(world):
    root, spans = _predict_spans(world.spans)
    assert root.parent is None and root.call == root.id
    assert root.counts == {"queries": len(world.queries), "path": "waves"}
    names = [s.name for s in _children(root, spans)]
    assert names == ["doppel.exact", "doppel.plan", "doppel.retrieval", "doppel.fuzzy", "doppel.model"]
    for s in spans.values():
        assert s.thread == root.thread
        if s.parent is None:
            continue
        p = spans[s.parent]
        assert s.start_ns >= p.start_ns - CLOCKS_NS, s.name
        assert s.start_ns + s.duration_ns <= p.start_ns + p.duration_ns + CLOCKS_NS, s.name
    # every span opened inside the predict belongs to its call
    inside = [s for s in world.spans
              if root.start_ns <= s.start_ns <= root.start_ns + root.duration_ns]
    assert len(inside) == len(spans) and all(s.call == root.id for s in inside)
    waits = {s.name for s in spans.values() if s.name.endswith(".wait")}
    assert {"doppel.retrieval.wait", "doppel.fuzzy.wait", "doppel.model.wave.wait"} <= waits
    # the queries' token-sorted and spaceless encodings are built at their
    # first use, in the fuzzy and the model stage
    lazy = {s.name: spans[s.parent].name for s in spans.values()
            if s.name in ("doppel.encode.token_sort", "doppel.encode.wo")}
    assert lazy == {"doppel.encode.token_sort": "doppel.fuzzy", "doppel.encode.wo": "doppel.model"}


def test_stage_spans_are_stage_seconds(world):
    root, spans = _predict_spans(world.spans)
    stages = {s.name.split(".")[1]: s for s in _children(root, spans) if s.name != "doppel.plan"}
    assert set(stages) == set(STAGES)
    table = timing.self_seconds(list(spans.values()))
    for name, s in stages.items():
        assert s.duration_ns / 1e9 == world.res.stage_seconds[name], name
        # the stage's own time and its children's (its waits among them)
        # make up the stage
        kids = _children(s, spans)
        own = s.duration_ns - sum(k.duration_ns for k in kids)
        assert own >= 0, name
        if name == "retrieval":
            assert [k.name for k in kids] == ["doppel.retrieval.wait"]
    assert table["doppel.exact"][0] == 1
    assert table["doppel.retrieval"][1] == pytest.approx(world.res.stage_seconds["retrieval"])
    assert 0 <= table["doppel.retrieval"][2] <= table["doppel.retrieval"][1]
    # construction's pieces are spans too, one per init_seconds key, whose
    # seconds are the key's
    init = {s.name: s for s in world.spans if s.name.startswith("doppel.init.")}
    assert set(init) == {f"doppel.init.{k}" for k in world.matcher.init_seconds}
    for k, v in world.matcher.init_seconds.items():
        assert init[f"doppel.init.{k}"].duration_ns / 1e9 == v, k
    assert sum(world.matcher.init_seconds.values()) <= world.built_s


def test_wave_counts_agree_with_the_result(world):
    root, spans = _predict_spans(world.spans)
    res = world.res
    model = next(s for s in spans.values() if s.name == "doppel.model")
    waves = {s.counts["wave"]: s for s in spans.values() if s.name == "doppel.model.wave"}
    assert set(waves) == {"a", "b"}
    fuzzy = next(s for s in spans.values() if s.name == "doppel.fuzzy")
    past_exact = int((res.stage != STAGE_EXACT).sum())
    assert fuzzy.counts["rows"] == past_exact
    assert fuzzy.counts["hits"] == res.stage_counts["fuzzy"]
    # wave A scores every row that reaches stage 3, wave B the rows widened
    assert waves["a"].counts["rows"] == model.counts["rows"] == past_exact - res.stage_counts["fuzzy"]
    assert waves["b"].counts["rows"] == len(world.waves["widen"]) > 0
    assert model.counts["hits"] == res.stage_counts["model"]
    for w in waves.values():
        assert w.counts["slabs"] >= 1
        assert [k.name for k in _children(w, spans)] == ["doppel.model.wave.wait"]


def test_the_span_table_sums_each_count(world):
    root, spans = _predict_spans(world.spans)
    res = world.res
    totals = timing.count_totals(list(spans.values()))
    assert totals["doppel.predict"] == {"queries": len(world.queries), "path": {"waves": 1}}
    assert totals["doppel.model.wave"]["wave"] == {"a": 1, "b": 1}
    waves = [s for s in spans.values() if s.name == "doppel.model.wave"]
    assert totals["doppel.model.wave"]["rows"] == sum(s.counts["rows"] for s in waves)
    assert totals["doppel.fuzzy"]["hits"] == res.stage_counts["fuzzy"]
    assert totals["doppel.exact"]["hits"] == res.stage_counts["exact"]
    # the exporter's table prints them beside each name's seconds
    rows = {line.split()[0]: line.split()[4:] for line in
            timing.span_table(list(spans.values())).splitlines()[1:]}
    assert rows["doppel.predict"] == [f"queries={len(world.queries)}", "path=waves:1"]
    assert "wave=a:1,b:1" in rows["doppel.model.wave"]
    assert f"hits={res.stage_counts['model']}" in rows["doppel.model"]


def test_single_title_on_the_fused_path(world):
    q = world.queries
    title = next(t for t, tr in zip(q.titles, q.transformed) if tr not in world.matcher.reverse)
    timing.clear()
    with _profile():
        res = world.matcher.predict(single_title_set(title, world.cfg), single=True)
    spans = timing.recorded()
    encode = [s for s in spans if s.name == "doppel.encode"]
    # one title is under the flat route's size rule: it takes the per-title loops
    assert len(encode) == 1 and encode[0].parent is None
    assert encode[0].counts == {"titles": 1, "per_title": 1}
    root, mine = _predict_spans(spans)
    assert root.counts["path"] == "fused"
    assert [s.name for s in _children(root, mine)] == ["doppel.exact", "doppel.fused"]
    fused = next(s for s in mine.values() if s.name == "doppel.fused")
    assert "doppel.fused.wait" in [s.name for s in _children(fused, mine)]
    assert fused.counts["rows"] == 1
    assert 0.0 < res.stage_seconds["retrieval"] <= fused.duration_ns / 1e9


def test_span_starts_lie_on_the_profilers_clock(world):
    stored, events = {}, {}
    for s in world.spans:
        stored.setdefault(s.name, []).append(s.start_ns)
    for e in world.events:
        events.setdefault(e.name(), []).append(e.start_ns())
    assert set(stored) == set(events)
    for name, starts in stored.items():
        assert len(starts) == len(events[name]), name
        gaps = np.abs(np.sort(starts) - np.sort(events[name]))
        assert gaps.max() < 1_000_000, (name, gaps.max())


def test_spans_on_eight_threads_keep_their_parents():
    rec = timing.Recorder(bound=1000)
    threads, per = 8, 300
    expect = [dict() for _ in range(threads)]
    start = threading.Barrier(threads)

    def work(t):
        start.wait(timeout=30)
        for i in range(per):
            with rec.span("outer", thread=t) as outer:
                with rec.span("inner", i=i) as inner:
                    expect[t][inner.id] = outer.id

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profile():
            pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in pool)
    kept = rec.recorded()
    assert len(kept) == 1000                            # of 4,800: the newest
    parents = {s.id: s for s in kept if s.name == "outer"}
    wanted = {k: v for e in expect for k, v in e.items()}
    inner = [s for s in kept if s.name == "inner"]
    assert inner
    for s in inner:
        assert s.parent == wanted[s.id] and s.call == s.parent
        if s.parent in parents:
            assert parents[s.parent].thread == s.thread
    assert all(s.parent is None for s in parents.values())
    assert len(timing.recorded()) <= timing.STORE_SPANS


def test_the_verbs_exporter_writes_the_trace_and_logs_the_spans(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("DOPPEL_PROFILE_DIR", str(tmp_path))

    @timing.time_usage
    def verb():
        with timing.span("doppel.outer", rows=3):
            for _ in range(2):
                with timing.span("doppel.outer.wait"):
                    time.sleep(0.01)
        return 7

    with caplog.at_level(logging.INFO, logger=timing.LOGGER.name):
        assert verb() == 7
    trace = list(tmp_path.glob("verb.*.trace.json"))
    assert len(trace) == 1 and "doppel.outer.wait" in trace[0].read_text()
    table = next(r.getMessage() for r in caplog.records if "program spans of [verb]" in r.getMessage())
    rows = {line.split()[0]: line.split()[1:] for line in table.splitlines()[2:]}
    assert rows["doppel.outer"][0] == "1" and rows["doppel.outer.wait"][0] == "2"
    assert rows["doppel.outer"][3:] == ["rows=3"] and rows["doppel.outer.wait"][3:] == []
    total, own = float(rows["doppel.outer"][1]), float(rows["doppel.outer"][2])
    waits = float(rows["doppel.outer.wait"][1])
    assert waits >= 0.02 and own == pytest.approx(total - waits, abs=2e-4)
