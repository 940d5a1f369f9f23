"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

The program under test is ``doppelspeller_tpu_torch``; this module imports
it inside ``run_cell`` only, and never imports the JAX package.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from benchmark import judge as J
from benchmark import roofline
from benchmark.catalog import BENCH_DIR, Catalog
from benchmark.traffic import Traffic, make_traffic
from benchmark.world import World

MODEL_FILE = os.path.join(BENCH_DIR, "model", "bench_model_r60.npz")
FORBIDDEN = ("jax", "jaxlib", "flax", "doppelspeller_tpu")
# nothing below this reads or writes the matcher's data folder; it is named
# inside the checkout so that a stray read finds nothing
DATA_DIR = os.path.join(BENCH_DIR, ".data")


class Refused(RuntimeError):
    """The run cannot be measured here (no card, too few cards, JAX loaded)."""


@dataclass
class Run:
    """What a finished run hands its metric readers."""

    cell: str
    kind: str                                   # "batch" or "serve"
    t_start: float = 0.0                        # process start, host clock
    seconds: float = 0.0                        # the window's length
    setup_s: float = 0.0
    setup_parts: Dict[str, float] = field(default_factory=dict)
    init_seconds: Dict[str, float] = field(default_factory=dict)
    first_predict_s: float = 0.0
    queries: int = 0
    predicts: List[Dict] = field(default_factory=list)     # batch: encode_s, predict_s, stages
    latencies_ms: List[float] = field(default_factory=list)  # serve, every request of the window
    lag_s: List[float] = field(default_factory=list)
    trace: Optional[object] = None              # trace.TraceReading of the profiled slice
    trace_units: int = 0
    roofline: Optional[Dict[str, float]] = None
    window_captures: int = 0
    actual: List[int] = field(default_factory=list)   # the world's ids of the judged answers


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _captures(matcher) -> int:
    from doppelspeller_tpu_torch.ops.serve_fused import FusedServe

    graphs = sum(sum(v) for v in matcher.scorer.workers.captures.values())
    return graphs + FusedServe.captures


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             catalog: Optional[Catalog] = None, t_start: Optional[float] = None,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True),
             tamper: Optional[Callable] = None, on_run: Optional[Callable] = None) -> Dict:
    """Run ``cell`` once and return the result line's object.  ``tamper``
    (tests only) is called with the matcher after set-up, ``on_run`` with
    the finished ``Run``."""
    t_start = time.time() if t_start is None else t_start
    cat = catalog or Catalog()
    wl = cat.workload(cell)
    config = cat.config(wl["config"])
    spec = cat.traffic(wl["traffic"])
    limits = cat.limits(cell)
    precision = config["precision"]
    chips = int(wl["chips"])
    # the interpreter, torch and the benchmark's own imports come first
    parts: Dict[str, float] = {"start": time.time() - t_start}

    t = time.time()
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise Refused(f"cell {cell} needs {chips} cards, have {torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.init()
    from doppelspeller_tpu_torch import _build
    from doppelspeller_tpu_torch.cli import LATENCY_PROFILE
    from doppelspeller_tpu_torch.config import Config
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.pipeline import Matcher
    from doppelspeller_tpu_torch.utils.io import TitleSet, single_title_set
    parts["cuda_and_program_imports"] = time.time() - t

    t = time.time()
    world = World(int(config["truth_titles"]), seed)
    traffic = make_traffic(world, spec, seconds, seed, config.get("batch_queries"))
    parts["world"] = time.time() - t

    t = time.time()
    overrides = dict(config["matcher"])
    if traffic.profile == "latency":
        overrides.update(LATENCY_PROFILE)
    elif traffic.profile:
        raise ValueError(f"unknown profile {traffic.profile!r}")
    cfg = Config(data_path=DATA_DIR, **overrides)
    truth = TitleSet.from_titles(world.titles, ids=np.arange(1, len(world.titles) + 1, dtype=np.int64),
                                 config=cfg)
    with np.load(MODEL_FILE) as z:
        model_arrays = {k: z[k] for k in z.files}
    matcher = Matcher(cfg, truth=truth, model=GBTModel.from_arrays(model_arrays), device=device,
                      use_index_checkpoint=False)
    parts["matcher"] = time.time() - t
    run = Run(cell=cell, kind="batch" if traffic.loop == "closed" else "serve", t_start=t_start,
              setup_parts=parts, init_seconds=dict(matcher.init_seconds))
    if tamper is not None:
        tamper(matcher)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    if traffic.loop == "closed":
        answers, attempted, failed = _batch(matcher, traffic, cfg, seconds, trace, run, sync, log,
                                            TitleSet, torch, seed)
    else:
        answers, attempted, failed = _serve(matcher, traffic, cfg, seconds, trace, run, sync, log,
                                            single_title_set, torch)
    memory_peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or the JAX package are loaded: {found}")
    log(f"# setup_s {run.setup_s:.4f} = " + " + ".join(f"{k} {v:.4f}" for k, v in run.setup_parts.items()))
    log(f"# matcher init_seconds {json.dumps(run.init_seconds)}; kernels built in this run: "
        f"{_build.BUILD_SECONDS}")
    log(f"# window {run.seconds:.4f} s, {attempted} queries attempted, {failed} failed, "
        f"{run.window_captures} graph captures inside it")
    if device == "cuda":
        log(f"# card (name, power limit): {_card()}")
    del matcher, truth
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t = time.time()
    ref = J.Reference(world.titles, dict(config["matcher"]), model_arrays, device)
    batches = traffic.pool if traffic.loop == "closed" else [[]]
    numbers = ref.judge(answers, batches, precision)
    rec = ref.record
    log(f"# the reference's own top-k decides as the program did on {rec['own_topk_agree']:.4f} of "
        f"the {rec['past_exact']} sampled queries past the exact stage (a record, not a gate)")
    if rec["without_candidates"]:
        log(f"# no candidates were copied out of the timed path for {rec['without_candidates']} of them: "
            f"the hooks (Matcher.scorer.topk_device, Matcher._fused_engine().dispatch) are no longer "
            f"on the path; those are judged end to end, on the reference's own top-k")
    acc = float(np.mean([a.title_id == b for a, b in zip(answers, run.actual)])) if answers else float("nan")
    log(f"# accuracy against the world's actual ids on the {len(answers)} sampled answers: "
        f"{acc:.4f} (a record, not a gate)")
    if trace and run.kind == "batch":
        _roofline(ref, traffic, run, cfg, precision)
    log(f"# reference check {time.time() - t:.2f} s")
    correct = J.verdict(numbers, limits, failed)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cat.metrics(section, cell):
        value = cat.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in run.trace.device_ops],
                               "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    numbers = {name: v for name, v in numbers.items() if v is not None}      # the ones compared
    result["checks"] = {name: {"value": v, "limit": limits[name]} for name, v in numbers.items()}
    if on_run is not None:
        on_run(run)
    for name, v in numbers.items():
        log(f"check {name} {v} limit {limits[name]}")
    return result


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them (a card
    set below 700 W runs slower)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().replace("\n", "; ")


def _profile(torch, on: bool):
    if not on:
        return nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _span(torch, name: str, on: bool):
    return torch.profiler.record_function(name) if on else nullcontext()


def _batch(matcher, traffic: Traffic, cfg, seconds, trace, run: Run, sync, log, TitleSet, torch,
           seed: int):
    """The closed loop: one caller, predicts back to back over the pool."""
    n = len(traffic.pool[0])
    ids = np.arange(n, dtype=np.int64)
    scorer = matcher.scorer
    orig_topk = scorer.topk_device
    state = {"batch": None, "tap": None}

    def tapped(queries, k=None, rows=None):
        vals, pos = orig_topk(queries, k=k, rows=rows)
        b = state["batch"]
        if b is not None and rows is not None:
            # a predict drawn for judging: its sampled rows' candidates,
            # copied out where the cascade synchronizes after retrieval
            # anyway
            inv = np.full(len(queries), -1, dtype=np.int64)
            inv[np.asarray(rows)] = np.arange(len(rows))
            want = traffic.sample_rows[b]
            j = inv[want]
            keep = j >= 0
            sel = torch.from_numpy(j[keep]).to(vals.device)
            state["tap"] = (want[keep], vals[sel].cpu().numpy(), pos[sel].cpu().numpy())
        return vals, pos

    scorer.topk_device = tapped

    def predict(b: int, on_trace: bool = False):
        state["tap"] = None
        e0 = time.time()
        with _span(torch, "bench.encode", on_trace):
            qs = TitleSet.from_titles(traffic.pool[b], ids=ids, config=cfg)
        e1 = time.time()
        with _span(torch, "bench.predict", on_trace):
            res = matcher.predict(qs)
            sync()
        return res, e1 - e0, time.time() - e1

    # warm-up: the pool in turn, twice: a graph key runs op by op in the
    # first predict that uses it and is captured in the next, so after two
    # passes the window captures nothing (it reports what it captured)
    passes = []
    for p in range(2):
        before = _captures(matcher)
        t = time.time()
        for b in range(len(traffic.pool)):
            t1 = time.time()
            predict(b)
            if p == 0 and b == 0:
                run.first_predict_s = time.time() - t1
        passes.append((time.time() - t, _captures(matcher) - before))
    log(f"# warm-up passes (seconds, graph captures): {passes}")
    run.setup_parts["warm_up"] = sum(s for s, _ in passes)

    # each pool batch is judged in one of its predicts of the window, drawn
    # from the seed among those the window is expected to hold (from the
    # warm-up's second pass); only that predict copies candidates out
    pool = len(traffic.pool)
    expect = max(1, int(0.9 * seconds / max(passes[-1][0], 1e-6)))
    rng = np.random.default_rng([seed, 11])
    judged = {b: b + pool * int(rng.integers(expect)) for b in range(pool)}
    answers: Dict[int, list] = {}
    captures0 = _captures(matcher)
    i = failed = 0
    t0 = time.time()
    run.setup_s = t0 - run.t_start
    while True:
        b = i % pool
        state["batch"] = b if judged[b] == i else None
        try:
            res, enc, pred = predict(b)
            if judged[b] == i:
                answers[b] = _answers(traffic, b, res, state["tap"])
            stages = dict(res.stage_seconds)
        except Exception as exc:                       # a predict that raises fails its queries
            log(f"# predict {i} raised {type(exc).__name__}: {exc}")
            failed += n
            enc = pred = float("nan")
            stages = {}
        run.predicts.append({"encode_s": enc, "predict_s": pred, "batch": b, "stages": stages})
        i += 1
        if time.time() - t0 >= seconds:
            break
    run.seconds = time.time() - t0
    run.queries = i * n
    run.window_captures = _captures(matcher) - captures0
    late = [b for b in range(pool) if judged[b] >= i]
    if late:
        # the window closed before these batches' drawn predicts: each is
        # judged in one more predict of the same path, after the window
        log(f"# the window held {i} predicts; batches {late} judged in a predict after it")
        for b in late:
            state["batch"] = b
            res, _, _ = predict(b)
            answers[b] = _answers(traffic, b, res, state["tap"])
    state["batch"] = None
    per = np.array([[p["encode_s"], p["predict_s"]] for p in run.predicts])
    log(f"# {i} predicts; encode s min/median/max {per[:, 0].min():.4f} / {np.median(per[:, 0]):.4f} / "
        f"{per[:, 0].max():.4f}; predict s {per[:, 1].min():.4f} / {np.median(per[:, 1]):.4f} / "
        f"{per[:, 1].max():.4f}")
    if trace:
        with _profile(torch, True) as prof:
            for u in range(traffic.trace_units):
                b = (i + u) % len(traffic.pool)
                res, enc, pred = predict(b, on_trace=True)
                run.predicts.append({"encode_s": enc, "predict_s": pred, "batch": b,
                                     "stages": dict(res.stage_seconds), "traced": True})
        from benchmark.trace import read_events
        run.trace = read_events(prof.profiler.kineto_results.events())
        run.trace_units = traffic.trace_units
    scorer.topk_device = orig_topk
    out = []
    for b in range(pool):
        if b in answers:
            out += answers[b]
            run.actual += [traffic.pool_actual[b][r] for r in traffic.sample_rows[b]]
    return out, run.queries, failed


def _answers(traffic: Traffic, b: int, res, tap) -> List[J.Answer]:
    """The answers of pool batch ``b``'s sampled rows in one predict."""
    tap_rows, tap_vals, tap_pos = tap if tap is not None else (np.zeros(0, np.int64), None, None)
    where = {int(r): j for j, r in enumerate(tap_rows)}
    out = []
    for r in traffic.sample_rows[b]:
        a = J.Answer(traffic.pool[b][r], b, False, int(res.match_title_id[r]), int(res.stage[r]),
                     float(res.prediction[r]))
        if int(r) in where:
            a.cand = tap_pos[where[int(r)]].astype(np.int64)
            a.scores = tap_vals[where[int(r)]]
        out.append(a)
    return out


def _serve(matcher, traffic: Traffic, cfg, seconds, trace, run: Run, sync, log, single_title_set,
           torch):
    """The open loop: single titles due on the traffic's schedule, each timed
    from when it was due."""
    fused = matcher._fused_engine()
    orig = fused.dispatch
    state = {"cand": None, "tap": False}

    def tapped(queries, rows, eager=False):
        out = orig(queries, rows, eager)
        if state["tap"]:                   # a request drawn for judging
            state["cand"] = out[2][0].astype(np.int64).copy()
        return out

    fused.dispatch = tapped

    def serve(title: str, tap: bool = False):
        state["cand"], state["tap"] = None, tap
        res = matcher.predict(single_title_set(title, cfg), single=True)
        sync()
        return res

    # warm-up: one request of each transformed length the run will send,
    # until a pass captures nothing
    seen, warm = set(), []
    for title in traffic.requests:
        n = len(single_title_set(title, cfg).transformed[0])
        if n not in seen:
            seen.add(n)
            warm.append(title)
    passes = []
    for p in range(3):
        before = _captures(matcher)
        t = time.time()
        for title in warm:
            t1 = time.time()
            res = serve(title)
            if not run.first_predict_s and int(res.stage[0]) != 1:
                # the first request that reaches the device (an exact copy
                # is answered on the host)
                run.first_predict_s = time.time() - t1
        passes.append((time.time() - t, _captures(matcher) - before))
        if passes[-1][1] == 0:
            break
    log(f"# warm-up: {len(warm)} titles, passes (seconds, graph captures): {passes}")
    run.setup_parts["warm_up"] = sum(s for s, _ in passes)

    outputs: Dict[int, tuple] = {}
    sampled = set(int(i) for i in traffic.sample)
    failed = 0
    captures0 = _captures(matcher)

    def window(lo: int, hi: int, on_trace: bool):
        nonlocal failed
        t0 = time.perf_counter()
        base = traffic.due[lo]
        for i in range(lo, hi):
            due = t0 + traffic.due[i] - base
            now = time.perf_counter()
            if now < due:
                with _span(torch, "bench.wait", on_trace):
                    time.sleep(due - now)
            start = time.perf_counter()
            try:
                with _span(torch, "bench.request", on_trace):
                    res = serve(traffic.requests[i], i in sampled)
                lat = (time.perf_counter() - due) * 1e3
                if i in sampled:
                    outputs[i] = (int(res.match_title_id[0]), int(res.stage[0]),
                                  float(res.prediction[0]), state["cand"])
            except Exception as exc:                     # a failed request misses every limit
                log(f"# request {i} raised {type(exc).__name__}: {exc}")
                failed += 1
                lat = float("inf")
            if i < traffic.n_window:
                run.latencies_ms.append(lat)
                run.lag_s.append(max(0.0, start - due))
        return time.perf_counter() - t0

    run.setup_s = time.time() - run.t_start
    run.seconds = window(0, traffic.n_window, False)
    run.queries = traffic.n_window
    run.window_captures = _captures(matcher) - captures0
    lag = np.asarray(run.lag_s)
    log(f"# generator lag: mean {lag.mean() * 1e3:.3f} ms, p95 {np.percentile(lag, 95) * 1e3:.3f} ms, "
        f"max {lag.max() * 1e3:.3f} ms over {len(lag)} requests")
    if trace:
        with _profile(torch, True) as prof:
            window(traffic.n_window, len(traffic.requests), True)
        from benchmark.trace import read_events
        run.trace = read_events(prof.profiler.kineto_results.events())
        run.trace_units = len(traffic.requests) - traffic.n_window
    fused.dispatch = orig
    answers = []
    for i in traffic.sample:
        if int(i) not in outputs:
            continue
        tid, stage, pred, cand = outputs[int(i)]
        answers.append(J.Answer(traffic.requests[i], 0, True, tid, stage, pred, cand, None))
        run.actual.append(traffic.actual[i])
    return answers, traffic.n_window, failed


def _roofline(ref: J.Reference, traffic: Traffic, run: Run, cfg, precision: Dict) -> None:
    """Retrieval's least time per pool batch, against its measured seconds."""
    from benchmark.reference.text import transform_title, trigram_lists

    work = []
    for batch in traffic.pool:
        tq = [transform_title(q) for q in batch]
        past = [t for t in tq if t not in ref.exact]
        qb = int(cfg.fold_query_block or cfg.query_block) if ref.index.folded else int(cfg.query_block)
        work.append(roofline.retrieval_work(ref.index, trigram_lists(past), qb))
    window = [p for p in run.predicts if p["stages"]]
    least = sum(roofline.least_seconds([work[p["batch"]]], precision["coarse"]) for p in window)
    spent = sum(p["stages"]["retrieval"] for p in window)
    run.roofline = {"least_s": least, "retrieval_s": spent}
