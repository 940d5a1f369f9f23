"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py time-predicts [reps]   # phases 10 and 11's predicts alone
    python3 chip_smoke.py time-cli [reps]        # the CLI's verbs, a process each

Phases, each printing its seconds; any failure exits non-zero:

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles the port's CUDA kernels from ``doppelspeller_tpu_torch/csrc``
   (one ``nvcc`` per source, side by side); prints ptxas's registers and
   spills for kernels A and D and fails unless the machine code of each
   holds HGMMA (tensor-core) instructions.
3. kernel A (scoring with window select) against its plain PyTorch version
   at the folded path's shapes (QB=128, U=1024, folds=2, 524,288 titles,
   tb=2048, W=16) and at the exact path's largest union at 150k titles
   (folds=1, a 3,072-row union of a random (50,653, 20,480) packed index,
   163,840 titles, read through ``union_ids``), each with bf16 and with f32
   weights: rtol 1e-5 against plain (gather and scoring) on the same
   rounded weights, titles equal on untied windows; with ids, exactly equal
   to A on the gathered rows, and timed beside kernel C followed by that
   call; time, TFLOP/s and share of the bound.
4. kernel B (sliding-window LCS) against its plain version at model-stage
   shapes (65,536 pairs, TL=64, WL=16 and 32): exactly equal.  After the
   folded main path, once more on the arguments of the largest
   ``window_best`` call that its untimed predict made; in the train phase
   on every call that training made.  Then kernel F (whole-title LCS,
   ``levenshtein.lcs``) against ``lcs_plain`` at the main paths' shapes:
   65,536 pairs at TL 32 and 64 (a fuzzy chunk), 12,800 at TL 64 (a served
   block), 4,096 at 255 (the host redo's widest bucket): exactly equal;
   its time by CUDA events, the plain version's, the bound and the share.
   Both main paths (10, 11) must launch F, and the folded one must never
   call ``lcs_plain``.
5. kernel C (row gather): 3,072 rows of a random (50,653, 65,536) packed
   index (500k titles), exactly equal to ``index_select``, and timed
   beside it in alternating windows.  The kernel and its entry stay;
   ``Matcher.predict`` gathers inside A's and D's loads.
6. kernel D (full Jaccard matrix, the union's rows read straight from the
   packed index): QB=128, U=3,072, 524,288 titles, tb=2048, in f32 (rtol
   1e-5) and with bf16 output (one bf16 ulp) against the plain gather and
   scoring; top-k titles equal wherever the scores are untied.  Also times
   the exact top-k (``select_topk_permuted``) on D's outputs.
7. kernel E (sparse weights, exact top-k on chip) at the same shapes in
   f32, in bf16 and with 60 real titles (k = 100: padding candidates):
   scores to rtol 1e-5 and titles equal on untied slots against the plain
   version; the peak device memory of one call, which must stay under a
   tenth of the dense (QB, ntp) f32 score matrix; timed in alternating
   windows beside the dense route it replaced (densified weights, D with
   f32 out, ``select_topk_permuted``).
8. small worlds: the port on the card against the port's plain CPU path
   (the path the CPU tests hold equal to the JAX package) on a 4,096-title
   world, folded in f32 and exact under the default config; with the
   latter's Matchers also a 100-query predict under the default
   ``cascade_impl`` (under 2,048 rows: every candidate scored, no waves)
   against the CPU run, and one ``predict(single=True)`` that must match.
   Then a 301-title world at k = 100 under the default config, where 62 of
   every row's candidates are padding positions: 120 queries, 300 under
   ``cascade_impl="device"`` and one single title, card against CPU.
9. train: ``synthetic.quick_train_model`` with 60 rounds on the card, on
   the first 50,000 titles of the 500k world (the call that made the
   committed model): exact retrieval for 2,000 train rows (kernel A, every
   launch gathering), the feature matrix of all pairs (kernel B), 60
   boosting rounds.  Both kernels must launch and the model must hold 60
   trees; prints the four timings, the pairs by kind, the last custom
   errors, both AUCs, peak memory and how many trees equal the committed
   model's.  Every launch of A and of B that training made must be a call
   made op by op or part of a graph replay (retrieval captures the block
   shapes it repeats); every call made op by op is then held against the
   plain version on the same arguments (B exactly; A to rtol 1e-5 against
   the plain gather and scoring, titles equal on untied windows), and the
   largest call of each shape is timed.  The run's
   features (2,048 sampled pairs, 1e-5) and its first tree (every row; its
   f32 sums are exact, so it must be equal) are held against the port's
   CPU path.  The same training runs once more and every tree must equal
   the first run's bit for bit (the histograms add in fixed point); both
   boosting times are printed.  After the folded main path its Matcher
   takes this model (``set_model``) and predicts the same 16,384 queries:
   accuracy must reach 0.80; its distance to the committed model's is
   printed.
10. folded main path: 500,000 titles x 16,384 queries (the bench world,
   seed 7), the committed 60-tree model, default Config (folded two-hash
   retrieval, bf16 coarse weights, adaptive model depth); two untimed and
   one timed ``Matcher.predict``.  The card runs a predict as the JAX
   package runs one device: retrieval in groups of ``dispatch_blocks``
   blocks, a CUDA graph a block shape, the fuzzy and model stages a graph a
   padded run of rows, each graph captured in the second predict that
   uses its shape; the first untimed predict is a one-shot process's (op
   by op, nothing captured), the second captures the graphs (both
   predicts' seconds and captures are printed), the timed one replays
   them.  Kernels
   A and B must launch in the timed run (a replay counts the launches its
   capture recorded), every stage must match rows and accuracy must reach
   0.80.
11. exact main path: 150,000 titles x 16,384 queries, default Config
    (``auto`` resolves to exact: bf16, window select, so kernel A with
    folds=1 reading the union's rows through their ids); the same checks,
    with A launching, every launch gathering, and C not at all; then one
    more predict under ``torch.profiler``: the top kernels by device time
    and kernel A's share.
    After each of these two main paths, the one-dispatch path
    (``ops/serve_fused.py``) on the same resident Matcher (default config,
    128-query blocks): one request replayed as a CUDA graph against the
    same request run op by op (stats and candidates equal bit for bit; the
    op-by-op run's calls of A and B against their plain versions); 200
    single titles that the exact stage does not match through
    ``predict(single=True)``, once to capture every shape they need and
    once timed (every request a replay, A and B launched by the replays),
    their p50 and p99 with the card's name and power limit; the first 50
    through ``serve_fused="off"`` (p50, p99), whose results must equal the
    fused ones row for row; each key's capture seconds, one replay's device
    time by CUDA events and its device operations by the profiler (both
    engines' profiler passes after the exact path's timed predict: the
    profiler's first session slows every later predict).  On the
    folded engine also the serve loop's 8-query blocks: 50 single titles
    and a batch of 8, equal to the 128-query blocks' results.
12. oracle anchor: the bench's exact-config oracle (f32, full matrix and
    exact top-k, model depth 0) on every 2nd query of the 500k world, the
    first 6,000; kernel D must launch and C and A must not, and the folded
    path's accuracy on the sample must be within 0.01 of the oracle's (that
    first predict runs op by op); then its top-100 and predict op by op
    (``workers.use_graphs = False``) and through the graphs (captured
    there), which must be equal bit for bit; then one more oracle predict
    under ``torch.profiler``: the top kernels by device time and kernel D's
    share.
13. v1 path: the same sample's query blocks through the v1 entry (kernel
    E, with the planner's weights and bound), launched once per block with
    no launch of C or D, which must agree with the oracle engine's kernel D
    retrieval; then the oracle engine's blocks (weights rebuilt on the
    card, D, ``select_topk_permuted``) against the same blocks through E,
    held equal and timed in alternating windows.
14. mesh: the title-sharded mesh (``parallel/sharded.py``) on two shards of
    the one card, ``Mesh((cuda:0, cuda:0))``: the shard boundaries,
    streams, launches and merges of two cards (one worker thread, a stream
    a shard), timed in turns with the single card's Matcher (through its
    graphs).  The exact 150k world (default config; two shards of 98,304
    padded titles, tb 2,048 like the single card's 163,840, so the windows
    line up): ``Matcher(mesh=)`` construction seconds (built on the mesh,
    each shard's ids, frequencies, sums and matrices on its device), one
    untimed predict op by op (``workers.use_graphs = False``; every call
    of A and B held against the plain version), two untimed predicts
    through the graphs (each shard's captures by name printed: retrieval,
    fuzzy and model; the first runs op by op, the second captures),
    then timed predicts in turns with a single-card
    Matcher (single, mesh, mesh, single), where A must launch twice per
    block, every launch gathering, and each shard replay a retrieval
    graph once a block and the fuzzy and model stages' graphs; ``scorer.topk`` must equal the single card's
    exact engine bit for bit on all 16,384 queries and the predictions
    the single card's row for row (ids, titles, stages, predictions
    exactly); then one predict of each Matcher under torch.profiler
    (host and device activity): the host's launch calls (kernels, graph
    launches, copies) of the mesh beside the single card's, the card's
    busy milliseconds and share of the profiled wall, and the
    milliseconds in which two or more operations ran at once.  The folded
    500k world (two shards of 262,144 titles): the same two untimed
    predicts, where A launches with folds=2 on both shards' folded
    matrices (every call of A and B held against the plain version at
    the shards' shapes; one graph a shard), then timed predicts in turns
    with the folded main path's Matcher and the profiler pass; accuracy
    at least 0.80 and within 0.01 of the single card's; the share of
    rows whose mesh top-k dominates the single card's score by score is
    printed.  The oracle sample through ``build_sharded_index`` under the
    oracle config: D once per shard and block (the first block of each
    shape the warm-up before its capture), A never, candidates equal to
    the single card's bit for bit.  Training: ``quick_train_rows`` and
    ``train_model(..., mesh=)`` with the train phase's 60-round params, each
    tree equal to the train phase's bit for bit (at 50,000 titles both
    shards hold 32,768 padded titles with tb 2,048, so the candidates and
    pairs are the single card's).  Last ``make_mesh()`` over the machine's
    cards: the exact 150k predict on it equals the single card's, and on a
    machine of one card ``make_mesh(2)`` must raise "need 2 devices, have
    1".  Every time is printed with the card's name and power limit.
15. cli: the command-line verbs at the reference example set's size.  One
    world of 30,000 titles and 20,000 queries (seed 7) is written as the
    example set's four pipe-delimited CSVs into a temporary data path
    (truth; the first 5,000 queries with their labels as the train rows, a
    cut from the example set's 10,000 that keeps the phase near a minute;
    the last 10,000 as the test rows and their actuals).  In-process through
    ``cli.main``, each verb with the launch counts set to 0 just before it:
    ``build-index`` (the device build on the card, which must log it; its
    seconds printed with the card's name and power limit); ``train-model`` with the default Config (1,000 rounds,
    early stopping at 50); ``generate-predictions`` (it must load the
    checkpoint); ``get-predictions-accuracy`` (accuracy from its counts at
    least 0.80); ``build-index --devices 1`` and ``generate-predictions
    --devices 1`` (a mesh of one card: it must load the checkpoint onto the
    mesh and write the single device's file).  ``final_output.csv`` must equal an in-process
    ``Matcher.predict`` on the same files and model row for row, and a
    second ``generate-predictions`` and one run of ``python -m
    doppelspeller_tpu_torch.cli generate-predictions`` as a process of its
    own must write the same file.  ``closest-search-single-title`` on a
    truth title must answer its id.  ``serve --profile latency`` answers a
    bare title, an ``{"id", "title"}`` request, two batches of 8 (with the
    single titles, kernel A at unions of 128, 256 and 512 rows) and a
    malformed line as an in-process Matcher under the same overrides does
    (and as one with ``serve_fused="off"``, predictions to 1e-6), then 200
    single titles, whose p50 and p99 ``latency_ms`` are printed with the
    card's name and power limit, and a single title's mean stage seconds
    (the one-dispatch path charges all of a request to retrieval).  Serve's
    requests take the one-dispatch path, so A and B launch there through
    graph replays, which must happen.  A and B must launch in
    ``train-model`` and ``generate-predictions``, A in ``serve``, and C, D
    and E nowhere; every call of A and B (A at serve's unions of 128-512
    rows too) is held against the plain version as in the train phase (in
    ``serve``, the calls of the run op by op before each capture).
16. construction (run after the exact world is made, before the exact
    main path): on the folded 500k world (default config) and the exact
    150k world, ``Matcher`` built four times in turns with the host and
    the device index build (``index_build_impl`` "host", "device",
    "device", "host").  Each build prints its seconds by the host clock
    after a synchronize (``Matcher.init_seconds``: the index's ids, ``df``
    and sums; the retrieval engine's packed matrix, or its two folded
    matrices and trigram list; the rest), its peak device memory and the
    memory it keeps after construction, with the card's name and power
    limit.  Every index array and every buffer of the retrieval engine
    must equal the first build's bit for bit, and so must ``scorer.topk``
    on the first 2,048 queries; a device build may keep no more than a
    host build.  The main paths'
    and the mesh phase's Matchers take the device build (``"auto"``).

17. single_graphs (after the exact path's profiler pass, on the folded and
    exact main paths' resident Matchers, the committed model): one predict
    op by op (``workers.use_graphs = False``, the fuzzy stage in its
    dynamic form) with every call of A and B held against the plain
    version; the top-100 of all 16,384 queries op by op and through the
    graphs, bit for bit on both worlds;
    timed predicts in turns (graphs, op by op, op by op, graphs), each equal
    to the op-by-op run bit for bit (ids, titles, stages, predictions), with
    their seconds, stage seconds, launches and peak device memory; the
    graphs captured and replayed by name, and the two untimed graphed
    predicts' seconds (the main path's); then one predict of each under
    torch.profiler: the host's launch calls (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, copies), the card's operations and busy share.  The
    graphs' kernel and graph launches a predict must stay under 1,000.

The line before the last is a JSON object with every kernel's route,
source, launches in the path that carries it and in the mesh phase, error, times, bound (the
least time the card could take for what these inputs need, from the
published H100 peaks: A, D and E count the products of nonzero weights
only and read only the rows some query weights; B counts the LCS steps its
words and queries need, three 32-bit operations each, and the bytes of
the valid words only) and the
time of one PyTorch call computing the same function where there is one;
the last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(ROOT, "doppelspeller_tpu_torch", "assets", "bench_model_r60.npz")

N_TITLES, N_QUERIES, SEED = 500_000, 16_384, 7
N_TITLES_EXACT = 150_000
ORACLE_QUERIES, ORACLE_DELTA = 6000, 0.01
ACCURACY_FLOOR = 0.80
TRAIN_ROUNDS = 60
# published H100 SXM peaks (NVIDIA's data sheet): dense bf16 tensor cores
# (an exact f32 contraction counts three bf16 passes), HBM; 32-bit integer
# operations at one per FP32 lane and clock (half the 67 TFLOP/s FP32 rate,
# which counts an FMA as two)
BF16_FLOP_PER_S, INT32_OPS_PER_S = 989e12, 33.5e12
HBM_BYTES_PER_S = 3.35e12


def phase(name, t0):
    print(f"# phase {name}: {time.time() - t0:.3f} s", flush=True)


def cuda_ms(fn, reps=5, calls=5):
    """Milliseconds per call of ``fn``: the median over ``reps`` windows of
    ``calls`` back-to-back calls between two CUDA events, after a warm-up
    call.  The host enqueues ahead of the card, so a window measures device
    time rather than launch gaps."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(flop, peak, nbytes):
    """(bound_ms, bound_by): the larger of the operations at ``peak`` and
    the bytes at the HBM rate."""
    ops_ms, bytes_ms = flop / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def contraction_need(w, ids, ntp, dt):
    """What num = w @ bits needs at these inputs, for weights w (QB, U) over
    union rows ``ids`` (U,) of ntp titles each: (flop, bytes of rows).  A
    zero weight needs no product and a row that no query weights needs no
    read, so the products are two per nonzero weight and title (three bf16
    passes for exact f32 weights) and the rows are the distinct ones some
    query weights."""
    nz = w != 0
    flop = 2.0 * float(nz.sum()) * ntp * (3 if dt == "float32" else 1)
    return flop, ids[nz.any(dim=0)].unique().numel() * ntp // 8


def random_rows_inputs(torch, folds, U, ntp, nt, zero_share):
    """Kernel A's inputs at the folded path's shapes: random rows u8 (U,
    ntp/8) and one 128-query block of weights over them."""
    rng = torch.Generator(device="cuda").manual_seed(SEED)
    qb = 128
    rows = (torch.rand((U, ntp), device="cuda", generator=rng) < 0.06)
    rows = (rows.view(U, ntp // 8, 8).to(torch.uint8)
            << torch.arange(8, device="cuda", dtype=torch.uint8)).sum(dim=2, dtype=torch.uint8)
    w = torch.rand((qb, U), device="cuda", generator=rng) * 10.0
    w = torch.where(torch.rand((qb, U), device="cuda", generator=rng) < zero_share, torch.zeros_like(w), w)
    sums = torch.rand(ntp, device="cuda", generator=rng) * 60.0 + 20.0
    sums[nt:] = 0.0
    # the bound is at least any intersection, as on the real path, so no
    # denominator comes near zero (where summation order alone moves scores)
    return dict(rows=rows, ids=None, w=w, sums=sums, maxint=w.sum(dim=1), nt=nt, folds=folds)


def check_kernel_a_at(torch, jk, label, d):
    """Kernel A against its plain version at one shape (QB=128, tb=2048,
    W=16), with bf16 and with f32 weights: scores to rtol 1e-5 against
    plain on the same rounded weights (the products are exact, only the
    summation order differs), titles equal on untied windows.  With
    ``d["ids"]`` the rows are those of the packed index ``d["rows"]``: the
    plain version gathers first, A reads them in its loads and must equal,
    exactly, A on the gathered rows (the same sums in the same order), and
    it is timed beside kernel C followed by that call.  Returns
    {dtype: stats}."""
    src, ids, w, sums, maxint, nt = (d[k] for k in ("rows", "ids", "w", "sums", "maxint", "nt"))
    qb, U = w.shape
    ntp = src.shape[1] * 8
    kw = dict(tb=2048, W=16, folds=d["folds"])
    rows = src if ids is None else jk.gather_rows_plain(src, ids)
    # the dense contraction A runs, for its TFLOP/s
    flop_dense = 2.0 * qb * ntp * U
    out = {}
    for dt in ("bfloat16", "float32"):
        # the bound: the products and rows these weights need, the ids,
        # weights, sums and bound read once, window maxima and titles
        # written once
        flop, row_bytes = contraction_need(w, torch.arange(U, device="cuda") if ids is None else ids,
                                           ntp, dt)
        nbytes = (row_bytes + (0 if ids is None else U * 4) + qb * U * 4 + ntp * 4 + qb * 4
                  + qb * (ntp // kw["W"]) * 8)

        def run():
            return jk.score_window_select(src, w, sums, maxint, nt, score_dtype=dt, union_ids=ids, **kw)

        wk, ak = run()
        wr = jk.round_weights(w, dt)
        wp, ap = jk.score_window_select_plain(rows, wr, sums, maxint, nt, **kw)
        torch.cuda.synchronize()
        err = float((wk - wp).abs().max())
        torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-7)
        untied = jk.untied_windows(rows, wr, sums, maxint, nt, rtol=1e-5, **kw)
        if not torch.equal(ak[untied], ap[untied]):
            raise AssertionError(f"kernel A {dt} ({label}) window titles differ from the plain version")
        ms = cuda_ms(run)
        plain_ms = cuda_ms(lambda: jk.score_window_select_plain(rows, wr, sums, maxint, nt, **kw))
        bound_ms, bound_by = bound(flop, BF16_FLOP_PER_S, nbytes)
        st = {"shape": label, "dtype": dt, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "tflops": flop_dense / ms * 1e-9,
              "share_of_bound": bound_ms / ms}
        print(f"# kernel A {dt} ({label}): max |wmax err| {err:.3e} (rtol 1e-5); titles equal on "
              f"{int(untied.sum())}/{untied.numel()} untied windows; {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms per 128-query block; {st['tflops']:.1f} TFLOP/s of the dense "
              f"contraction it runs; bound {bound_ms:.3f} ms ({bound_by}: {int((w != 0).sum())} "
              f"nonzero weights), {100 * st['share_of_bound']:.1f} % of it", flush=True)
        if ids is not None:
            def unfused():
                return jk.score_window_select(jk.gather_rows(src, ids), w, sums, maxint, nt,
                                              score_dtype=dt, **kw)

            wu, au = unfused()
            torch.cuda.synchronize()
            if not (torch.equal(wk, wu) and torch.equal(ak, au)):
                raise AssertionError(f"kernel A {dt} ({label}) with ids differs from A on gathered rows")
            st["unfused_ms"] = cuda_ms(unfused)
            st["rows_only_ms"] = cuda_ms(lambda: jk.score_window_select(rows, w, sums, maxint, nt,
                                                                        score_dtype=dt, **kw))
            print(f"# kernel A {dt} ({label}): exactly equal to A on gathered rows; gathering in "
                  f"its loads {ms:.3f} ms, kernel C then A {st['unfused_ms']:.3f} ms, A alone on "
                  f"rows gathered before {st['rows_only_ms']:.3f} ms", flush=True)
        out[dt] = st
    return out


def check_kernel_a(torch, jk):
    """At the folded path's shapes (the main numbers, bf16 as the default
    config scores) and at the exact path's largest union at 150k titles,
    read from a packed index through its ids."""
    shapes = [check_kernel_a_at(torch, jk, "folds=2, U=1,024, 524,288 titles",
                                random_rows_inputs(torch, 2, 1024, 524_288, 500_000, 0.94))]
    d = union_inputs(torch, ntp=163_840, nt=150_000)
    d.update(rows=d["packed"], ids=d["union_ids"], folds=1,
             w=jk.densify_weights(d["w_pos"], d["w_val"], d["union_ids"].shape[0]))
    shapes.append(check_kernel_a_at(torch, jk, "folds=1, U=3,072 of 50,653 rows, 163,840 titles", d))
    main = shapes[0]["bfloat16"]
    res = {k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "tflops",
                                "share_of_bound")}
    res["library_ms"] = None
    res["shapes"] = [st for sh in shapes for st in sh.values()]
    return res


# kernels on the tensor cores: source -> (name, the mangled kernel's
# template arguments, their description, the HGMMA instructions its machine
# code holds when no wgmma was lost or serialized away)
TENSOR_CORE_KERNELS = {
    "score_window.cu": ("A", r"score_window_kernelILi(\d+)ELi(\d+)E",
                        lambda m: f"{m.group(1)} weight part(s), folds={m.group(2)}"
                                  f"{', gathering' if m.group(2) == '1' else ''}", 192),
    "score_full.cu": ("D", r"score_full_kernelILi(\d+)E(f|13__nv_bfloat16)E",
                      lambda m: f"{m.group(1)} weight part(s), "
                                f"{'f32' if m.group(2) == 'f' else 'bf16'} out", 120),
}


def check_tensor_cores(build, paths):
    """Print what ptxas said of kernels A and D (registers, spills) and fail
    if either spills or its machine code does not hold the tensor-core
    instructions (HGMMA) it is written with.  Returns {kernel name: HGMMA
    count}."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    counts = {}
    for source, (name, pattern, describe, want) in TENSOR_CORE_KERNELS.items():
        kernel = "?"
        for line in build.BUILD_LOG.get(source, "").splitlines():
            m = re.search(pattern, line)
            if m:
                kernel = describe(m)
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"# ptxas, kernel {name} ({kernel}): "
                      f"{line.replace('ptxas info    :', '').strip()}", flush=True)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill and (int(spill.group(1)) or int(spill.group(2))):
                raise AssertionError(f"kernel {name} ({kernel}) spills registers: {line.strip()}")
        sass = subprocess.run([cuobjdump, "-sass", paths[source]], capture_output=True, text=True,
                              check=True).stdout
        n = sum(line.split()[1].startswith("HGMMA") for line in sass.splitlines()
                if "/*" in line and len(line.split()) > 1)
        print(f"# kernel {name} machine code: {n} HGMMA instructions", flush=True)
        if n != want:
            raise AssertionError(f"kernel {name} holds {n} HGMMA instructions in its SASS, not the "
                                 f"{want} it is written with")
        counts[name] = n
    return counts


def print_ptxas(build, sources=("gather_rows.cu", "score_sparse_topk.cu")):
    """Print ptxas's registers, shared memory and spills for the kernels of
    ``sources`` (C, and E's two kernels), as this process built them."""
    for source in sources:
        kernel = "?"
        for line in build.BUILD_LOG.get(source, "").splitlines():
            m = re.search(r"Compiling entry function '\w*?([a-z_]+_kernel)", line)
            if m:
                kernel = m.group(1)
            if "registers" in line or "spill" in line:
                print(f"# ptxas, {source} {kernel}: {line.replace('ptxas info    :', '').strip()}",
                      flush=True)


def profile_predict(torch, matcher, queries, label, kernel, top=10):
    """One extra predict under torch.profiler (device activity only, to keep
    its overhead low): the kernels by device time and the share of
    ``kernel`` (name, the kernel function's name)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        matcher.predict(queries)
        torch.cuda.synchronize()
    wall = time.time() - t
    kernels = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append((us / 1e3, ev.count, ev.key))
    total = sum(k[0] for k in kernels)
    if total <= 0:
        print(f"# {label} profile: device time not measured (the profiler recorded none)", flush=True)
        return
    kernels.sort(reverse=True)
    name, function = kernel
    k_ms = sum(ms for ms, _, key in kernels if function in key)
    print(f"# {label} profile: {total:.1f} ms of kernel time in a {wall * 1e3:.1f} ms profiled "
          f"predict (profiler overhead included); kernel {name} {k_ms:.1f} ms = "
          f"{100 * k_ms / total:.1f} % of kernel time", flush=True)
    for ms, count, key in kernels[:top]:
        print(f"#   {ms:9.2f} ms {100 * ms / total:5.1f} % x{count:<6d} {key[:100]}", flush=True)


# 32-bit operations of one LCS step: U = V & M; V = (V + U) | (V & ~M).  (The
# step counted five, (V + U) | (V - U) and a mask, until the kernel took this
# form; the five-operation share is printed beside the three-operation one.)
LCS_STEP_OPS, LCS_STEP_OPS_BEFORE = 3, 5


def check_kernel_b_on(torch, fk, args, label, plain_calls=5):
    """Kernel B against its plain version on one set of arguments: exactly
    equal; its time, the plain version's (the median of ``plain_calls``
    calls) and the bound of the LCS steps these words and queries need."""
    chars, wlen, q_wo, q_wo_len = args
    (B, W, WL), TL = chars.shape, q_wo.shape[1]
    rk, pk = fk.window_best(*args)
    rp, pp = fk.window_best_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(rk, rp) and torch.equal(pk, pp)):
        raise AssertionError(f"kernel B differs from the plain version ({label})")
    ms = cuda_ms(lambda: fk.window_best(*args))
    plain = cuda_ms(lambda: fk.window_best_plain(*args), reps=plain_calls, calls=1)
    # the LCS steps these inputs need: a word of length l against the
    # e = min(qwol, TL) window starts steps min(l, e - p) characters from
    # each start p
    e = q_wo_len.clamp(min=0, max=TL)[:, None].to(torch.float64)
    ln = wlen.clamp(min=0, max=32).to(torch.float64)
    steps = torch.where(ln >= e, e * (e + 1) / 2, ln * (e - ln) + ln * (ln + 1) / 2)
    live = (ln > 0) & (e > 0)
    steps = float(torch.where(live, steps, torch.zeros_like(steps)).sum())
    # bytes the function needs: the characters of the valid words (an empty
    # slot's never reach the result), the text of a pair that has such a word
    # up to its length, both lengths in full, and the two outputs
    nbytes = (float(torch.where(live, ln.clamp(max=WL), torch.zeros_like(ln)).sum())
              + float((e[:, 0] * live.any(dim=1)).sum())
              + wlen.numel() * 4 + q_wo_len.numel() * 4 + B * W * 8)
    bound_ms, bound_by = bound(LCS_STEP_OPS * steps, INT32_OPS_PER_S, nbytes)
    before_ms, _ = bound(LCS_STEP_OPS_BEFORE * steps, INT32_OPS_PER_S, nbytes)
    words = int((wlen > 0).sum())
    print(f"# kernel B {label}: exactly equal; {ms:.3f} ms, plain {plain:.3f} ms ({B} pairs x {W} "
          f"slots, {words} words, TL={TL}, WL={WL}); bound {bound_ms:.4f} ms ({bound_by}: "
          f"{steps:.3e} LCS steps x {LCS_STEP_OPS} operations, {nbytes / 1e6:.1f} MB), "
          f"{100 * bound_ms / ms:.1f} % of it ({100 * before_ms / ms:.1f} % counting "
          f"{LCS_STEP_OPS_BEFORE} operations a step, as the bound did before)", flush=True)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_5_ops": before_ms, "lcs_steps": steps, "pairs": B, "words": words, "tl": TL,
            "wl": WL}


def check_kernel_b(torch, fk):
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, W, TL = 2048 * 32, 15, 64
    out = {"max_abs_err": 0.0, "library_ms": None}
    for WL in (16, 32):
        q_wo = torch.randint(2, 12, (B, TL), device="cuda", generator=g, dtype=torch.int32)
        q_wo_len = torch.randint(1, TL + 1, (B,), device="cuda", generator=g, dtype=torch.int32)
        q_wo = torch.where(torch.arange(TL, device="cuda")[None] < q_wo_len[:, None], q_wo, 0).to(torch.uint8)
        wlen = torch.randint(0, WL + 1, (B, W), device="cuda", generator=g, dtype=torch.int32)
        wlen[:, 5:] = 0
        chars = torch.randint(2, 12, (B, W, WL), device="cuda", generator=g, dtype=torch.int32)
        chars = torch.where(torch.arange(WL, device="cuda")[None, None] < wlen[:, :, None], chars, 0)
        args = (chars.to(torch.uint8).contiguous(), wlen, q_wo.contiguous(), q_wo_len)
        st = check_kernel_b_on(torch, fk, args, f"WL={WL}")
        for k in ("ms", "plain_ms", "bound_ms", "bound_ms_5_ops"):
            out[f"{k}_wl{WL}"] = st[k]
        out["bound_by"] = st["bound_by"]
    for k in ("ms", "plain_ms", "bound_ms"):
        out[k] = out[f"{k}_wl32"]
    return out


def check_kernel_f(torch, lev):
    """Kernel F against ``lcs_plain`` at the main paths' shapes (random
    codes of the 38-letter alphabet, lengths uniform up to past the width):
    exactly equal; its time, the plain version's and the bound of what
    these pairs need.  Returns the stats by shape, the 65,536-pair TL 64
    call's at the top level."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out = {"max_abs_err": 0.0, "library_ms": None, "shapes": {}}
    for B, TL in ((65_536, 32), (65_536, 64), (12_800, 64), (4_096, 255)):
        def side(len_dtype):
            chars = torch.randint(1, 38, (B, TL), device="cuda", generator=g, dtype=torch.int32)
            n = torch.randint(0, TL + 9, (B,), device="cuda", generator=g, dtype=torch.int64)
            chars = torch.where(torch.arange(TL, device="cuda")[None] < n[:, None], chars, 0)
            return chars.to(torch.uint8), n.to(len_dtype)
        # the fuzzy stage passes int64 lengths, the features int32
        (a, la), (b, lb) = side(torch.int64), side(torch.int32)
        args = (a, la, b, lb)
        got, want = lev.lcs(*args), lev.lcs_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"kernel F differs from lcs_plain ({B} pairs, TL={TL})")
        # a call's device time is tens of microseconds, below the wrapper's
        # host time: a spin ahead of each window keeps the host out of it
        ms = alternating_ms({"F": lambda: lev.lcs(*args)}, calls=10)["F"]
        plain = cuda_ms(lambda: lev.lcs_plain(*args), reps=3, calls=1)
        # what these pairs need: each valid character of b steps over the
        # ceil(TL/32) words of V, three operations a word (as kernel B's
        # steps count); the characters inside the lengths, both lengths and
        # the output
        na = la.clamp(min=0, max=TL).to(torch.float64)
        nb = lb.clamp(min=0, max=TL).to(torch.float64)
        steps = float(nb.sum()) * ((TL + 31) // 32)
        nbytes = float(na.sum() + nb.sum()) + B * (8 + 4 + 4)
        bound_ms, bound_by = bound(LCS_STEP_OPS * steps, INT32_OPS_PER_S, nbytes)
        print(f"# kernel F {B} pairs, TL={TL}: exactly equal; {ms:.4f} ms, plain {plain:.3f} ms; "
              f"bound {bound_ms:.4f} ms ({bound_by}: {steps:.3e} word steps x {LCS_STEP_OPS} "
              f"operations, {nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f} % of it", flush=True)
        out["shapes"][f"{B}x{TL}"] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                                     "bound_by": bound_by, "share_of_bound": bound_ms / ms}
    out.update({k: out["shapes"]["65536x64"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    return out


def kernel_g_inputs(torch, qb=128, nw=32_768, lq=64, ltw=64, nt=500_000):
    """Kernel G's inputs at the folded 500k block: window maxima in [0, 1)
    (-1 past nt) over 524,288 titles, a window's title in its tile, ids
    from a 400-trigram vocabulary (V and weight 0 past each query's
    trigrams), trigram lists of the same vocabulary up to a random length."""
    from doppelspeller_tpu_torch.config import TRIGRAM_VOCAB_SIZE as V

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    dev = "cuda"
    ntp = 16 * nw
    wmax = torch.rand((qb, nw), device=dev, generator=g)
    wmax[:, 16 * torch.arange(nw, device=dev) >= nt] = -1.0
    warg = (16 * torch.arange(nw, device=dev)[None, :]
            + torch.randint(0, 16, (qb, nw), device=dev, generator=g)).to(torch.int32)
    ids = torch.randint(0, 400, (qb, lq), device=dev, generator=g)
    n_real = torch.randint(1, lq + 1, (qb, 1), device=dev, generator=g)
    ids = torch.where(torch.arange(lq, device=dev)[None, :] < n_real, ids, V)
    w_val = torch.where(ids < V, torch.rand((qb, lq), device=dev, generator=g) * 8 + 0.5, 0.0)
    tl = torch.randint(0, 400, (ntp, ltw), device=dev, generator=g, dtype=torch.int32)
    n_tl = torch.randint(1, ltw + 1, (ntp, 1), device=dev, generator=g)
    tl = torch.where(torch.arange(ltw, device=dev)[None, :] < n_tl, tl, V)
    tl[nt:] = V
    sums = torch.rand(ntp, device=dev, generator=g) * 40 + 10
    sums[nt:] = 0.0
    return wmax, warg, tl.contiguous(), sums, ids, w_val, w_val.sum(dim=1)


def check_kernel_g(torch, fold, kprime=128, k=100):
    """Kernel G against ``select_rescore_plain`` at the folded 500k block
    (QB 128, 32,768 windows, k' 128, k 100, LQ 64, Ltw 64): equal bit for
    bit; its time by CUDA events, the plain version's, and the bound of
    the bytes it needs (the maxima once, the k' candidates' lists, titles
    and sums, the ids, weights and bounds, the output)."""
    args = kernel_g_inputs(torch)
    wmax, warg, tl, sums, ids, w_val, maxint = args
    nt = 500_000
    got = fold.select_rescore(*args, nt, kprime, k)
    want = fold.select_rescore_plain(*args, nt, kprime, k)
    torch.cuda.synchronize()
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1])):
        raise AssertionError("kernel G differs from select_rescore_plain at the 500k block")
    ms = alternating_ms({"G": lambda: fold.select_rescore(*args, nt, kprime, k)}, calls=10)["G"]
    plain = cuda_ms(lambda: fold.select_rescore_plain(*args, nt, kprime, k), reps=3, calls=1)
    qb, nw = wmax.shape
    nbytes = (wmax.numel() * 4 + qb * kprime * (tl.shape[1] * 4 + 4 + 4)
              + ids.numel() * ids.element_size() + w_val.numel() * 4 + maxint.numel() * 4
              + qb * k * 8)
    bound_ms, bound_by = bound(0.0, 1.0, nbytes)
    print(f"# kernel G QB={qb}, {nw} windows, k'={kprime}, k={k}, LQ={ids.shape[1]}, "
          f"Ltw={tl.shape[1]}: equal bit for bit; {ms:.4f} ms, plain {plain:.3f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f} % of it",
          flush=True)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "max_abs_err": 0.0, "library_ms": None}


class Spy:
    """Stands in for the function ``name`` of ``module`` and keeps every
    call's (args, kwargs, result), by reference.  Attributes go through to
    the function, so a wrapper that counts its launches on itself
    (``fn.launches += 1``) goes on counting there.  A call made while a CUDA
    graph is captured launches nothing and is not kept: the graph's memory
    pool hands its tensors to other graphs' replays (the warm-up run before
    each capture makes the same call op by op, and that one is kept)."""

    def __init__(self, module, name):
        self.__dict__.update(module=module, name=name, real=getattr(module, name), calls=[])

    def __call__(self, *args, **kwargs):
        import torch

        out = self.real(*args, **kwargs)
        if not torch.cuda.is_current_stream_capturing():
            self.calls.append((args, kwargs, out))
        return out

    def __getattr__(self, key):
        return getattr(self.real, key)

    def __setattr__(self, key, value):
        setattr(self.real, key, value)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def union_inputs(torch, ntp=524_288, nt=500_000):
    """A random packed index of ``ntp`` titles (3.3 GB at the default 500k)
    and one 128-query block over a 3,072-row union of it: the exact path's
    shapes."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    V, qb, U, lq = 50_653, 128, 3072, 64
    packed = torch.randint(0, 256, (V, ntp // 8), device="cuda", generator=g, dtype=torch.uint8)
    union_ids = torch.randperm(V, device="cuda", generator=g)[:U].to(torch.int32)
    # each query holds lq trigrams of the union, padded past a per-query count
    w_pos = torch.rand((qb, U), device="cuda", generator=g).argsort(dim=1)[:, :lq]
    w_pos = torch.sort(w_pos, dim=1).values.to(torch.int32)
    n = torch.randint(8, lq + 1, (qb, 1), device="cuda", generator=g)
    w_pos = torch.where(torch.arange(lq, device="cuda")[None] < n, w_pos, U).to(torch.int32)
    w_val = torch.rand((qb, lq), device="cuda", generator=g) * 8.0 + 0.5
    sums = torch.rand(ntp, device="cuda", generator=g) * 60.0 + 20.0
    sums[nt:] = 0.0
    maxint = torch.rand(qb, device="cuda", generator=g) * 60.0 + 600.0
    return dict(packed=packed, union_ids=union_ids, w_pos=w_pos, w_val=w_val, sums=sums,
                maxint=maxint, nt=nt, tb=2048)


def alternating_ms(fns, rounds=7, calls=5):
    """Milliseconds per call of each of ``fns`` (name -> fn): the median
    over ``rounds`` rounds, each timing one window of ``calls`` calls of
    every fn in turn, after a warm-up call of each, so that two functions
    are compared on the card's same state.  A spin of about a millisecond
    on the card ahead of each window lets the host enqueue the window's
    calls before the first starts, so a wrapper's host time (a slower one
    delays its first call) stays out of the device time."""
    import torch

    times = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(rounds):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / calls)
    return {name: statistics.median(t) for name, t in times.items()}


def check_kernel_c(torch, jk, d):
    packed, ids = d["packed"], d["union_ids"]
    out = jk.gather_rows(packed, ids)
    plain = jk.gather_rows_plain(packed, ids)
    torch.cuda.synchronize()
    if not torch.equal(out, plain):
        raise AssertionError("kernel C differs from index_select")
    ids64 = ids.to(torch.int64)
    nbytes = 2 * ids.shape[0] * packed.shape[1] + ids.numel() * 4
    bound_ms, bound_by = bound(0.0, 1.0, nbytes)
    # C and index_select in alternating windows: their gap is a few per cent
    t = alternating_ms({"ms": lambda: jk.gather_rows(packed, ids),
                        "library_ms": lambda: torch.index_select(packed, 0, ids64)})
    res = {"max_abs_err": 0.0, **t, "plain_ms": cuda_ms(lambda: jk.gather_rows_plain(packed, ids)),
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"# kernel C: exactly equal; {res['ms']:.3f} ms, index_select {res['library_ms']:.3f} ms "
          f"(alternating windows), plain {res['plain_ms']:.3f} ms ({ids.shape[0]} rows x "
          f"{packed.shape[1]} bytes); bound {bound_ms:.3f} ms ({bound_by}), "
          f"{100 * bound_ms / res['ms']:.1f} % of it", flush=True)
    return res


def check_kernel_d(torch, jk, d):
    packed, ids = d["packed"], d["union_ids"]
    U, nbytes_row = ids.shape[0], packed.shape[1]
    w = jk.densify_weights(d["w_pos"], d["w_val"], U)
    sums, maxint, nt, tb = d["sums"], d["maxint"], d["nt"], d["tb"]
    qb, ntp = w.shape[0], nbytes_row * 8
    res = {"library_ms": None}

    def plain_d(dt):
        return jk.score_full_plain(jk.gather_rows_plain(packed, ids), jk.round_weights(w, dt), sums,
                                   maxint, nt, tb=tb, out_dtype=jk.score_out_dtype(dt))

    for dt in ("float32", "bfloat16"):
        out = jk.score_full(packed, ids, w, sums, maxint, nt, tb=tb, score_dtype=dt)
        plain = plain_d(dt)
        torch.cuda.synchronize()
        err = float((out.float() - plain.float()).abs().max())
        vk, pk = jk.select_topk_permuted(out, 100, tb)
        vp, pp = jk.select_topk_permuted(plain, 100, tb)
        if dt == "float32":
            torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-7)
            sep = jk.untied_slots(vp, 1e-6)
            res["max_abs_err"] = err
        else:
            ulp = torch.exp2(torch.floor(torch.log2(plain.float().abs().clamp(min=1e-30))) - 7)
            n_over = int(((out.float() - plain.float()).abs() > ulp).sum())
            if n_over:
                raise AssertionError(f"kernel D bf16: {n_over} scores differ by more than one ulp")
            # one ulp each way cannot reorder scores more than two ulps apart
            sep = jk.untied_slots(vp, float(2 * ulp.max()))
            res["max_abs_err_bf16"] = err
        if not torch.equal(pk[sep], pp[sep]):
            raise AssertionError(f"kernel D {dt}: top-k titles differ where untied")
        ms = cuda_ms(lambda: jk.score_full(packed, ids, w, sums, maxint, nt, tb=tb, score_dtype=dt))
        plain_ms = cuda_ms(lambda: plain_d(dt))
        select_ms = cuda_ms(lambda: jk.select_topk_permuted(out, 100, tb))
        out_bytes = 4 if dt == "float32" else 2
        # the products and rows these weights need; ids, weights, sums and
        # bound read once, the scores written once
        flop, row_bytes = contraction_need(w, ids, ntp, dt)
        bound_ms, bound_by = bound(flop, BF16_FLOP_PER_S, row_bytes + U * 4 + qb * U * 4
                                   + ntp * 4 + qb * 4 + qb * ntp * out_bytes)
        dense_ms = 2.0 * qb * ntp * U * (3 if dt == "float32" else 1) / BF16_FLOP_PER_S * 1e3
        print(f"# kernel D {dt}: max |err| {err:.3e}; top-100 titles equal on {int(sep.sum())} "
              f"untied slots; {ms:.3f} ms, plain (gather and score) {plain_ms:.3f} ms per "
              f"128-query block (U={U}, {ntp} titles); bound {bound_ms:.3f} ms ({bound_by}: "
              f"{int((w != 0).sum())} nonzero weights), {100 * bound_ms / ms:.1f} % of it; the "
              f"dense contraction it runs takes {dense_ms:.3f} ms at the tensor cores' peak; exact "
              f"top-100 over its output (select_topk_permuted) {select_ms:.3f} ms", flush=True)
        suffix = "" if dt == "float32" else "_bf16"
        res["ms" + suffix], res["plain_ms" + suffix] = ms, plain_ms
        res["bound_ms" + suffix], res["bound_by" + suffix] = bound_ms, bound_by
        res["select_ms" + suffix] = select_ms
    return res


def check_kernel_e(torch, jk, d):
    packed, ids, w_pos, w_val = d["packed"], d["union_ids"], d["w_pos"], d["w_val"]
    sums, maxint, nt, tb, k = d["sums"], d["maxint"], d["nt"], d["tb"], 100
    U, nbytes_row = ids.shape[0], packed.shape[1]
    qb, lq = w_pos.shape
    ntp = nbytes_row * 8
    res = {"library_ms": None}
    # f32 and bf16 weights at the oracle's shapes, and f32 with fewer real
    # titles than k (padding candidates at -1, ordered by column)
    for label, dt, n_real in (("float32", "float32", nt), ("bfloat16", "bfloat16", nt),
                              ("nt<k", "float32", 60)):
        args = (packed, sums, ids, w_pos, w_val, maxint, n_real)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        vk, pk = jk.jaccard_topk_v1(*args, k=k, tb=tb, score_dtype=dt)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        vp, pp = jk.jaccard_topk_v1_plain(*args, k=k, tb=tb, score_dtype=dt)
        torch.cuda.synchronize()
        torch.testing.assert_close(vk, vp, rtol=1e-5, atol=1e-7)
        sep = jk.untied_slots(vp, 1e-6)
        if not torch.equal(pk[sep], pp[sep]):
            raise AssertionError(f"kernel E {label}: top-k titles differ where untied")
        if n_real < k and not (torch.equal(pk[:, n_real:], pp[:, n_real:])
                               and (vk[:, n_real:] == -1).all()):
            raise AssertionError("kernel E nt<k: the padding candidates differ")
        # the score matrix the dense route writes is qb x ntp f32
        if peak > qb * ntp * 4 / 10:
            raise AssertionError(f"kernel E {label}: peak {peak} B against a {qb * ntp * 4} B matrix")
        print(f"# kernel E {label}: max |top-k err| {float((vk - vp).abs().max()):.3e} (rtol "
              f"1e-5); titles equal on {int(sep.sum())} untied slots; peak device memory of one "
              f"call {peak / 1e6:.3f} MB (the dense score matrix: {qb * ntp * 4 / 1e6:.1f} MB)",
              flush=True)
        if label == "float32":
            res["max_abs_err"], res["peak_bytes"] = float((vk - vp).abs().max()), peak
    args = (packed, sums, ids, w_pos, w_val, maxint, nt)

    def dense_route():
        """E before its own kernel: densified weights, D with f32 out, the
        exact top-k over D's (QB, ntp) matrix."""
        w = jk.densify_weights(w_pos, w_val, U)
        return jk.select_topk_permuted(jk.score_full(packed, ids, w, sums, maxint, nt, tb=tb,
                                                     score_dtype="float32"), k, tb)

    t = alternating_ms({"ms": lambda: jk.jaccard_topk_v1(*args, k=k, tb=tb, score_dtype="float32"),
                        "dense_route_ms": dense_route,
                        "ms_bf16": lambda: jk.jaccard_topk_v1(*args, k=k, tb=tb,
                                                              score_dtype="bfloat16")})
    res.update(t)
    res["plain_ms"] = cuda_ms(lambda: jk.jaccard_topk_v1_plain(*args, k=k, tb=tb,
                                                               score_dtype="float32"))
    # the products and rows its lq weights a query need (f32: three bf16
    # passes); ids, weight slots, sums and bound read once, the top-k
    # written once
    flop, row_bytes = contraction_need(jk.densify_weights(w_pos, w_val, U), ids, ntp, "float32")
    res["bound_ms"], res["bound_by"] = bound(flop, BF16_FLOP_PER_S, row_bytes + U * 4
                                             + qb * lq * 8 + ntp * 4 + qb * 4 + qb * k * 8)
    print(f"# kernel E: {res['ms']:.3f} ms f32, {res['ms_bf16']:.3f} ms bf16, the dense route "
          f"(densify, D f32, select_topk_permuted) {res['dense_route_ms']:.3f} ms, in alternating "
          f"windows; plain {res['plain_ms']:.3f} ms per 128-query block; bound "
          f"{res['bound_ms']:.3f} ms ({res['bound_by']}), {100 * res['bound_ms'] / res['ms']:.1f} % "
          f"of it", flush=True)
    return res


def oracle_blocks_through_e(torch, jk, engine, plans, k, score_dtype):
    """Whether kernel E pays on the oracle path: the oracle engine's blocks
    (``topk_union``: weights rebuilt on the card, D, the exact top-k over
    its matrix) against the same blocks with the same weights and bound
    through E instead, results held equal (titles on untied slots), both
    timed in alternating windows over all the blocks."""
    dev_plans = [(torch.from_numpy(p.union_ids).to("cuda"), torch.from_numpy(p.w_pos).to("cuda"))
                 for p in plans]
    zero = torch.zeros(1, dtype=torch.float32, device="cuda")

    def through_e(uid, w_pos):
        uid = uid.to(torch.int64)
        wp = w_pos.to(torch.int64).clamp(max=uid.shape[0])
        w_val = torch.cat([engine.idf[uid], zero])[wp]
        maxint = torch.cat([engine.fb[uid], zero])[wp].sum(dim=1)
        return jk.jaccard_topk_v1(engine.packed, engine.sums, uid, wp, w_val, maxint, engine.nt,
                                  k=k, tb=engine.tb, score_dtype=score_dtype)

    n_sep = 0
    for (uid, w_pos), p in zip(dev_plans, plans):
        (va, pa), (vb, pb) = through_e(uid, w_pos), engine.topk_union(uid, w_pos, k)
        va, pa, vb, pb = (x[: p.n_valid] for x in (va, pa, vb, pb))
        torch.testing.assert_close(va, vb, rtol=1e-5, atol=1e-7)
        sep = jk.untied_slots(vb, 1e-6)
        n_sep += int(sep.sum())
        if not torch.equal(pa[sep], pb[sep]):
            raise AssertionError("the oracle's blocks through kernel E differ from D's route")
    t = alternating_ms({"d_select": lambda: [engine.topk_union(u, w, k) for u, w in dev_plans],
                        "e": lambda: [through_e(u, w) for u, w in dev_plans]}, rounds=5, calls=1)
    res = {"blocks": len(plans), "untied_slots_equal": n_sep,
           "d_select_ms_per_block": t["d_select"] / len(plans), "e_ms_per_block": t["e"] / len(plans),
           "union_sizes": sorted({int(p.union_ids.shape[0]) for p in plans}),
           "lq": int(plans[0].w_pos.shape[1])}
    print(f"# oracle blocks: {len(plans)} (unions {res['union_sizes']}, LQ {res['lq']}) through the "
          f"oracle engine (weights, D, select_topk_permuted) {res['d_select_ms_per_block']:.3f} ms a "
          f"block, through kernel E {res['e_ms_per_block']:.3f} ms, in alternating windows; equal "
          f"on {n_sep} untied slots", flush=True)
    return res


def check_small_world(torch, Matcher, make_world, model, cfg, label, small_batch=False):
    _, truth, queries, _ = make_world(4096, 512, seed=SEED, config=cfg)
    m_cpu = Matcher(cfg, truth, model, device="cpu")
    r_cpu = m_cpu.predict(queries)
    m_gpu = Matcher(cfg, truth, model, device="cuda")
    r_gpu = m_gpu.predict(queries)
    if small_batch:
        check_small_batch(m_cpu, m_gpu, queries, cfg)
    same = (r_cpu.match_title_id == r_gpu.match_title_id) & (r_cpu.stage == r_gpu.stage)
    engine = "exact" if m_gpu.scorer.exact is not None else "folded"
    print(f"# small world ({label}, {engine} retrieval): card agrees with the plain CPU path on "
          f"{int(same.sum())}/{len(same)} rows (tolerance: 99 %); max |pred diff| "
          f"{float(abs(r_cpu.prediction - r_gpu.prediction)[same].max()):.2e}", flush=True)
    if same.mean() < 0.99:
        raise AssertionError(f"card and plain CPU path disagree on the small world ({label})")
    return engine


SMALL_TRUTH_TITLES = 301


def check_small_truth(torch, Matcher, make_world, model, cfg0):
    """A truth DB of 301 titles at k = 100 under the default config (tb =
    2048, windows of 16): 62 of each row's 100 candidates are padding
    positions, which the fuzzy and model stages read as the last title.  120
    queries (one wave, every candidate scored) and 300 under
    ``cascade_impl="device"`` (waves A/B), and a misspelling of the last
    title as a single title, on the card and on the plain CPU path: match
    ids and stages equal on every row (tolerance: 99 %, as the small
    worlds')."""
    import random

    from doppelspeller_tpu_torch.utils.io import TitleSet
    from doppelspeller_tpu_torch.utils.misspell import generate_misspelled_name

    cfg, truth, queries, _ = make_world(SMALL_TRUTH_TITLES, 300, seed=SEED, config=cfg0)
    m_cpu = Matcher(cfg, truth, model, device="cpu")
    m_gpu = Matcher(cfg, truth, model, device="cuda")
    _, cand = m_gpu.scorer.topk(queries, rows=np.arange(8))
    n_pad = int((cand >= SMALL_TRUTH_TITLES).sum()) // 8
    if n_pad == 0:
        raise AssertionError("the 301-title world left no padding candidates")
    agree = []
    for n, impl in ((120, "auto"), (300, "device")):
        few = TitleSet.from_titles(queries.titles[:n], ids=queries.ids[:n], config=cfg)
        m_cpu.cfg = m_gpu.cfg = cfg.with_(cascade_impl=impl)
        rc, rg = m_cpu.predict(few), m_gpu.predict(few)
        same = (rc.match_title_id == rg.match_title_id) & (rc.stage == rg.stage)
        agree.append((n, impl, int(same.sum())))
        if same.mean() < 0.99:
            raise AssertionError(f"small truth ({n} queries, {impl}): card and CPU agree on "
                                 f"{int(same.sum())}/{n} rows")
    last = TitleSet.from_titles([generate_misspelled_name(truth.transformed[-1], random.Random(1))],
                                config=cfg)
    sc, sg = (m.predict(last, single=True).single_result() for m in (m_cpu, m_gpu))
    if sc["match_title_id"] != sg["match_title_id"] or sg["match_title_id"] != int(truth.ids[-1]):
        raise AssertionError(f"small truth, the last title misspelled: CPU {sc}, card {sg}")
    print(f"# small truth ({SMALL_TRUTH_TITLES} titles, k=100, default config: {n_pad} padding "
          f"candidates a row): card agrees with the CPU path on "
          f"{', '.join(f'{a}/{n} rows ({impl})' for n, impl, a in agree)}; the last title "
          f"misspelled, single: both matched {sg['match_title_id']}", flush=True)
    return {"padding_per_row": n_pad, "agree": agree}


def check_small_batch(m_cpu, m_gpu, queries, cfg):
    """100 queries under the config's ``cascade_impl`` (``"auto"``: under
    2,048 rows every candidate is scored in one wave): the card against the
    CPU run row for row, at the small world's tolerance; then one
    ``predict(single=True)`` of a query the model stage decides."""
    from doppelspeller_tpu_torch.pipeline import STAGE_MODEL
    from doppelspeller_tpu_torch.utils.io import TitleSet

    few = TitleSet.from_titles(queries.titles[:100], ids=queries.ids[:100], config=cfg)
    waves = []
    decide = m_gpu.rerank.decide

    def spy(*args, **kwargs):
        waves.append((kwargs.get("narrow", 0), kwargs.get("col_lo", 0)))
        return decide(*args, **kwargs)

    m_gpu.rerank.decide = spy
    try:
        r_gpu = m_gpu.predict(few)
    finally:
        del m_gpu.rerank.decide
    r_cpu = m_cpu.predict(few)
    same = (r_cpu.match_title_id == r_gpu.match_title_id) & (r_cpu.stage == r_gpu.stage)
    if same.mean() < 0.99 or set(waves) != {(0, 0)}:
        raise AssertionError(f"small batch: card and CPU agree on {int(same.sum())}/100 rows, "
                             f"model waves (narrow, col_lo) {sorted(set(waves))}")
    row = int(np.flatnonzero(r_gpu.stage == STAGE_MODEL)[0])
    one = TitleSet.from_titles([few.titles[row]], config=cfg)
    single = m_gpu.predict(one, single=True).single_result()
    if single["match_title_id"] != int(r_gpu.match_title_id[row]) or single["prediction"] <= 0:
        raise AssertionError(f"predict(single=True) did not return the batch's match: {single}")
    print(f"# small batch (100 queries, cascade_impl={cfg.cascade_impl!r}): card agrees with the CPU "
          f"path on {int(same.sum())}/100 rows, every candidate scored in one wave "
          f"({len(waves)} model calls); predict(single=True) matched title "
          f"{single['match_title_id']} at {single['prediction']:.4f}", flush=True)


def check_calls(torch, jk, fk, calls_a, calls_b, where):
    """Kernels A and B against their plain versions on every call a path
    made: what the kernel returned there (the values the path went on with)
    beside the plain version on the same arguments.  B exactly equal; A,
    which gathers the union's rows from the packed index in its loads, to
    rtol 1e-5 against the plain gather and scoring on the same rounded
    weights, titles equal on untied windows.  Returns (B's largest
    arguments by (TL, WL), A's calls by union size, A's largest call)."""
    shapes_b = {}
    for args, _, (rk, pk) in calls_b:
        rp, pp = fk.window_best_plain(*args)
        if not (torch.equal(rk, rp) and torch.equal(pk, pp)):
            raise AssertionError(f"kernel B differed from its plain version {where} at "
                                 f"{tuple(args[0].shape)} x TL={args[2].shape[1]}")
        key = (args[2].shape[1], args[0].shape[2])
        if key not in shapes_b or args[0].shape[0] > shapes_b[key][0].shape[0]:
            shapes_b[key] = args

    unions, n_untied, largest = {}, 0, None
    for (packed, w, sums, maxint, nt), kw, (wk, ak) in calls_a:
        kw = dict(kw)
        ids, dt = kw.pop("union_ids", None), kw.pop("score_dtype")
        rows = packed if ids is None else jk.gather_rows_plain(packed, ids)
        wr = jk.round_weights(w, dt)
        wp, ap = jk.score_window_select_plain(rows, wr, sums, maxint, nt, **kw)
        torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-7)
        untied = jk.untied_windows(rows, wr, sums, maxint, nt, rtol=1e-5, **kw)
        U = rows.shape[0]
        if not torch.equal(ak[untied], ap[untied]):
            raise AssertionError(f"kernel A's window titles differed from the plain version "
                                 f"{where} at U={U}")
        n_untied += int(untied.sum())
        unions[U] = unions.get(U, 0) + 1
        if largest is None or U > largest["U"]:
            largest = dict(rows=packed, ids=ids, w=w, sums=sums, maxint=maxint, nt=nt,
                           folds=kw["folds"], U=U)
    print(f"# {where}: kernel B exactly equal to its plain version on all {len(calls_b)} calls "
          f"((TL, WL): {sorted(shapes_b)}); kernel A within rtol 1e-5 of the plain gather and "
          f"scoring on all {len(calls_a)} calls (U: calls {json.dumps(dict(sorted(unions.items())))}), "
          f"titles equal on {n_untied} untied windows", flush=True)
    return shapes_b, unions, largest


def check_calls_g(torch, fold, calls, where):
    """Kernel G against ``select_rescore_plain`` on every call a path made,
    bit for bit (none on the exact engine)."""
    for args, _, (vk, pk) in calls:
        vp, pp = fold.select_rescore_plain(*args)
        if not (torch.equal(vk.view(torch.int32), vp.view(torch.int32)) and torch.equal(pk, pp)):
            raise AssertionError(f"kernel G differed from its plain version {where} at "
                                 f"{tuple(args[0].shape)}, LQ={args[4].shape[1]}")
    print(f"# {where}: kernel G equal to its plain version bit for bit on all {len(calls)} calls",
          flush=True)


def check_train_kernels(torch, jk, fk, calls_a, calls_b):
    """Every call the training made of A and B against the plain version
    (``check_calls``); then the largest call of each is timed (B once per
    distinct (TL, WL)).  Returns the stats."""
    shapes_b, unions, largest = check_calls(torch, jk, fk, calls_a, calls_b, "train")
    stats_b = [check_kernel_b_on(torch, fk, args, f"in training, TL={tl}, WL={wl}", plain_calls=1)
               for (tl, wl), args in sorted(shapes_b.items())]
    V, nbytes = largest["rows"].shape
    stats_a = check_kernel_a_at(torch, jk, f"in training, folds=1, U={largest['ids'].shape[0]:,} of "
                                           f"{V:,} rows, {nbytes * 8:,} titles", largest)
    return {"A": list(stats_a.values()), "A_unions": unions, "B": stats_b}


def check_training_against_cpu(torch, trainer, gbt, features_call, boosting_call):
    """The card's training against the port's CPU path (which the CPU tests
    hold to the JAX package) on the run's own pairs.  The features of 2,048
    sampled pairs: NaNs in the same places, values to 1e-5.  The first tree
    on every row: at the base score ``g`` and ``h`` are multiples of 1/4,
    every sum of them is exact in any order (the f32 totals and prefix sums
    too), so feat, is_leaf, the splits' bins and directions, the values and
    the first custom errors must all be equal."""
    (pairs, word_counts, truth, cfg, _dev), _, X = features_call
    idx = np.sort(np.random.RandomState(SEED).choice(len(pairs.kind), 2048, replace=False))
    few = trainer.TrainingPairs(kind=pairs.kind[idx], target=pairs.target[idx],
                                pair_q=pairs.pair_q[idx], t_pos=pairs.t_pos[idx],
                                q_titles=pairs.q_titles)
    X_cpu = trainer.build_feature_matrix(few, word_counts, truth, cfg, "cpu")
    if not np.array_equal(np.isnan(X_cpu), np.isnan(X[idx])):
        raise AssertionError("training features: the card's NaNs lie elsewhere than the CPU path's")
    err = float(np.abs(np.nan_to_num(X_cpu) - np.nan_to_num(X[idx])).max())
    if err > 1e-5:
        raise AssertionError(f"training features differ from the CPU path's by {err:.3e} > 1e-5")

    (X_tr, y_tr, X_ev, y_ev, params), _, _ = boosting_call
    one = gbt.GBTParams(**{**vars(params), "num_boost_round": 1, "early_stopping_rounds": 1})
    if one.base_score != 0.5 or one.beta * 4 != int(one.beta * 4):
        raise AssertionError("the first tree's sums are exact only at base score 0.5 and a beta "
                             "in quarters")
    m_card = gbt.train_gbt(X_tr, y_tr, X_ev, y_ev, one, verbose_every=0, device="cuda")
    m_cpu = gbt.train_gbt(X_tr, y_tr, X_ev, y_ev, one, verbose_every=0, device="cpu")
    splits = m_cpu.feat >= 0
    equal = (np.array_equal(m_card.feat, m_cpu.feat) and np.array_equal(m_card.is_leaf, m_cpu.is_leaf)
             and np.array_equal(m_card.split_bin[splits], m_cpu.split_bin[splits])
             and np.array_equal(m_card.missing_left[splits], m_cpu.missing_left[splits])
             and np.array_equal(m_card.value, m_cpu.value)
             and m_card.history["train_error"] == m_cpu.history["train_error"]
             and m_card.history["eval_error"] == m_cpu.history["eval_error"])
    print(f"# train against the CPU path: features of {len(idx)} sampled pairs max |diff| "
          f"{err:.2e} (tolerance 1e-5), NaNs in the same places; first tree on {len(y_tr)} rows "
          f"({int(splits.sum())} splits) equal: {equal}", flush=True)
    if not equal:
        raise AssertionError("the first tree grown on the card differs from the CPU path's")
    return {"features_max_abs_diff": err, "first_tree_splits": int(splits.sum())}


def train_on_card(torch, quick_train_model, cfg, truth, asset, counters):
    """The training path on the card: ``quick_train_model`` as the bench
    calls it.  Returns (model, stats); fails unless kernels A (every launch
    gathering) and B launched and the model holds ``TRAIN_ROUNDS`` trees.
    Then every call training made of A and of B is held against the plain
    version, and the features and the first tree against the CPU path."""
    from doppelspeller_tpu_torch.models import gbt, trainer
    from doppelspeller_tpu_torch.ops import features
    from doppelspeller_tpu_torch.ops import features_kernels as fk
    from doppelspeller_tpu_torch.ops import jaccard_kernels as jk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_counts(counters)
    t = time.time()
    with Spy(jk, "score_window_select") as spy_a, Spy(features, "window_best") as spy_b, \
            Spy(trainer, "build_feature_matrix") as spy_x, Spy(trainer, "train_gbt") as spy_gbt, \
            Spy(jk, "count_replay") as spy_r:
        model, report = quick_train_model(cfg, truth, TRAIN_ROUNDS, "cuda")
    torch.cuda.synchronize()
    seconds = time.time() - t
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    same = [bool(all(np.array_equal(getattr(model, k)[i], getattr(asset, k)[i])
                     for k in ("feat", "split_bin", "missing_left", "is_leaf")))
            for i in range(min(model.num_trees, asset.num_trees))]
    hist = report["history"]
    stats = {"seconds": seconds, "timings": report["timings"], "launches": launches,
             "pairs_by_kind": report["pairs_by_kind"], "train_rows": report["n_train_rows"],
             "eval_rows": report["n_eval_rows"], "trees": model.num_trees,
             "best_ntree_limit": model.best_ntree_limit,
             "trees_equal_to_committed_model": int(sum(same)),
             "peak_gb": peak / 1e9, "resident_gb": resident / 1e9}
    print(f"# train timings (s, synchronized before each clock read): "
          f"{json.dumps({k: round(v, 3) for k, v in report['timings'].items()})}; "
          f"{seconds:.3f} s in all", flush=True)
    print(f"# train pairs by kind {json.dumps(report['pairs_by_kind'])}; train rows "
          f"{report['n_train_rows']}, eval rows {report['n_eval_rows']}", flush=True)
    print(f"# train last custom error: train {hist['train_error'][-1]:.1f}, eval "
          f"{hist['eval_error'][-1]:.1f}; AUC train {hist['final_train_auc']:.6f}, eval "
          f"{hist['final_eval_auc']:.6f}; {model.num_trees} trees, best_ntree_limit "
          f"{model.best_ntree_limit}; error matrix {json.dumps(report['error_matrix'])}", flush=True)
    print(f"# train launches: {json.dumps(launches)}; peak device memory {peak / 1e9:.3f} GB, of "
          f"which {resident / 1e9:.3f} GB were resident before", flush=True)
    print(f"# train: {int(sum(same))} of {len(same)} trees equal the committed model's in feat, "
          f"split_bin, missing_left, is_leaf (the first {same.index(False) if False in same else len(same)} "
          f"in a row; that model is a CPU run of the JAX package)", flush=True)
    if launches["A"] == 0 or launches["A gathering"] != launches["A"] or launches["B"] == 0:
        raise AssertionError(f"training did not launch A (gathering) and B: {launches}")
    if launches["C"] or launches["D"] or launches["E"]:
        raise AssertionError(f"training launched a kernel off its path: {launches}")
    if model.num_trees != TRAIN_ROUNDS:
        raise AssertionError(f"training gave {model.num_trees} trees, not {TRAIN_ROUNDS}")
    # a launch is an op-by-op call (held against the plain version below) or
    # part of a replay of the retrieval's graphs, which their warm-ups hold
    replayed = [sum(c[0][0][j] for c in spy_r.calls) for j in (0, 5)]   # A, B (launch_counters)
    print(f"# train: A and B called op by op {len(spy_a.calls)}, {len(spy_b.calls)} times; "
          f"launched in graph replays {replayed[0]}, {replayed[1]} times", flush=True)
    stats["replayed_launches"] = {"A": replayed[0], "B": replayed[1]}
    if (len(spy_a.calls) + replayed[0], len(spy_b.calls) + replayed[1]) != (launches["A"], launches["B"]):
        raise AssertionError(f"training's calls of A and B ({len(spy_a.calls)}, {len(spy_b.calls)}) "
                             f"and replayed launches {replayed} are not its launches: {launches}")
    stats["kernels"] = check_train_kernels(torch, jk, fk, spy_a.calls, spy_b.calls)
    stats["against_cpu"] = check_training_against_cpu(torch, trainer, gbt, spy_x.calls[0],
                                                      spy_gbt.calls[0])
    del spy_a, spy_b, spy_x, spy_gbt, spy_r
    stats["repeat"] = check_training_repeats(torch, quick_train_model, cfg, truth, model, report)
    return model, stats


TREE_FIELDS = ("feat", "split_bin", "missing_left", "value", "is_leaf", "threshold")


def check_training_repeats(torch, quick_train_model, cfg, truth, model, report):
    """The same training once more: the histograms add in fixed point, so
    every tree must equal the first run's bit for bit (feature, bin,
    direction, f32 value).  Prints both runs' boosting seconds."""
    torch.cuda.synchronize()
    again, report2 = quick_train_model(cfg, truth, TRAIN_ROUNDS, "cuda")
    torch.cuda.synchronize()
    equal = [all(getattr(model, k)[i].tobytes() == getattr(again, k)[i].tobytes() for k in TREE_FIELDS)
             for i in range(min(model.num_trees, again.num_trees))]
    b1, b2 = report["timings"]["boosting_seconds"], report2["timings"]["boosting_seconds"]
    print(f"# train, repeated: {sum(equal)} of {model.num_trees} trees equal bit for bit "
          f"({', '.join(TREE_FIELDS)}); boosting {b1:.3f} s, then {b2:.3f} s", flush=True)
    if model.num_trees != again.num_trees or not all(equal):
        raise AssertionError(f"two trainings on the card differ: {sum(equal)} of "
                             f"{model.num_trees} trees equal")
    return {"trees_equal": sum(equal), "boosting_seconds": [b1, b2],
            "timings_second_run": report2["timings"]}


def reset_counts(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counts(counters):
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


class FusedGraphs:
    """Captures and replays of the one-dispatch path's graphs (named
    ``FusedServe``) on every ``Workers``, as ``count_fused_graphs`` counts
    them."""

    captures = 0
    replays = 0


def count_fused_graphs(Workers):
    """Wrap ``Workers.capture`` and ``.replay`` so that each one of a
    ``FusedServe`` graph adds to ``FusedGraphs``."""
    for method, counter in (("capture", "captures"), ("replay", "replays")):
        def counted(self, i, key, *args, _real=getattr(Workers, method), _counter=counter, **kwargs):
            out = _real(self, i, key, *args, **kwargs)
            if key[0] == "FusedServe":
                setattr(FusedGraphs, _counter, getattr(FusedGraphs, _counter) + 1)
            return out

        setattr(Workers, method, counted)


def check_prediction(res, actual, n):
    accuracy = float((res.match_title_id == actual).mean())
    if res.match_title_id.shape != (n,) or not bool((res.prediction >= 0).all()):
        raise AssertionError("malformed prediction result")
    if not all(res.stage_counts[s] > 0 for s in ("exact", "fuzzy", "model")):
        raise AssertionError(f"a stage matched no rows: {res.stage_counts}")
    if accuracy < ACCURACY_FLOOR:
        raise AssertionError(f"accuracy {accuracy:.4f} < {ACCURACY_FLOOR}")
    return accuracy


def run_main_path(torch, Matcher, cfg, truth, queries, actual, model, counters, need, label,
                  untimed=None):
    """Two untimed predicts and one timed one; returns (matcher, result,
    launches, the untimed predicts' seconds and graph captures).  A graph
    is captured in the second predict that uses its shape, so the first
    predict is what a one-shot process pays (op by op, nothing captured)
    and the second captures the graphs.  ``untimed`` is a
    context manager entered around the first predict only, so that what
    it does stays out of the timed one."""
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t = time.time()
    matcher = Matcher(cfg, truth, model, device="cuda")
    torch.cuda.synchronize()
    print(f"# {label} Matcher init_seconds {json.dumps(matcher.init_seconds)} "
          f"({matcher.index.built_on} index build)", flush=True)
    phase(f"{label}_matcher_init", t)
    t = time.time()
    first = {}
    for nth in ("first", "second"):
        t1 = time.time()
        with (untimed if nth == "first" else None) or contextlib.nullcontext():
            matcher.predict(queries)
        torch.cuda.synchronize()
        first[nth] = {"seconds": time.time() - t1,
                      "captures": {k: v[0] for k, v in matcher.scorer.workers.captures.items()},
                      "capture_s": dict(matcher.scorer.workers.capture_seconds)}
    first["seconds"] = first["first"]["seconds"]
    print(f"# {label} untimed predicts: the first (one-shot, op by op) "
          f"{first['first']['seconds']:.3f} s, CUDA graphs by name "
          f"{json.dumps(first['first']['captures'])}; the second (it captures the graphs) "
          f"{first['second']['seconds']:.3f} s, of which captures (warm-ups included) "
          f"{json.dumps({k: round(v, 3) for k, v in first['second']['capture_s'].items()})} s, "
          f"{json.dumps(first['second']['captures'])}", flush=True)
    phase(f"{label}_predict_untimed", t)
    reset_counts(counters)
    if matcher.scorer.exact is not None:
        matcher.scorer.exact.union_sizes.clear()
    t = time.time()
    res = matcher.predict(queries)
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = read_counts(counters)
    phase(f"{label}_predict_timed", t)
    accuracy = check_prediction(res, actual, len(queries))
    print(f"# {label} predict: {len(queries)} queries x {len(truth)} titles in {dt:.3f} s = "
          f"{len(queries) / dt:.1f} q/s, accuracy {accuracy:.4f}", flush=True)
    print(f"# {label} stage_counts {json.dumps(res.stage_counts)}", flush=True)
    print(f"# {label} stage_seconds "
          f"{json.dumps({k: round(v, 4) for k, v in res.stage_seconds.items()})}", flush=True)
    print(f"# {label} launches in the timed predict: {json.dumps(launches)}", flush=True)
    print(f"# {label} peak device memory (Matcher init and both predicts): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB allocated, of which {resident / 1e9:.3f} GB "
          f"were resident before; {torch.cuda.max_memory_reserved() / 1e9:.3f} GB reserved in the "
          f"process (the CUDA graphs' pools among them)", flush=True)
    missing = [k for k in need if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels {missing} were not launched on the {label} path: {launches}")
    return matcher, res, launches, first


SERVE_SINGLES, SERVE_OFF, SERVE_QB8 = 200, 50, 50


def bits_equal(a, b):
    """Two host arrays equal bit for bit (NaNs and signed zeros too)."""
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def same_results(r1, r2, tol):
    """Match ids, titles and stages equal, predictions within ``tol``."""
    return (np.array_equal(r1.match_title_id, r2.match_title_id) and np.array_equal(r1.stage, r2.stage)
            and r1.match_transformed == r2.match_transformed
            and float(np.abs(r1.prediction - r2.prediction).max(initial=0.0)) <= tol)


def replay_against_eager(torch, jk, fk, fs, queries, label):
    """One request through the graph (captured here if its key is new) and
    the same request through ``fused_cascade`` op by op: stats and
    candidates equal bit for bit.  The eager run's calls of A and B are
    held against their plain versions (``check_calls``)."""
    from doppelspeller_tpu_torch.ops import features, fold

    rows = np.arange(len(queries))
    got = fs.dispatch(queries, rows)
    with Spy(jk, "score_window_select") as spy_a, Spy(fold, "score_window_select") as spy_f, \
            Spy(features, "window_best") as spy_b:
        ref = fs.dispatch(queries, rows, eager=True)
    torch.cuda.synchronize()
    if not (bits_equal(got[1], ref[1]) and bits_equal(got[2], ref[2])):
        raise AssertionError(f"serve_fused {label}: the replay differs from eager fused_cascade")
    check_calls(torch, jk, fk, spy_a.calls + spy_f.calls, spy_b.calls, f"serve_fused {label} eager")


def replay_ms(fs, queries):
    """Milliseconds of one replay of a request whose graph exists, by CUDA
    events (median of 20)."""
    _, key, _ = fs.request(queries, np.arange(len(queries)))
    return cuda_ms(fs.scorer.workers.graphs[0, key].graph.replay, reps=20, calls=1)


def profile_replay(torch, fs, queries, label, stats):
    """The device operations the profiler sees in one replay of a request
    whose graph exists and in the same request run op by op, into
    ``stats``."""
    from torch.profiler import ProfilerActivity, profile

    rows = np.arange(len(queries))
    fs.dispatch(queries, rows)          # captured again where a later engine's build dropped it
    counts = []
    for eager in (False, True):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fs.dispatch(queries, rows, eager=eager)
            torch.cuda.synchronize()
        counts.append(sum(ev.count for ev in prof.key_averages()
                          if str(getattr(ev, "device_type", "")).endswith("CUDA")))
    stats["replay_ops"], stats["eager_ops"] = counts
    print(f"# serve_fused {label}: {counts[0]} device operations (kernels, copies, fills) in one "
          f"replay by the profiler, {counts[1]} in the same request run op by op", flush=True)


def serve_fused_path(torch, jk, fk, matcher, queries, counters, smi, label):
    """The one-dispatch path on a resident Matcher (see the module docstring,
    phases 10 and 11): single titles that the exact stage does not match,
    through ``predict(single=True)`` as a caller sends them.  Returns
    (stats, the 128-query engine and a request whose graph it holds) for
    ``profile_replay``."""
    from doppelspeller_tpu_torch import cli
    from doppelspeller_tpu_torch.utils.io import TitleSet, single_title_set

    cfg = matcher.cfg
    titles = [t for t, tr in zip(queries.titles, queries.transformed) if tr not in matcher.reverse]
    titles = titles[:SERVE_SINGLES]
    matcher._fused = None
    fs = matcher._fused_engine()
    replay_against_eager(torch, jk, fk, fs, single_title_set(titles[0], cfg), label)

    def singles(ts, c):
        out, lat = [], []
        for t in ts:
            t0 = time.perf_counter()
            out.append(matcher.predict(single_title_set(t, c), single=True))
            lat.append(1e3 * (time.perf_counter() - t0))
        return out, np.array(lat)

    t = time.time()
    singles(titles, cfg)                      # captures every key these titles need
    warm_s = time.time() - t
    reset_counts(counters)
    fused, lat = singles(titles, cfg)
    launches = read_counts(counters)
    if launches["captures"] or launches["replays"] != len(titles) or launches["A"] < len(titles) \
            or launches["B"] == 0:
        raise AssertionError(f"serve_fused {label}: {len(titles)} requests made {launches}")
    matcher.cfg = cfg.with_(serve_fused="off")
    try:
        off, lat_off = singles(titles[:SERVE_OFF], matcher.cfg)
    finally:
        matcher.cfg = cfg
    n_same = sum(same_results(a, b, 1e-6) for a, b in zip(fused, off))
    stats = {"requests": len(titles), "card": smi, "qb": fs.qb,
             "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
             "off_p50_ms": float(np.percentile(lat_off, 50)),
             "off_p99_ms": float(np.percentile(lat_off, 99)), "launches": launches,
             "first_pass_seconds": warm_s,
             "capture_seconds": matcher.scorer.workers.capture_seconds.get("FusedServe", 0.0),
             "off_equal": n_same}
    probe = single_title_set(titles[0], cfg)
    stats["replay_ms"] = replay_ms(fs, probe)
    print(f"# serve_fused {label}: {len(titles)} single titles (none an exact match) through "
          f"predict(single=True), qb={fs.qb}, on {smi}: p50 {stats['p50_ms']:.3f} ms, p99 "
          f"{stats['p99_ms']:.3f} ms (host clock around predict, graphs captured in a first pass of "
          f"{warm_s:.3f} s); serve_fused='off' on the first {SERVE_OFF}: p50 "
          f"{stats['off_p50_ms']:.3f} ms, p99 {stats['off_p99_ms']:.3f} ms; results equal on "
          f"{n_same}/{SERVE_OFF} (ids, titles, stages; predictions to 1e-6)", flush=True)
    print(f"# serve_fused {label}: launches {json.dumps(launches)}; one replay {stats['replay_ms']:.3f} "
          f"ms by CUDA events (median of 20); captures {stats['capture_seconds']:.3f} s in all",
          flush=True)
    if n_same != SERVE_OFF:
        raise AssertionError(f"serve_fused {label}: the fused path and 'off' differ on "
                             f"{SERVE_OFF - n_same} of {SERVE_OFF} titles")
    if fs.mode == "folded":
        # the serve loop's 8-query blocks on the folded engine
        matcher.cfg, matcher._fused = cfg.with_(**cli.LATENCY_PROFILE), None
        try:
            fs8 = matcher._fused_engine()
            replay_against_eager(torch, jk, fk, fs8, single_title_set(titles[1], matcher.cfg),
                                 f"{label} qb={fs8.qb}")
            singles(titles[:SERVE_QB8], matcher.cfg)
            few, lat8 = singles(titles[:SERVE_QB8], matcher.cfg)
            batch = TitleSet.from_titles(titles[:8], ids=np.arange(8), config=matcher.cfg)
            b8 = matcher.predict(batch)
        finally:
            matcher.cfg, matcher._fused = cfg, None
        b128 = matcher.predict(TitleSet.from_titles(titles[:8], ids=np.arange(8), config=cfg))
        n8 = sum(same_results(a, b, 1e-6) for a, b in zip(few, fused))
        stats["qb8"] = {"p50_ms": float(np.percentile(lat8, 50)),
                        "p99_ms": float(np.percentile(lat8, 99)), "equal": n8,
                        "batch8_equal": same_results(b8, b128, 1e-6)}
        print(f"# serve_fused {label} at qb={fs8.qb} (the latency profile's blocks): "
              f"{SERVE_QB8} single titles p50 {stats['qb8']['p50_ms']:.3f} ms, p99 "
              f"{stats['qb8']['p99_ms']:.3f} ms; equal to qb={fs.qb} on {n8}/{SERVE_QB8}; a batch "
              f"of 8 equal: {stats['qb8']['batch8_equal']}", flush=True)
        if n8 != SERVE_QB8 or not stats["qb8"]["batch8_equal"]:
            raise AssertionError(f"serve_fused {label}: 8-query blocks differ from {fs.qb}-query ones")
    matcher._fused = None
    return stats, (fs, probe)


CONSTRUCTION_QUERIES = 2048
INDEX_ARRAYS = ("df", "idf", "sums", "trigrams", "title_ids")


def construction_path(torch, Matcher, model, world, label, smi):
    """``Matcher`` construction with the host and the device index build in
    turns (host, device, device, host) on one world (see the module
    docstring, phase 16): each build's seconds by piece, its peak device
    memory, and every array of its index and retrieval engine and
    ``scorer.topk`` on the first queries equal to the first build's bit for
    bit.  Returns the stats."""
    cfg, truth, queries = world
    rows = np.arange(min(CONSTRUCTION_QUERIES, len(queries)))
    ref, stats = None, {"card": smi, "host": [], "device": []}
    for impl in ("host", "device", "device", "host"):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t = time.time()
        m = Matcher(cfg.with_(index_build_impl=impl), truth, model, device="cuda",
                    use_index_checkpoint=False)
        torch.cuda.synchronize()
        total = time.time() - t
        peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
        kept = (torch.cuda.memory_allocated() - resident) / 1e9
        if m.index.built_on != impl:
            raise AssertionError(f"{label}: index_build_impl={impl!r} did not take the {impl} build")
        engine = m.scorer.exact or m.scorer.folded
        got = {"index": {f: getattr(m.index, f) for f in INDEX_ARRAYS},
               "scalars": tuple(getattr(m.index, f) for f in ("num_titles", "padded_titles",
                                                              "max_idf", "content_hash")),
               "buffers": {k: v.contiguous().view(torch.uint8) for k, v in engine.named_buffers()},
               "topk": m.scorer.topk(queries, rows=rows)}
        if ref is None:
            ref = got
        else:
            bad = [f for f in INDEX_ARRAYS if not bits_equal(ref["index"][f], got["index"][f])]
            bad += [k for k, v in ref["buffers"].items() if not torch.equal(v, got["buffers"][k])]
            if got["scalars"] != ref["scalars"] or got["buffers"].keys() != ref["buffers"].keys():
                bad.append("scalars or buffer names")
            if not (bits_equal(*(r["topk"][0] for r in (ref, got)))
                    and bits_equal(*(r["topk"][1] for r in (ref, got)))):
                bad.append(f"topk on {len(rows)} queries")
            if bad:
                raise AssertionError(f"{label}: the {impl} build differs from the host build in {bad}")
        piece = dict(m.init_seconds, total=total, peak_gb=peak, kept_gb=kept)
        stats[impl].append(piece)
        print(f"# construction {label} ({impl} build): Matcher {total:.3f} s = load "
              f"{piece['load']:.3f} + index (ids, df, sums) {piece['index']:.3f} + retrieval "
              f"({'packed' if m.scorer.exact else 'folded x2, trigram list'}) "
              f"{piece['retrieval']:.3f} + rest {piece['rest']:.3f}; device memory peak "
              f"{peak:.3f} GB, kept after construction {kept:.6f} GB, above {resident / 1e9:.3f} "
              f"resident; on {smi}", flush=True)
        del m, engine, got
    host_kept = max(p["kept_gb"] for p in stats["host"])
    if any(p["kept_gb"] > host_kept for p in stats["device"]):
        raise AssertionError(f"{label}: a device-built Matcher keeps more on the card than a "
                             f"host-built one ({[p['kept_gb'] for p in stats['device']]} GB against "
                             f"{host_kept} GB)")
    print(f"# construction {label}: host and device builds equal bit for bit (index arrays, "
          f"{len(ref['buffers'])} engine buffers, top-{ref['topk'][0].shape[1]} of {len(rows)} "
          f"queries); index seconds host "
          f"{', '.join(f'{p['index']:.3f}' for p in stats['host'])}, device "
          f"{', '.join(f'{p['index']:.3f}' for p in stats['device'])}", flush=True)
    return stats


# the host's calls that launch work on a card (graph launches included) or
# copy, as the runtime's records name them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cudaMemcpyAsync")


def profile_activity(torch, fn):
    """``fn()`` once under torch.profiler (host and device activity).
    Returns the host's ``HOST_LAUNCH_CALLS`` (the runtime's records, from
    every thread), the card's operations (kernels, copies, fills) and the
    milliseconds of card 0 covered by at least one of them (busy) and by
    two or more at once (overlap), beside the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.time() - t) * 1e3
    calls = {name: 0 for name in HOST_LAUNCH_CALLS}
    for ev in prof.key_averages():
        for name in HOST_LAUNCH_CALLS:
            if ev.key == name or ev.key.startswith(name + "_v"):
                calls[name] += ev.count
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if str(getattr(ev, "device_type", "")).endswith("CUDA") and ev.device_index == 0]
    busy = overlap = 0.0
    depth, last = 0, None
    for x, step in sorted([(a, 1) for a, _ in spans] + [(b, -1) for _, b in spans]):
        if last is not None:
            busy += (x - last) * (depth >= 1)
            overlap += (x - last) * (depth >= 2)
        depth, last = depth + step, x
    return {"wall_ms": wall_ms, "host_calls": calls, "device_ops": len(spans),
            "busy_ms": busy / 1e3, "overlap_ms": overlap / 1e3, "busy_share": busy / 1e3 / wall_ms}


def mesh_activity(torch, run, one, m, queries, label, smi):
    """One predict of the single card's Matcher and one of the mesh's under
    ``profile_activity``: the host's launches a predict, beside each other,
    and the card's busy and overlapped milliseconds."""
    out = {}
    for who, matcher in (("one", one), ("mesh", m)):
        out[who], _, _ = run(lambda: profile_activity(torch, lambda: matcher.predict(queries)),
                             who == "mesh")
    a, b = out["one"], out["mesh"]
    print(f"# mesh {label} profile, one predict each under torch.profiler on {smi}: host launch "
          f"calls single card {json.dumps(a['host_calls'])}, mesh {json.dumps(b['host_calls'])}; "
          f"card operations {a['device_ops']} / {b['device_ops']}; card busy {a['busy_ms']:.1f} of "
          f"{a['wall_ms']:.1f} ms ({100 * a['busy_share']:.1f} %) single card, {b['busy_ms']:.1f} of "
          f"{b['wall_ms']:.1f} ms ({100 * b['busy_share']:.1f} %) mesh; two or more operations at "
          f"once {a['overlap_ms']:.1f} ms single card, {b['overlap_ms']:.1f} ms mesh", flush=True)
    return out


def mesh_graphs(sc, label, smi, before=None):
    """Print the mesh's CUDA graph captures and replays by name and shard
    (replays since ``before``, a copy of an earlier ``replays``); returns
    them."""
    w = sc.workers
    before = before or {}
    replays = {name: [r - b for r, b in zip(per, before.get(name, [0] * len(per)))]
               for name, per in w.replays.items()}
    captures = {name: list(per) for name, per in w.captures.items()}
    print(f"# mesh {label}: CUDA graphs captured by name and shard {json.dumps(captures)}, "
          f"replayed {json.dumps(replays)}{' in the timed predicts' if before else ''} on {smi}",
          flush=True)
    return {"captures": captures, "replays": replays}


def single_graphs_path(torch, jk, fk, counters, smi, model, worlds):
    """One card run as the JAX package runs one device (phase 17): on each
    smoke's resident Matcher, ``worlds`` {label: (matcher, queries, actual,
    first graphed predict's stats)}, one predict op by op
    (``workers.use_graphs = False``) with every call of A and B held
    against the plain version, then timed predicts in turns (graphs, op by
    op, op by op, graphs), each with its peak device memory, and one of
    each under torch.profiler.  Every result and the top-100 must equal
    the op-by-op run's bit for bit, and the graphs' host launches (kernels
    and graph launches) a predict must stay under 1,000."""
    from doppelspeller_tpu_torch.ops import features, fold

    out = {}
    for label, (matcher, queries, actual, first) in worlds.items():
        w = matcher.scorer.workers
        matcher.set_model(model)

        def predict(graphs):
            """One predict with the counts set to 0 just before it and the
            peak memory reset: (result, launches, seconds, peak GB)."""
            w.use_graphs = graphs
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(counters)
            t = time.time()
            res = matcher.predict(queries)
            torch.cuda.synchronize()
            dt = time.time() - t
            return res, read_counts(counters), dt, (torch.cuda.max_memory_allocated() / 1e9,
                                                    torch.cuda.max_memory_reserved() / 1e9)

        with Spy(jk, "score_window_select") as spy_a, Spy(fold, "score_window_select") as spy_f, \
                Spy(features, "window_best") as spy_b, Spy(fold, "select_rescore") as spy_g:
            ref, lo, _, _ = predict(False)
        check_calls(torch, jk, fk, spy_a.calls + spy_f.calls, spy_b.calls,
                    f"single_graphs {label} op-by-op predict")
        check_calls_g(torch, fold, spy_g.calls, f"single_graphs {label} op-by-op predict")
        del spy_a, spy_f, spy_b, spy_g
        predict(True)                  # set_model dropped the model stage's graphs: captures
        topk_eager = None
        for graphs in (False, True):
            w.use_graphs = graphs
            vals, pos = matcher.scorer.topk(queries)
            torch.cuda.synchronize()
            if topk_eager is None:
                topk_eager = vals, pos
        topk_same = bits_equal(topk_eager[0], vals) and bits_equal(topk_eager[1], pos)
        rows_differing = int((topk_eager[1] != pos).any(axis=1).sum())
        before = {k: list(v) for k, v in w.replays.items()}
        runs = {True: [], False: []}
        for graphs in (True, False, False, True):
            res, launches, dt, peak = predict(graphs)
            runs[graphs].append({"s": dt, "peak_gb": peak, "launches": launches,
                                 "stage_s": res.stage_seconds})
            if not (same_results(ref, res, 0.0) and bits_equal(ref.prediction, res.prediction)):
                raise AssertionError(f"single_graphs {label}: the predict with use_graphs={graphs} "
                                     f"differs from the op-by-op run")
        replays = {k: v[0] - before.get(k, [0])[0] for k, v in w.replays.items()}
        profiles = {}
        for graphs in (True, False):
            w.use_graphs = graphs
            profiles[graphs] = profile_activity(torch, lambda: matcher.predict(queries))
        w.use_graphs = True
        acc = check_prediction(ref, actual, len(queries))
        g, e = runs[True], runs[False]
        calls = {k: profiles[k]["host_calls"] for k in profiles}
        host = {k: calls[k]["cudaLaunchKernel"] + calls[k]["cudaLaunchKernelExC"] + calls[k]["cudaGraphLaunch"]
                for k in calls}
        print(f"# single_graphs {label}: timed predicts in turns (graphs, op by op, op by op, "
              f"graphs), s: {g[0]['s']:.3f}, {e[0]['s']:.3f}, {e[1]['s']:.3f}, {g[1]['s']:.3f} on {smi}; "
              f"peak device memory allocated {max(r['peak_gb'][0] for r in g):.3f} GB through the "
              f"graphs, {max(r['peak_gb'][0] for r in e):.3f} GB op by op (reserved in the process, "
              f"the graphs' pools and every resident Matcher with them: "
              f"{max(r['peak_gb'][1] for r in g):.3f} / {max(r['peak_gb'][1] for r in e):.3f} GB); "
              f"accuracy {acc:.4f}; stage_seconds "
              f"graphs {json.dumps({k: round(v, 4) for k, v in g[-1]['stage_s'].items()})}, op by op "
              f"{json.dumps({k: round(v, 4) for k, v in e[-1]['stage_s'].items()})}", flush=True)
        print(f"# single_graphs {label}: the untimed predicts through the graphs: the first "
              f"(one-shot, op by op) {first['first']['seconds']:.3f} s, the second (its "
              f"captures) {first['second']['seconds']:.3f} s; CUDA graphs captured by name "
              f"{json.dumps({k: v[0] for k, v in w.captures.items()})}, replayed in the two timed "
              f"graph predicts {json.dumps(replays)}; launches a graph predict "
              f"{json.dumps(g[-1]['launches'])}, op by op {json.dumps(e[-1]['launches'])}", flush=True)
        print(f"# single_graphs {label} profile, one predict each under torch.profiler on {smi}: "
              f"host launch calls through the graphs {json.dumps(calls[True])}, op by op "
              f"{json.dumps(calls[False])}: kernels and graphs {host[True]} against {host[False]}; "
              f"card operations {profiles[True]['device_ops']} / {profiles[False]['device_ops']}; card "
              f"busy {profiles[True]['busy_ms']:.1f} of {profiles[True]['wall_ms']:.1f} ms "
              f"({100 * profiles[True]['busy_share']:.1f} %) through the graphs, "
              f"{profiles[False]['busy_ms']:.1f} of {profiles[False]['wall_ms']:.1f} ms "
              f"({100 * profiles[False]['busy_share']:.1f} %) op by op; top-100 equal to the op-by-op "
              f"run bit for bit: {topk_same} ({rows_differing} rows differ)", flush=True)
        if not topk_same:
            raise AssertionError(f"single_graphs {label}: the graphs' top-100 differs from the "
                                 f"op-by-op run on {rows_differing} rows")
        if not 0 < host[True] < 1000 or not all(replays.get(k) for k in ("topk", "FuzzyEngine",
                                                                        "RerankEngine")):
            raise AssertionError(f"single_graphs {label}: {host[True]} kernel and graph launches a "
                                 f"predict, replays {replays}")
        out[label] = {"graphs_s": [r["s"] for r in g], "eager_s": [r["s"] for r in e],
                      "peak_gb_graphs": [r["peak_gb"] for r in g],
                      "peak_gb_eager": [r["peak_gb"] for r in e], "first_graph_predict": first,
                      "captures": {k: v[0] for k, v in w.captures.items()}, "replays": replays,
                      "launches_graphs": g[-1]["launches"], "launches_eager": lo,
                      "host_launches": host, "profile": {str(k): v for k, v in profiles.items()},
                      "topk_equal": topk_same, "accuracy": acc}
    return out


def mesh_path(torch, counters, smi, model, refs):
    """The title-sharded mesh (``parallel/sharded.py``) on two shards of the
    one card (see the module docstring, phase 14).  ``refs`` holds the
    single card's worlds and results.  Returns the stats and each kernel's
    launches over the phase's runs."""
    from doppelspeller_tpu_torch.models.gbt import GBTParams
    from doppelspeller_tpu_torch.models.trainer import train_model
    from doppelspeller_tpu_torch.ops import features, fold
    from doppelspeller_tpu_torch.ops import features_kernels as fk
    from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
    from doppelspeller_tpu_torch.parallel.sharded import Mesh, build_sharded_index, make_mesh
    from doppelspeller_tpu_torch.pipeline import Matcher
    from doppelspeller_tpu_torch.synthetic import quick_train_rows

    mesh = Mesh((torch.device("cuda", 0),) * 2)
    stats, total = {"card": smi}, {k: 0 for k in counters}

    def run(fn, mesh_run=True):
        """``fn()`` with the counts set to 0 just before it and read just
        after; a run on the mesh adds them to the phase's launches."""
        reset_counts(counters)
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        dt = time.time() - t
        launches = read_counts(counters)
        for k, v in launches.items():
            total[k] += v if mesh_run else 0
        return out, launches, dt

    def turns(one, m, queries, label):
        """Timed predicts in turns, the single card's Matcher ``one`` and
        the mesh's ``m`` (one, m, m, one), both warm, after the same
        profiler passes; returns the mesh's last result and the stats."""
        out = {"one_s": [], "mesh_s": [], "one_stage_s": [], "mesh_stage_s": []}
        for who, matcher in (("one", one), ("mesh", m), ("mesh", m), ("one", one)):
            res, launches, dt = run(lambda: matcher.predict(queries), who == "mesh")
            out[f"{who}_s"].append(dt)
            out[f"{who}_stage_s"].append(res.stage_seconds)
            out[f"{who}_launches"] = launches
            if who == "mesh":
                mesh_res = res
        print(f"# mesh {label}, timed predicts in turns (single card, mesh, mesh, single card), "
              f"s: {', '.join(f'{x:.3f}' for x in out['one_s'][:1] + out['mesh_s'] + out['one_s'][1:])} "
              f"= {len(queries) / min(out['mesh_s']):.1f} q/s on the mesh at best, "
              f"{len(queries) / min(out['one_s']):.1f} on the single card, on {smi}; stage_seconds "
              f"mesh {json.dumps({k: round(v, 4) for k, v in out['mesh_stage_s'][-1].items()})}, "
              f"single card {json.dumps({k: round(v, 4) for k, v in out['one_stage_s'][-1].items()})}",
              flush=True)
        return mesh_res, out

    # ---- exact, 150k titles x 16,384 queries ----
    cfg_x, truth_x, queries_x, actual_x = refs["exact_world"]
    one = Matcher(cfg_x, truth_x, model, device="cuda")
    for _ in range(2):                     # the first op by op, the second captures
        one.predict(queries_x)
    t = time.time()
    m = Matcher(cfg_x, truth_x, model, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.time() - t
    sc = m.scorer
    W = sc.tb // 128
    if sc.exact is None or sc.tb != refs["exact_tb"] or any(o % sc.tb for o in sc.offsets):
        raise AssertionError(f"the exact mesh's windows are not the single card's: tb {sc.tb} "
                             f"(single {refs['exact_tb']}), offsets {sc.offsets}")
    print(f"# mesh exact 150k: Matcher(mesh=2 shards of cuda:0) in {init_s:.3f} s, init_seconds "
          f"{json.dumps(m.init_seconds)} ({sc.ntp_local} "
          f"padded titles a shard, tb {sc.tb}, W {W}, a packed shard "
          f"{sc.exact[0].packed.numel() / 1e6:.1f} MB) on {smi}", flush=True)
    # the untimed predict op by op (no graphs), every call of A and B held
    # against the plain version; then two through the graphs, which capture
    # the shapes used twice (the first) and the rest (the second)
    sc.workers.use_graphs = False
    with Spy(jk, "score_window_select") as spy_a, Spy(features, "window_best") as spy_b:
        _, lu, untimed_s = run(lambda: m.predict(queries_x))
    sc.workers.use_graphs = True
    t = time.time()
    check_calls(torch, jk, fk, spy_a.calls, spy_b.calls, "mesh exact untimed predict")
    check_s = time.time() - t
    del spy_a, spy_b
    graph_s = [run(lambda: m.predict(queries_x))[2] for _ in range(2)]
    captured = mesh_graphs(sc, f"exact 150k untimed predicts through the graphs "
                               f"({graph_s[0]:.3f}, {graph_s[1]:.3f} s)", smi)
    sc.exact[0].union_sizes.clear()
    before = {k: list(v) for k, v in sc.workers.replays.items()}
    res, timing = turns(one, m, queries_x, "exact 150k")
    graphs = mesh_graphs(sc, "exact 150k", smi, before)
    lx = timing["mesh_launches"]
    blocks = sum(sc.exact[0].union_sizes.values()) // 2
    acc = check_prediction(res, actual_x, len(queries_x))
    print(f"# mesh exact 150k predict: untimed {untimed_s:.3f} s, accuracy {acc:.4f}; A and B against "
          f"the plain versions {check_s:.3f} s; launches in a timed predict {json.dumps(lx)}", flush=True)
    if lx["A"] != 2 * blocks or lx["A gathering"] != lx["A"] or lx["B"] == 0 or lx["D"] or lx["C"]:
        raise AssertionError(f"the exact mesh did not launch A, gathering, once per shard and "
                             f"block ({blocks} blocks), and B: {lx}")
    if not same_results(res, refs["exact_res"], 0.0):
        raise AssertionError("the exact mesh's predictions differ from the single card's")
    (v2, p2), lt, _ = run(lambda: sc.topk(queries_x))
    v1, p1 = refs["exact_topk"]
    if not (bits_equal(v1, v2) and np.array_equal(p1, p2)):
        raise AssertionError(f"the exact mesh's top-k differs from the single card's on "
                             f"{int((p1 != p2).any(axis=1).sum())} rows")
    print(f"# mesh exact 150k: top-{p1.shape[1]} scores and positions of all {len(p1)} queries "
          f"equal the single card's bit for bit; predictions equal row for row (ids, titles, "
          f"stages, predictions)", flush=True)
    if graphs["replays"]["topk"] != [2 * blocks] * 2 or not all(
            sum(graphs["replays"].get(name, [])) for name in ("FuzzyEngine", "RerankEngine")):
        raise AssertionError(f"the exact mesh did not replay a retrieval graph per shard and "
                             f"block, and the fuzzy and model stages' graphs: {graphs}")
    activity = mesh_activity(torch, run, one, m, queries_x, "exact 150k", smi)
    stats["exact"] = {"init_s": init_s, "untimed_s": untimed_s, **timing, "accuracy": acc,
                      "launches": lx, "blocks": blocks, "check_s": check_s,
                      "untimed_launches": lu, "topk_launches": lt, "graph_untimed_s": graph_s,
                      "captures": captured["captures"], "replays": graphs["replays"],
                      "profile": activity}
    m.close()
    del m, sc, one
    torch.cuda.empty_cache()

    # ---- folded, 500k titles x 16,384 queries ----
    cfg, truth, queries, actual = refs["folded_world"]
    one = refs["folded_matcher"]
    one.set_model(model)
    one.predict(queries)
    t = time.time()
    m = Matcher(cfg, truth, model, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.time() - t
    sc = m.scorer
    if sc.folded is None:
        raise AssertionError("the 500k mesh did not take folded retrieval")
    print(f"# mesh folded 500k: Matcher(mesh=2 shards of cuda:0) in {init_s:.3f} s, init_seconds "
          f"{json.dumps(m.init_seconds)} ({sc.ntp_local} titles a shard, Mc {sc.folded[0].mc.numel() / 1e6:.1f} MB a shard, "
          f"ltw {sc.folded[0].ltw}) on {smi}", flush=True)
    sc.workers.use_graphs = False
    with Spy(fold, "score_window_select") as spy_f, Spy(features, "window_best") as spy_b:
        _, lf, untimed_s = run(lambda: m.predict(queries))
    sc.workers.use_graphs = True
    on_shards = {id(e.mc) for e in sc.folded}
    folds2 = [c for c in spy_f.calls if c[1]["folds"] == 2 and id(c[0][0]) in on_shards]
    shards_hit = {id(c[0][0]) for c in folds2}
    t = time.time()
    check_calls(torch, jk, fk, spy_f.calls, spy_b.calls, "mesh folded untimed predict")
    check_s = time.time() - t
    del spy_f, spy_b
    graph_s = [run(lambda: m.predict(queries))[2] for _ in range(2)]
    captured = mesh_graphs(sc, f"folded 500k untimed predicts through the graphs "
                               f"({graph_s[0]:.3f}, {graph_s[1]:.3f} s)", smi)
    before = {k: list(v) for k, v in sc.workers.replays.items()}
    res, timing = turns(one, m, queries, "folded 500k")
    graphs = mesh_graphs(sc, "folded 500k", smi, before)
    acc = check_prediction(res, actual, len(queries))
    acc_one = refs["folded_accuracy"]
    (v2, _), _, _ = run(lambda: sc.topk(queries))
    v1 = refs["folded_topk"]
    dominate = float((v2 >= v1).all(axis=1).mean())
    print(f"# mesh folded 500k predict: untimed {untimed_s:.3f} s (it builds the model stage's engine), "
          f"accuracy {acc:.4f} against the single card's {acc_one:.4f}; A launched {lf['A']} times "
          f"in the untimed predict, {len(folds2)} with folds=2 on the shards' folded matrices "
          f"({len(shards_hit)} shards); A and B against the plain versions {check_s:.3f} s; rows "
          f"whose mesh top-k dominates the single card's score by score: {dominate:.6f}", flush=True)
    if len(shards_hit) != 2 or len(folds2) != lf["A"] or lf["A gathering"]:
        raise AssertionError(f"the folded mesh did not launch A with folds=2 on each shard: {lf}")
    if abs(acc - acc_one) > 0.01:
        raise AssertionError(f"the folded mesh's accuracy {acc:.4f} is not within 0.01 of {acc_one:.4f}")
    blocks = timing["mesh_launches"]["A"] // 2               # A launches once a shard and block
    if graphs["replays"]["topk"] != [2 * blocks] * 2 or captured["captures"]["topk"] != [1, 1]:
        raise AssertionError(f"the folded mesh did not replay one graph a shard for each launch "
                             f"of A: {graphs}, {captured}, {timing['mesh_launches']}")
    activity = mesh_activity(torch, run, one, m, queries, "folded 500k", smi)
    stats["folded"] = {"init_s": init_s, "untimed_s": untimed_s, **timing, "accuracy": acc,
                       "accuracy_single": acc_one, "dominating_rows": dominate, "launches": lf,
                       "check_s": check_s, "graph_untimed_s": graph_s,
                       "captures": captured["captures"], "replays": graphs["replays"],
                       "profile": activity}
    m.close()
    del m, sc, one
    torch.cuda.empty_cache()

    # ---- the oracle sample: retrieval under the oracle config ----
    sample, cfg_o = refs["oracle_sample"], refs["oracle_cfg"]
    t = time.time()
    sc = build_sharded_index(truth, mesh, cfg_o)
    torch.cuda.synchronize()
    init_s = time.time() - t
    (v2, p2), lo, dt = run(lambda: sc.topk(sample))
    v1, p1 = refs["oracle_topk"]
    blocks = sum(sc.exact[0].union_sizes.values())
    print(f"# mesh oracle sample: build_sharded_index {init_s:.3f} s (a packed shard "
          f"{sc.exact[0].packed.numel() / 1e9:.2f} GB), retrieval of {len(sample)} queries "
          f"{dt:.3f} s (graph captures included) on {smi}; launches {json.dumps(lo)}; candidates "
          f"equal the single card's bit for bit: {bits_equal(v1, v2) and np.array_equal(p1, p2)}",
          flush=True)
    captured = mesh_graphs(sc, "oracle sample", smi)
    if lo["D"] != 2 * blocks or lo["A"] or lo["C"]:
        raise AssertionError(f"the oracle mesh did not launch D once per shard and block alone: {lo}")
    if not (bits_equal(v1, v2) and np.array_equal(p1, p2)):
        raise AssertionError("the oracle mesh's candidates differ from the single card's")
    stats["oracle"] = {"init_s": init_s, "retrieval_s": dt, "launches": lo, "blocks": blocks,
                       **captured}
    sc.close()
    del sc
    torch.cuda.empty_cache()

    # ---- training: retrieval on the sharded index, data-parallel boosting ----
    sub, train = quick_train_rows(cfg, truth)
    params = GBTParams.from_config(cfg)
    params.num_boost_round = params.early_stopping_rounds = TRAIN_ROUNDS
    (own, report), ltr, dt = run(lambda: train_model(cfg, train=train, truth=sub, params=params,
                                                     save=False, mesh=mesh))
    ref = refs["train_model"]
    equal = [all(getattr(own, k)[i].tobytes() == getattr(ref, k)[i].tobytes() for k in TREE_FIELDS)
             for i in range(min(own.num_trees, ref.num_trees))]
    print(f"# mesh train: {dt:.3f} s, timings (s) "
          f"{json.dumps({k: round(v, 3) for k, v in report['timings'].items()})} on {smi}; "
          f"{sum(equal)} of {ref.num_trees} trees equal the train phase's bit for bit; launches "
          f"{json.dumps(ltr)}", flush=True)
    if own.num_trees != ref.num_trees or not all(equal):
        raise AssertionError("the mesh's training differs from the single card's")
    if ltr["A"] == 0 or ltr["A gathering"] != ltr["A"] or ltr["B"] == 0:
        raise AssertionError(f"the mesh's training did not launch A (gathering) and B: {ltr}")
    stats["train"] = {"seconds": dt, "timings": report["timings"], "trees_equal": sum(equal),
                      "launches": ltr}

    # ---- a real mesh over the machine's cards ----
    real = make_mesh()
    n = torch.cuda.device_count()
    if n == 1:
        try:
            make_mesh(2)
        except ValueError as exc:
            refused = str(exc)
        else:
            raise AssertionError("make_mesh(2) did not raise on a machine of one card")
        if refused != "need 2 devices, have 1":
            raise AssertionError(f"make_mesh(2) raised {refused!r}")
    t = time.time()
    on_real = Matcher(cfg_x, truth_x, model, mesh=real)
    res, lr, _ = run(lambda: on_real.predict(queries_x))
    dt = time.time() - t
    on_real.close()
    print(f"# mesh make_mesh(): {real.size} card(s) {[str(d) for d in real.devices]}; the exact "
          f"150k Matcher and one predict {dt:.3f} s; equal to the single card's: "
          f"{same_results(res, refs['exact_res'], 0.0)}" + ("; make_mesh(2) raised "
                                                    f"{refused!r}" if n == 1 else ""), flush=True)
    if not same_results(res, refs["exact_res"], 0.0):
        raise AssertionError("the predict on make_mesh() differs from the single card's")
    stats["real_mesh"] = {"cards": real.size, "seconds": dt, "launches": lr}
    torch.cuda.empty_cache()
    return stats, total


# the reference example set's size (30,000 truth titles, 10,000 train and
# 10,000 test rows), drawn as one synthetic world; the train rows are cut to
# the world's first 5,000 queries to keep the phase near a minute (the test
# rows stay the last 10,000)
CLI_TITLES, CLI_QUERIES, CLI_TEST_ROWS, CLI_TRAIN_ROWS = 30_000, 20_000, 10_000, 5_000
SERVE_TIMED = 200



def write_example_set(make_world, cfg0, data_path):
    """One world of 30,000 titles and 20,000 queries (seed 7) as the four
    pipe-delimited CSVs of the example set: the truth, the first
    ``CLI_TRAIN_ROWS`` queries with their ``q_actual`` as the train rows,
    the last 10,000 as the test rows and their actuals.  Returns (truth,
    test titles, test actuals)."""
    import csv

    _, truth, queries, actual = make_world(CLI_TITLES, CLI_QUERIES, seed=SEED, config=cfg0)

    def write(name, header, rows):
        with open(os.path.join(data_path, name), "w", newline="") as f:
            w = csv.writer(f, delimiter="|", lineterminator="\n")
            w.writerow(header)
            w.writerows(rows)

    n, t0 = CLI_TRAIN_ROWS, CLI_QUERIES - CLI_TEST_ROWS
    write("example_truth.csv", ["company_id", "name"], zip(truth.ids.tolist(), truth.titles))
    write("example_train.csv", ["train_index", "name", "company_id"],
          ((i, queries.titles[i], int(actual[i])) for i in range(n)))
    write("example_test.csv", ["test_index", "name"],
          ((i - t0, queries.titles[i]) for i in range(t0, CLI_QUERIES)))
    write("example_test_with_actuals.csv", ["test_index", "name", "company_id"],
          ((i - t0, queries.titles[i], int(actual[i])) for i in range(t0, CLI_QUERIES)))
    share = float((actual[:n] == -1).mean())
    print(f"# cli: example set written ({CLI_TITLES} truth titles, {n} train rows, "
          f"{CLI_TEST_ROWS} test rows); {100 * share:.1f} % of the train rows are labelled -1 "
          f"(the reference example set: about 40 %)", flush=True)
    return truth, queries.titles[t0:], actual[t0:]


class LogRecords(logging.Handler):
    """Keeps the package's log messages (INFO and up) of the cli phase."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def run_verb(torch, cli, argv, counters, stdin=None):
    """One verb in-process through ``cli.main``, with the launch counts set
    to 0 just before it and read just after.  Returns (stdout, stderr,
    launches, seconds)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    saved_stdin = sys.stdin
    sys.stdin = io.StringIO(stdin or "")
    reset_counts(counters)
    t = time.time()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        sys.stdin = saved_stdin
    dt = time.time() - t
    launches = read_counts(counters)
    if argv[0] != "serve":
        for line in out.getvalue().splitlines():
            print(f"# cli {argv[0]} | {line}", flush=True)
    print(f"# cli {argv[0]}: {dt:.3f} s, launches {json.dumps(launches)}", flush=True)
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}: {err.getvalue()}")
    if launches["C"] or launches["D"] or launches["E"]:
        raise AssertionError(f"cli {argv[0]} launched a kernel off its path: {launches}")
    return out.getvalue(), err.getvalue(), launches, dt


def union_batch(matcher, cfg, titles, width, lo, hi):
    """The first 8 queries of ``width`` consecutive titles each, none an
    exact match, whose block's trigram union lies in (lo, hi] rows."""
    from doppelspeller_tpu_torch.ops.ngram_index import plan_query_blocks
    from doppelspeller_tpu_torch.utils.io import TitleSet

    for j in range(0, len(titles) - 8 * width, 8 * width):
        batch = [" ".join(titles[j + i * width : j + (i + 1) * width]) for i in range(8)]
        qs = TitleSet.from_titles(batch, config=cfg)
        if any(t in matcher.reverse for t in qs.transformed):
            continue
        if lo < plan_query_blocks(qs, matcher.index, cfg)[0].union_ids.shape[0] <= hi:
            return batch
    raise AssertionError(f"no batch of 8 x {width} titles has a union in ({lo}, {hi}]")


def read_output(path):
    from doppelspeller_tpu_torch.utils.io import as_int64, read_csv

    cols = read_csv(path, "|")
    return dict(zip(as_int64(cols["test_index"]).tolist(), as_int64(cols["title_id"]).tolist()))


def run_cli_path(torch, counters, smi):
    """The command-line verbs at the example set's size, in-process through
    ``cli.main`` on the card (see the module docstring, phase 15)."""
    import ast
    import tempfile
    from collections import Counter

    from doppelspeller_tpu_torch import cli
    from doppelspeller_tpu_torch.config import Config, get_config, set_config
    from doppelspeller_tpu_torch.models import trainer
    from doppelspeller_tpu_torch.ops import features
    from doppelspeller_tpu_torch.ops import features_kernels as fk
    from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
    from doppelspeller_tpu_torch.pipeline import Matcher
    from doppelspeller_tpu_torch.synthetic import make_synthetic_world
    from doppelspeller_tpu_torch.utils.io import TitleSet, load_test_data, single_title_set

    logging.basicConfig(stream=sys.stdout, level=logging.WARNING,
                        format="[%(asctime)s]%(levelname)s|%(name)s|%(message)s")
    records = LogRecords()
    pkg_log = logging.getLogger("doppelspeller_tpu_torch")
    pkg_log.addHandler(records)
    pkg_log.setLevel(logging.INFO)
    pkg_log.propagate = False
    stats = {"launches": {}, "seconds": {}}
    try:
        with tempfile.TemporaryDirectory(prefix="doppel_cli_") as data:
            set_config(Config(data_path=data))
            cfg = get_config()
            t = time.time()
            truth, test_titles, test_actual = write_example_set(make_synthetic_world, cfg, data)
            phase("cli_world", t)

            def verb(argv, stdin=None, spy=True):
                with Spy(jk, "score_window_select") as spy_a, Spy(features, "window_best") as spy_b:
                    out, err, launches, dt = run_verb(torch, cli, argv, counters, stdin)
                key = " ".join(argv[:1] + argv[-2:]) if "--devices" in argv else argv[0]
                stats["launches"][key] = launches
                stats["seconds"][key] = dt
                if launches["A"] != launches["A gathering"]:
                    raise AssertionError(f"cli {argv[0]}: A launched without gathering: {launches}")
                if spy:
                    t1 = time.time()
                    _, unions, _ = check_calls(torch, jk, fk, spy_a.calls, spy_b.calls, f"cli {argv[0]}")
                    stats.setdefault("unions", {})[argv[0]] = unions
                    print(f"# cli {argv[0]}: kernel checks {time.time() - t1:.3f} s", flush=True)
                return out, err, launches

            records.messages.clear()
            out, _, _ = verb(["build-index"], spy=False)
            if f"index saved to {cfg.index_path} ({CLI_TITLES} titles" not in out:
                raise AssertionError(f"build-index printed {out!r}")
            if not any("device build on cuda" in m for m in records.messages):
                raise AssertionError(f"build-index did not take the device build: {records.messages}")
            print(f"# cli build-index: the device build, {stats['seconds']['build-index']:.3f} s "
                  f"on {smi}", flush=True)

            with Spy(trainer, "train_model") as spy_t:
                out, _, lt = verb(["train-model"])
            model, report = spy_t.calls[0][2]
            del spy_t
            print(f"# cli train-model: {model.num_trees} trees of at most {cfg.gbt_num_boost_round} "
                  f"(early stopping at {cfg.gbt_early_stopping_rounds}), best_ntree_limit "
                  f"{model.best_ntree_limit}; timings (s) "
                  f"{json.dumps({k: round(v, 3) for k, v in report['timings'].items()})}; pairs "
                  f"{report['n_pairs']} {json.dumps(report['pairs_by_kind'])}", flush=True)
            stats["train"] = {"trees": model.num_trees, "best_ntree_limit": model.best_ntree_limit,
                              "timings": report["timings"], "n_pairs": report["n_pairs"],
                              "pairs_by_kind": report["pairs_by_kind"]}
            if lt["A"] == 0 or lt["B"] == 0 or (cfg.gbt_num_boost_round, cfg.gbt_early_stopping_rounds) != (1000, 50):
                raise AssertionError(f"train-model: launches {lt}, rounds {cfg.gbt_num_boost_round}")

            def generate(label):
                records.messages.clear()
                _, _, lg = verb(["generate-predictions"])
                if lg["A"] == 0 or lg["B"] == 0:
                    raise AssertionError(f"generate-predictions ({label}) did not launch A and B: {lg}")
                loaded = any("loaded index checkpoint" in m for m in records.messages)
                print(f"# cli generate-predictions ({label}): loaded the index checkpoint: {loaded}",
                      flush=True)
                if not loaded:
                    raise AssertionError(f"generate-predictions ({label}) did not load the checkpoint")
                with open(cfg.final_output_path, "rb") as f:
                    return f.read()

            first = generate("first")
            out, _, _ = verb(["get-predictions-accuracy"], spy=False)
            counts = {k: int(v) for k, v in re.findall(r"^(.+?)\s{2,}(\d+)$", out, re.M)}
            acc = (counts["Correctly matched titles"] + counts["Correctly marked as not-found"]) / len(test_titles)
            stats["report"], stats["accuracy"] = counts, acc
            print(f"# cli accuracy from the report: {acc:.4f} (floor {ACCURACY_FLOOR})", flush=True)
            if acc < ACCURACY_FLOOR:
                raise AssertionError(f"cli accuracy {acc:.4f} < {ACCURACY_FLOOR}")

            # the same files and model through an in-process Matcher
            t = time.time()
            ref = Matcher(cfg, device="cuda").predict(load_test_data(cfg))
            written = read_output(cfg.final_output_path)
            same = sum(written[int(i)] == int(m) for i, m in zip(ref.test_index, ref.match_title_id))
            print(f"# cli final_output.csv equals an in-process Matcher.predict on {same}/{len(ref.test_index)} "
                  f"rows ({time.time() - t:.3f} s)", flush=True)
            if same != len(ref.test_index) or len(written) != len(ref.test_index):
                raise AssertionError("final_output.csv differs from the in-process predict")
            if generate("second") != first:
                raise AssertionError("a second generate-predictions wrote another file")

            # a mesh of one card: build-index writes through ShardedJaccardScorer.save,
            # generate-predictions loads the checkpoint onto the mesh
            verb(["build-index", "--devices", "1"], spy=False)
            records.messages.clear()
            _, _, lm = verb(["generate-predictions", "--devices", "1"])
            onto = any("onto the mesh" in m for m in records.messages)
            with open(cfg.final_output_path, "rb") as f:
                mesh_same = f.read() == first
            print(f"# cli generate-predictions --devices 1: loaded the checkpoint onto the mesh: "
                  f"{onto}; final_output.csv equal to the single device's: {mesh_same}", flush=True)
            if not (onto and mesh_same) or lm["A"] == 0 or lm["B"] == 0:
                raise AssertionError(f"generate-predictions --devices 1: onto the mesh {onto}, same "
                                     f"file {mesh_same}, launches {lm}")

            # the module entry as its own process
            t = time.time()
            env = dict(os.environ, PROJECT_DATA_PATH=data, PYTHONPATH=ROOT)
            proc = subprocess.run([sys.executable, "-m", "doppelspeller_tpu_torch.cli", "generate-predictions"],
                                  cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
            with open(cfg.final_output_path, "rb") as f:
                sub_same = f.read() == first
            stats["seconds"]["subprocess"] = time.time() - t
            print(f"# cli python -m doppelspeller_tpu_torch.cli generate-predictions: exit "
                  f"{proc.returncode}, {stats['seconds']['subprocess']:.3f} s, same file: {sub_same}; "
                  f"stdout {proc.stdout.strip()!r}", flush=True)
            if proc.returncode != 0 or not sub_same:
                raise AssertionError(f"the module entry failed or wrote another file: {proc.stderr[-2000:]}")

            # single titles
            seen = Counter(truth.transformed)
            i = next(i for i, t in enumerate(truth.transformed) if seen[t] == 1)
            out, _, _ = verb(["closest-search-single-title", "-t", truth.titles[i]], spy=False)
            found = ast.literal_eval(out.strip().split("Closest match: ", 1)[1])
            if found["match_title_id"] != int(truth.ids[i]):
                raise AssertionError(f"closest-search-single-title {truth.titles[i]!r}: {found}")

            # serve under the latency profile against an in-process Matcher
            lat_cfg = cfg.with_(**cli.LATENCY_PROFILE)
            m_lat = Matcher(lat_cfg, device="cuda")
            # a single title takes a union of 128 rows; a batch of 8 titles
            # and one of 8 pairs of titles, none an exact match, 256 and 512:
            # the profile's small unions
            batches = [union_batch(m_lat, lat_cfg, test_titles, w, lo, hi)
                       for w, lo, hi in ((1, 128, 256), (2, 256, 512))]
            first = len(test_titles) - 2 - SERVE_TIMED
            requests = ([test_titles[first], json.dumps({"id": 7, "title": test_titles[first + 1]})]
                        + [json.dumps({"titles": b}) for b in batches] + ["{not json"])
            timed = list(test_titles[first + 2 : first + 2 + SERVE_TIMED])
            out, err, ls = verb(["serve", "--profile", "latency"],
                                "\n".join(requests + timed) + "\n")
            replies = [json.loads(line) for line in out.splitlines()]
            def replies_of(m):
                c = m.cfg
                out = [m.predict(single_title_set(test_titles[first + j], c),
                                 single=True).single_result() for j in (0, 1)]
                out[0]["title"] = test_titles[first]
                out[1].update(test_index=7, title=test_titles[first + 1])
                for b in batches:
                    res = m.predict(TitleSet.from_titles(b, ids=np.arange(8), config=c))
                    out.append({"results": [
                        {"title": b[j], "transformed_title": res.transformed[j],
                         "match_title_id": int(res.match_title_id[j]),
                         "match_transformed_title": res.match_transformed[j],
                         "prediction": float(res.prediction[j])} for j in range(8)]})
                return out

            def close(a, b):
                """Replies equal, predictions within 1e-6."""
                if isinstance(a, dict):
                    return a.keys() == b.keys() and all(
                        abs(a[k] - b[k]) <= 1e-6 if k == "prediction" else close(a[k], b[k]) for k in a)
                if isinstance(a, list):
                    return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
                return a == b

            expect = replies_of(m_lat)
            # the same requests through the staged path
            expect_off = replies_of(Matcher(lat_cfg.with_(serve_fused="off"), device="cuda"))
            n_req = len(requests)
            got = [{k: v for k, v in r.items() if k != "latency_ms"} for r in replies[: n_req - 1]]
            if got != expect or "error" not in replies[n_req - 1] or len(replies) != n_req + SERVE_TIMED:
                raise AssertionError(f"serve's replies differ from the in-process Matcher: {got} vs {expect}")
            if not close(got, expect_off):
                raise AssertionError(f"serve's replies differ from serve_fused='off': {got} vs {expect_off}")
            if not {128, 256, 512} <= set(stats["unions"]["serve"]):
                raise AssertionError(f"serve's calls of A missed a union of 128-512 rows: "
                                     f"{stats['unions']['serve']}")
            lat = np.array([r["latency_ms"] for r in replies[n_req:]])
            p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
            # where a single title's time goes: the same path's stage clocks
            split = [m_lat.predict(single_title_set(t, lat_cfg), single=True).stage_seconds
                     for t in timed[:50]]
            split = {k: 1e3 * float(np.mean([d[k] for d in split])) for k in split[0]}
            stats["serve"] = {"p50_ms": p50, "p99_ms": p99, "requests": SERVE_TIMED, "card": smi,
                              "ready": err.strip(), "stage_ms_mean_of_50": split}
            print(f"# cli serve --profile latency: {err.strip()}; {n_req - 1} scripted replies "
                  f"equal the in-process Matcher's (and serve_fused='off''s, predictions to 1e-6), "
                  f"the malformed line answered "
                  f"{replies[n_req - 1]}; {SERVE_TIMED} single titles after warm-up: p50 {p50:.3f} ms, "
                  f"p99 {p99:.3f} ms (latency_ms of the replies, host clock around predict) on {smi}; "
                  f"a single title's stage_seconds in ms, mean of 50 (the one-dispatch path charges "
                  f"a request's whole time to retrieval): "
                  f"{json.dumps({k: round(v, 3) for k, v in split.items()})}", flush=True)
            if ls["A"] == 0 or ls["replays"] == 0:
                raise AssertionError(f"serve did not launch kernel A through graph replays: {ls}")
    finally:
        pkg_log.removeHandler(records)
        pkg_log.propagate = True
        pkg_log.setLevel(logging.NOTSET)
    return stats


def time_predicts(torch, reps):
    """``python3 chip_smoke.py time-predicts [reps]``: the two 16,384-query
    main paths alone (folded 500k, exact 150k; default config, the
    committed model), two untimed predicts (the first is a one-shot
    process's, op by op; the second captures the graphs) and ``reps``
    timed ones each, no profiler in the process; every rep's seconds and
    stage seconds, then the medians, the untimed predicts' seconds and
    stage seconds, the captures' seconds by name, and the timed reps' peak
    device memory (allocated, and reserved by the caching allocator, which
    holds the CUDA graphs' pools) as one JSON line.  It times the package
    beside this file, so a copy of it placed in another checkout times
    that one."""
    from doppelspeller_tpu_torch.config import Config
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.pipeline import Matcher
    from doppelspeller_tpu_torch.synthetic import make_synthetic_world

    model = GBTModel.load(MODEL)
    out = {}
    for label, n_titles in (("folded", N_TITLES), ("exact", N_TITLES_EXACT)):
        cfg, truth, queries, actual = make_synthetic_world(
            n_titles, N_QUERIES, seed=SEED, config=Config(data_path=os.path.join(ROOT, "data")))
        matcher = Matcher(cfg, truth, model, device="cuda")
        untimed, untimed_stages = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.time()
            res = matcher.predict(queries)
            torch.cuda.synchronize()
            untimed.append(time.time() - t)
            untimed_stages.append(res.stage_seconds)
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for r in range(reps):
            torch.cuda.synchronize()
            t = time.time()
            res = matcher.predict(queries)
            torch.cuda.synchronize()
            secs.append(time.time() - t)
            print(f"# {label} rep {r}: {secs[-1]:.3f} s, stage_seconds "
                  f"{json.dumps({k: round(v, 4) for k, v in res.stage_seconds.items()})}", flush=True)
        med = statistics.median(secs)
        out[label] = {"median_s": med, "q_per_s": N_QUERIES / med, "seconds": secs,
                      "first_predict_s": untimed[0], "second_predict_s": untimed[1],
                      "untimed_stage_s": untimed_stages,
                      "capture_s": dict(getattr(getattr(matcher.scorer, "workers", None),
                                                "capture_seconds", {})),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                      "accuracy": float((res.match_title_id == actual).mean())}
        del matcher
        torch.cuda.empty_cache()
    print(json.dumps({"checkout": ROOT, "predicts": out}), flush=True)
    return 0


CLI_VERBS = ("train-model", "generate-predictions")


def time_cli(torch, reps):
    """``python3 chip_smoke.py time-cli [reps]``: the command-line verbs as a
    user runs them, each in a process of its own (``python -m
    doppelspeller_tpu_torch.cli VERB``, Python's start, the imports and the
    card's set-up included), on the cli phase's example set, written once
    into a temporary directory: ``build-index``, a round of ``train-model``
    and ``generate-predictions`` that builds the kernels, then ``reps``
    timed rounds.  Prints each process's seconds by the host clock around
    it, then the medians and the accuracy of the last predictions file as
    one JSON line.  It runs the package beside this file, so a copy of it
    placed in another checkout times that one."""
    import tempfile

    from doppelspeller_tpu_torch.config import Config
    from doppelspeller_tpu_torch.synthetic import make_synthetic_world

    del torch                              # each verb is a process of its own
    secs = {v: [] for v in ("build-index",) + CLI_VERBS}
    with tempfile.TemporaryDirectory(prefix="doppel_time_cli_") as data:
        write_example_set(make_synthetic_world, Config(data_path=data), data)
        env = dict(os.environ, PROJECT_DATA_PATH=data, PYTHONPATH=ROOT)

        def verb(name, label):
            t = time.time()
            done = subprocess.run([sys.executable, "-m", "doppelspeller_tpu_torch.cli", name],
                                  cwd=ROOT, env=env, capture_output=True, text=True)
            dt = time.time() - t
            if done.returncode != 0:
                raise AssertionError(f"time-cli: {name} exited {done.returncode}: {done.stderr[-2000:]}")
            print(f"# time-cli {label} {name}: {dt:.3f} s", flush=True)
            return dt, done.stdout

        secs["build-index"].append(verb("build-index", "once")[0])
        for r in range(-1, reps):
            for name in CLI_VERBS:
                dt, out = verb(name, "warm-up" if r < 0 else f"rep {r}")
                if r >= 0:
                    secs[name].append(dt)
        report = verb("get-predictions-accuracy", "once")[1]
    matched = re.search(r"Correctly matched titles\s+(\d+)", report)
    out = {"checkout": ROOT, "seconds": secs,
           "median_s": {k: statistics.median(v) for k, v in secs.items()},
           "correctly_matched": int(matched.group(1)) if matched else None}
    print(json.dumps({"time_cli": out}), flush=True)
    return 0


def main() -> int:
    t0 = time.time()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda}; {kind}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["time-predicts"]:
        return time_predicts(torch, int(sys.argv[2]) if len(sys.argv) > 2 else 5)
    if sys.argv[1:2] == ["time-cli"]:
        return time_cli(torch, int(sys.argv[2]) if len(sys.argv) > 2 else 3)
    from doppelspeller_tpu_torch import _build
    from doppelspeller_tpu_torch.ops import features_kernels as fk
    from doppelspeller_tpu_torch.ops import fold
    from doppelspeller_tpu_torch.ops import jaccard_kernels as jk
    from doppelspeller_tpu_torch.ops import levenshtein as lev
    phase("device", t0)

    t = time.time()
    paths = _build.build()
    _build.lib()
    print(f"# built {len(paths)} libraries in {_build.BUILD_SECONDS or 0.0:.1f} s: "
          f"{', '.join(os.path.relpath(p, ROOT) for p in paths.values())}", flush=True)
    hgmma = check_tensor_cores(_build, paths)
    print_ptxas(_build)
    phase("build", t)

    t = time.time()
    ka = check_kernel_a(torch, jk)
    phase("kernel_a", t)
    t = time.time()
    kb = check_kernel_b(torch, fk)
    phase("kernel_b", t)
    t = time.time()
    kf = check_kernel_f(torch, lev)
    phase("kernel_f", t)
    t = time.time()
    kg = check_kernel_g(torch, fold)
    torch.cuda.empty_cache()
    phase("kernel_g", t)
    t = time.time()
    d = union_inputs(torch)
    kc = check_kernel_c(torch, jk, d)
    phase("kernel_c", t)
    t = time.time()
    kd = check_kernel_d(torch, jk, d)
    phase("kernel_d", t)
    t = time.time()
    ke = check_kernel_e(torch, jk, d)
    phase("kernel_e", t)
    del d
    torch.cuda.empty_cache()

    from doppelspeller_tpu_torch.config import Config
    from doppelspeller_tpu_torch.models.gbt import GBTModel
    from doppelspeller_tpu_torch.ops.ngram_index import build_packed_matrix, plan_query_blocks
    from doppelspeller_tpu_torch.pipeline import Matcher
    from doppelspeller_tpu_torch.synthetic import make_synthetic_world, quick_train_model
    from doppelspeller_tpu_torch.utils.io import TitleSet

    model = GBTModel.load(MODEL)
    cfg0 = Config(data_path=os.path.join(ROOT, "data"))
    # launches of each kernel's wrapper; "A gathering" are those launches of
    # A that read the union's rows through their ids
    counters = {name: (fn, "launches") for name, fn in
                (("A", jk.score_window_select), ("B", fk.window_best), ("C", jk.gather_rows),
                 ("D", jk.score_full), ("E", jk.jaccard_topk_v1), ("F", lev.lcs),
                 ("G", fold.select_rescore))}
    counters["A gathering"] = (jk.score_window_select, "gathered")
    # CUDA graphs of the one-dispatch path, captured and replayed
    from doppelspeller_tpu_torch.parallel.workers import Workers

    count_fused_graphs(Workers)
    counters["captures"] = (FusedGraphs, "captures")
    counters["replays"] = (FusedGraphs, "replays")

    # ---- small worlds: card vs the plain CPU path ----
    t = time.time()
    engine = check_small_world(torch, Matcher, make_synthetic_world, model,
                               cfg0.with_(retrieval_mode="folded", score_dtype="float32"), "f32")
    assert engine == "folded"
    engine = check_small_world(torch, Matcher, make_synthetic_world, model, cfg0, "default config",
                               small_batch=True)
    if engine != "exact":
        raise AssertionError("the default config did not resolve to exact retrieval at 4,096 titles")
    check_small_truth(torch, Matcher, make_synthetic_world, model, cfg0)
    phase("small_worlds", t)

    def packed_build_seconds(matcher):
        torch.cuda.synchronize()
        t1 = time.time()
        packed = build_packed_matrix(matcher.index, "cuda")
        torch.cuda.synchronize()
        sec = time.time() - t1
        print(f"# packed index {tuple(packed.shape)} = {packed.numel() / 1e9:.3f} GB built on "
              f"the card in {sec:.3f} s", flush=True)
        return sec

    # ---- folded main path: 500k titles ----
    t = time.time()
    cfg, truth, queries, actual = make_synthetic_world(N_TITLES, N_QUERIES, seed=SEED, config=cfg0)
    phase("folded_world", t)

    # ---- train: the port's own model, before any large Matcher is resident ----
    t = time.time()
    own_model, train = train_on_card(torch, quick_train_model, cfg, truth, model, counters)
    torch.cuda.empty_cache()
    phase("train", t)
    from doppelspeller_tpu_torch.ops import features

    slab = Spy(features, "window_best")
    with Spy(lev, "lcs_plain") as plain_lcs:
        folded, res, la, first_f = run_main_path(torch, Matcher, cfg, truth, queries, actual, model,
                                                 counters, ("A", "B", "F", "G"), "folded",
                                                 untimed=slab)
    if plain_lcs.calls:
        raise AssertionError(f"the folded main path called lcs_plain {len(plain_lcs.calls)} times")
    if folded.scorer.folded is None or any(la[k] for k in ("C", "D", "E", "A gathering")):
        raise AssertionError(f"the 500k default config left the folded path: {la}")
    t = time.time()
    largest = max(slab.calls, key=lambda call: call[0][0].numel())[0]
    kb["slab"] = check_kernel_b_on(torch, fk, largest, "on the folded predict's largest slab")
    del slab, largest
    phase("kernel_b_slab", t)
    t = time.time()
    serve, probes = {}, {}
    serve["folded"], probes["folded"] = serve_fused_path(torch, jk, fk, folded, queries, counters, smi,
                                                         "folded 500k")
    phase("serve_fused_folded", t)

    # ---- the folded path once more, with the model trained above ----
    t = time.time()
    acc_asset = float((res.match_title_id == actual).mean())
    folded.set_model(own_model)
    res_own = folded.predict(queries)
    torch.cuda.synchronize()
    acc_own = check_prediction(res_own, actual, len(queries))
    train["accuracy"], train["accuracy_committed_model"] = acc_own, acc_asset
    print(f"# train: folded predict with the model trained here: accuracy {acc_own:.4f} (floor "
          f"{ACCURACY_FLOOR}); the committed model's {acc_asset:.4f} is {acc_asset - acc_own:+.4f} "
          f"away (not gated: other pair draws move it further); stage_counts "
          f"{json.dumps(res_own.stage_counts)}", flush=True)
    phase("train_predict", t)

    # ---- exact main path: 150k titles ----
    t = time.time()
    cfg_x, truth_x, queries_x, actual_x = make_synthetic_world(N_TITLES_EXACT, N_QUERIES, seed=SEED,
                                                               config=cfg0)
    phase("exact_world", t)

    # ---- construction: the host and the device index build in turns ----
    t = time.time()
    construction = {label: construction_path(torch, Matcher, model, world, label, smi)
                    for label, world in (("folded 500k", (cfg, truth, queries)),
                                         ("exact 150k", (cfg_x, truth_x, queries_x)))}
    print(f"# construction seconds and peak GB by build, in turns: {json.dumps(construction)}",
          flush=True)
    torch.cuda.empty_cache()
    phase("construction", t)
    exact, res_x, lx, first_x = run_main_path(torch, Matcher, cfg_x, truth_x, queries_x, actual_x,
                                              model, counters, ("A", "B", "F"), "exact")
    if (exact.scorer.exact is None or lx["C"] or lx["D"] or lx["E"] or lx["G"]
            or lx["A gathering"] != lx["A"]):
        raise AssertionError(f"the 150k default config did not take exact retrieval with A "
                             f"gathering in every launch and no launch of C or G: {lx}")
    unions = dict(sorted(exact.scorer.exact.union_sizes.items()))
    print(f"# exact union buckets in the timed predict (U: blocks): {json.dumps(unions)}", flush=True)
    t = time.time()
    serve["exact"], probes["exact"] = serve_fused_path(torch, jk, fk, exact, queries_x, counters, smi,
                                                       "exact 150k")
    # the profiler's first session sets up CUPTI, and every launch-bound
    # predict after it runs slower: no profiler runs before the exact main
    # path's timed predict
    for name, (fs, probe) in probes.items():
        profile_replay(torch, fs, probe, name, serve[name])
    del probes, fs
    phase("serve_fused_exact", t)
    t = time.time()
    profile_predict(torch, exact, queries_x, "exact", ("A", "score_window_kernel"))
    phase("exact_profile", t)
    t = time.time()
    single = single_graphs_path(torch, jk, fk, counters, smi, model, {
        "folded 500k": (folded, queries, actual, first_f),
        "exact 150k": (exact, queries_x, actual_x, first_x)})
    phase("single_graphs", t)
    build_150k = packed_build_seconds(exact)
    # the single card's references for the mesh phase
    exact_topk, exact_tb = exact.scorer.topk(queries_x), exact.scorer.exact.tb
    del exact
    torch.cuda.empty_cache()

    # ---- oracle anchor: the exact config on the 500k world's sample ----
    t = time.time()
    idx = np.arange(0, N_QUERIES, max(N_QUERIES // ORACLE_QUERIES, 1))[:ORACLE_QUERIES]
    sample = TitleSet.from_titles([queries.titles[i] for i in idx], ids=queries.ids[idx], config=cfg)
    cfg_o = cfg.with_(score_dtype="float32", topk_recall_target=1.0, model_depth_initial=0,
                      retrieval_window_select=False, retrieval_mode="exact")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    oracle = Matcher(cfg_o, truth, model, device="cuda")
    torch.cuda.synchronize()
    reset_counts(counters)
    r_o = oracle.predict(sample)
    torch.cuda.synchronize()
    lo = read_counts(counters)
    oracle_s = time.time() - t
    acc_oracle = float((r_o.match_title_id == actual[idx]).mean())
    acc_fast = float((res.match_title_id[idx] == actual[idx]).mean())
    print(f"# oracle anchor: exact-config {acc_oracle:.4f} vs fast (folded) {acc_fast:.4f} on "
          f"{len(idx)} sampled queries ({oracle_s:.3f} s, Matcher init included); stage_seconds "
          f"{json.dumps({k: round(v, 4) for k, v in r_o.stage_seconds.items()})}", flush=True)
    print(f"# oracle launches: {json.dumps(lo)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, of which {resident / 1e9:.3f} GB "
          f"(the folded Matcher) were resident before", flush=True)
    unions_o = dict(sorted(oracle.scorer.exact.union_sizes.items()))
    print(f"# oracle union buckets (U: blocks): {json.dumps(unions_o)}", flush=True)
    if lo["D"] == 0 or lo["C"] or lo["A"] or lo["E"]:
        raise AssertionError(f"the oracle config did not run D alone (no C, no A): {lo}")
    if acc_fast < acc_oracle - ORACLE_DELTA:
        raise AssertionError(f"fast accuracy {acc_fast:.4f} < oracle {acc_oracle:.4f} - {ORACLE_DELTA}")
    # the oracle's top-100 and predict through its graphs (the predict above
    # was its first run, op by op; these capture them) against op by op
    w_o, topk_o = oracle.scorer.workers, {}
    for graphs in (False, True):
        w_o.use_graphs = graphs
        topk_o[graphs] = oracle.scorer.topk(sample)
    w_o.use_graphs = False
    r_e = oracle.predict(sample)
    w_o.use_graphs = True
    r_g = oracle.predict(sample)
    same_o = (bits_equal(topk_o[True][0], topk_o[False][0]) and bits_equal(topk_o[True][1], topk_o[False][1])
              and all(same_results(r, r_e, 0.0) and bits_equal(r.prediction, r_e.prediction)
                      for r in (r_o, r_g)))
    print(f"# oracle through its graphs (captured {json.dumps({k: v[0] for k, v in w_o.captures.items()})}) "
          f"against op by op: top-{cfg_o.top_n_predicting} and predictions equal bit for bit: {same_o}", flush=True)
    if not same_o:
        raise AssertionError("the oracle's graphs differ from its op-by-op run")
    profile_predict(torch, oracle, sample, "oracle", ("D", "score_full_kernel"))
    build_500k = packed_build_seconds(oracle)
    phase("oracle", t)

    # ---- v1 path: the sample's retrieval through kernel E ----
    t = time.time()
    k = cfg.top_n_predicting
    engine = oracle.scorer.exact
    t_plan = time.time()
    plans = plan_query_blocks(sample, oracle.index, cfg_o)
    print(f"# v1 path: the host planner took {time.time() - t_plan:.3f} s for the {len(idx)}-query "
          f"sample (the oracle's retrieval stage plans the rows the exact stage left)", flush=True)
    reset_counts(counters)
    v1 = []
    for p in plans:
        uid, w_pos, w_val, bound = (torch.from_numpy(a).to("cuda") for a in
                                    (p.union_ids, p.w_pos, p.w_val, p.max_intersection))
        v1.append(jk.jaccard_topk_v1(engine.packed, engine.sums, uid, w_pos, w_val, bound,
                                     engine.nt, k=k, tb=engine.tb, score_dtype=cfg_o.score_dtype))
    torch.cuda.synchronize()
    lv = read_counts(counters)
    v2 = [engine.topk_block(p, k) for p in plans]
    n_sep = n_bad = 0
    for (va, pa), (vb, pb), p in zip(v1, v2, plans):
        va, pa, vb, pb = (x[: p.n_valid] for x in (va, pa, vb, pb))
        # the v1 entry takes the planner's bound (summed in float64), the
        # main path the device's float32 sum: scores agree to rounding
        torch.testing.assert_close(va, vb, rtol=1e-5, atol=1e-7)
        sep = jk.untied_slots(vb, 1e-6)
        n_sep += int(sep.sum())
        n_bad += int((pa[sep] != pb[sep]).sum())
    print(f"# v1 path: {len(plans)} blocks; top-{k} titles equal to kernel D's on "
          f"{n_sep - n_bad}/{n_sep} untied slots; launches {json.dumps(lv)}", flush=True)
    if n_bad or lv["E"] != len(plans) or lv["C"] or lv["D"]:
        raise AssertionError(f"the v1 path disagrees with kernel D, or did not launch E once per "
                             f"block without C and D: {lv}")
    ke["oracle_blocks"] = oracle_blocks_through_e(torch, jk, engine, plans, k, cfg_o.score_dtype)
    phase("v1_path", t)
    del engine, v1, v2

    # ---- the title-sharded mesh: two shards of the card ----
    t = time.time()
    refs = {"exact_world": (cfg_x, truth_x, queries_x, actual_x), "exact_res": res_x,
            "exact_topk": exact_topk, "exact_tb": exact_tb,
            "folded_world": (cfg, truth, queries, actual), "folded_accuracy": acc_asset,
            "folded_topk": folded.scorer.topk(queries)[0], "folded_matcher": folded,
            "oracle_sample": sample, "oracle_cfg": cfg_o, "oracle_topk": topk_o[True],
            "train_model": own_model}
    del oracle, folded
    torch.cuda.empty_cache()
    mesh_stats, lm = mesh_path(torch, counters, smi, model, refs)
    del refs
    phase("mesh", t)

    # ---- the command-line verbs at the example set's size ----
    t = time.time()
    cli_stats = run_cli_path(torch, counters, smi)
    phase("cli", t)
    cli_a = {verb: n["A"] for verb, n in cli_stats["launches"].items()}
    cli_b = {verb: n["B"] for verb, n in cli_stats["launches"].items()}

    def plus(counts):
        """A path's launches and the mesh phase's."""
        return {k: counts[k] + lm[k] for k in counts}

    def entry(name, key, source, replaces, path, counts, stats, **extra):
        return {"name": name, "route": "cuda", "source": f"doppelspeller_tpu_torch/csrc/{source}",
                "replaces": f"doppelspeller_tpu/ops/{replaces}", "launches": counts[key],
                "path": path, **{k: stats[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                       "bound_by", "library_ms")}, **extra}

    kernels = [
        entry("score_window_select", "A", "score_window.cu", "jaccard_pallas.py:263",
              "folded main path (500k), bf16 weights, and the mesh phase (launches: both); exact "
              f"main path (150k) launched it {lx['A']} times, {lx['A gathering']} of them "
              "gathering: there its loads carry kernel C's function (jaccard_pallas.py:29); the "
              f"training path launched it {train['launches']['A']} times, every one gathering",
              plus(la), ka, hgmma=hgmma["A"],
              launches_by_path={"folded": la["A"], "exact": lx["A"], "train": train["launches"]["A"],
                                "cli": cli_a, "serve_fused": {k: v["launches"]["A"] for k, v in serve.items()},
                                "mesh": {k: v["launches"]["A"] for k, v in mesh_stats.items()
                                         if isinstance(v, dict) and "launches" in v}},
              **{k: ka[k] for k in ("tflops", "share_of_bound", "shapes")}),
        entry("window_best", "B", "window_lcs.cu", "features_pallas.py:53",
              f"folded main path (500k) and the mesh phase (launches: both); exact main path (150k) "
              f"launched it {lx['B']} times, the training path {train['launches']['B']} times",
              plus(la), kb,
              launches_by_path={"folded": la["B"], "exact": lx["B"], "train": train["launches"]["B"],
                                "cli": cli_b, "serve_fused": {k: v["launches"]["B"] for k, v in serve.items()},
                                "mesh": {k: v["launches"]["B"] for k, v in mesh_stats.items()
                                         if isinstance(v, dict) and "launches" in v}},
              **{k: kb[k] for k in kb if k.endswith(("_wl16", "_wl32")) or k == "slab"}),
        entry("lcs", "F", "lcs_pairs.cu", "levenshtein.py::lcs_kernel (an XLA scan, no Pallas kernel)",
              f"folded main path (500k) and the mesh phase (launches: both); exact main path (150k) "
              f"launched it {lx['F']} times", plus(la), kf,
              launches_by_path={"folded": la["F"], "exact": lx["F"]}, shapes=kf["shapes"]),
        entry("select_rescore", "G", "fold_rescore.cu",
              "fold.py's select and _rescore_exact (XLA, no Pallas kernel)",
              f"folded main path (500k) and the mesh phase (launches: both), one a block; exact "
              f"main path (150k) launched it {lx['G']} times", plus(la), kg,
              launches_by_path={"folded": la["G"], "exact": lx["G"]},
              share_of_bound=kg["share_of_bound"]),
        # C's function runs inside A's loads (exact main path) and D's (oracle
        # anchor) since the gather was fused; its own kernel, timed here
        # beside index_select, is launched by no path of Matcher.predict, and
        # ``launches`` says so
        entry("gather_rows", "C", "gather_rows.cu", "jaccard_pallas.py:29",
              f"no path of Matcher.predict: gather_rows.cu's own kernel was launched {lx['C']} "
              f"times by the exact main path (150k) and {lo['C']} by the oracle anchor; its "
              "function runs fused into kernel A's loads (exact main path, training path) and "
              "kernel D's (oracle anchor), counted under gathering_launches; launches: the exact "
              "main path's and the mesh phase's",
              plus(lx), kc,
              fused_into=["doppelspeller_tpu_torch/csrc/score_window.cu",
                          "doppelspeller_tpu_torch/csrc/score_full.cu"],
              gathering_launches={"exact main path (A)": lx["A gathering"],
                                  "training path (A)": train["launches"]["A gathering"],
                                  "oracle anchor (D)": lo["D"]}),
        entry("score_full", "D", "score_full.cu", "jaccard_pallas.py:210",
              "oracle anchor (500k, 6,000 queries), f32, and the mesh phase's oracle sample "
              "(launches: both, "
              f"{lm['D']} of them the mesh's); every launch gathers: its loads carry "
              "kernel C's function (jaccard_pallas.py:29)", plus(lo), kd, hgmma=hgmma["D"],
              **{k: kd[k] for k in ("ms_bf16", "plain_ms_bf16", "bound_ms_bf16", "bound_by_bf16",
                                    "select_ms", "select_ms_bf16")}),
        entry("jaccard_topk_v1", "E", "score_sparse_topk.cu", "jaccard_pallas.py:135",
              "v1 path (the oracle sample's retrieval); launches: it and the mesh phase",
              plus(lv), ke, **{k: ke[k] for k in ("ms_bf16", "dense_route_ms", "peak_bytes",
                                                  "oracle_blocks")}),
    ]
    print(f"# packed index build: {build_150k:.3f} s at {N_TITLES_EXACT} titles, "
          f"{build_500k:.3f} s at {N_TITLES} titles", flush=True)
    print(f"# train {json.dumps(train)}", flush=True)
    print(f"# cli {json.dumps(cli_stats)}", flush=True)
    print(f"# serve_fused {json.dumps(serve)}", flush=True)
    print(f"# mesh {json.dumps(mesh_stats)}", flush=True)
    print(f"# single_graphs {json.dumps(single)}", flush=True)
    phase("total", t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
