"""The comparison fails a broken timed path: the harness runs on the CPU at
tiny sizes, under each cell's own limits, with a fault planted under the
timed path, and ``correct`` comes out false."""

import numpy as np
import pytest

from benchmark.drive import run_cell
from benchmark.tests.helpers import one_thread, tiny_catalog, unhooked


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    one_thread()
    return tiny_catalog(str(tmp_path_factory.mktemp("faults")))


def altered_answer(matcher):
    """Every answer the model or fuzzy stage produces names the next title."""
    record = matcher._record

    def wrong(res, qi, pos, pred, stage):
        record(res, qi, (pos + 1) % len(matcher.truth), pred, stage)

    matcher._record = wrong


def half_left_out(matcher):
    """The second half of every batch (every other request) is left
    undecided, as if never processed."""
    predict = matcher.predict
    calls = {"n": 0}

    def half(queries, single=False):
        res = predict(queries, single=single)
        calls["n"] += 1
        rows = np.arange(len(queries))
        drop = rows >= len(queries) // 2 if not single else rows[: int(calls["n"] % 2 == 0)]
        res.match_title_id[drop] = -1
        res.stage[drop] = 0
        return res

    matcher.predict = half


def reversed_candidates(matcher):
    """Retrieval hands on its candidates worst first (the batched path's
    top-k, and the one-dispatch path's candidates)."""
    topk = matcher.scorer.topk_device
    fused = matcher._fused_engine()
    dispatch = fused.dispatch

    def flipped(queries, k=None, rows=None):
        vals, pos = topk(queries, k=k, rows=rows)
        return vals.flip(1), pos.flip(1)

    def flipped_fused(queries, rows, eager=False):
        rws, stats, cand, tlr = dispatch(queries, rows, eager)
        return rws, stats, cand[:, ::-1].copy(), tlr

    matcher.scorer.topk_device = flipped
    fused.dispatch = flipped_fused


def altered_answer_unhooked(matcher):
    """An altered answer where no candidates are copied out: the decisions
    are judged end to end."""
    unhooked(matcher)
    altered_answer(matcher)


FAULTS = {"altered_answer": altered_answer, "half_left_out": half_left_out,
          "reversed_candidates": reversed_candidates, "altered_answer_unhooked": altered_answer_unhooked}


@pytest.mark.parametrize("cell", ["tiny-exact.batch", "tiny-folded.batch", "tiny-exact.serve"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(catalog, cell, fault):
    out = run_cell(cell, 2**31 + 99, 1.0, False, device="cpu", catalog=catalog,
                   log=lambda s: None, tamper=FAULTS[fault])
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct(catalog):
    from benchmark.control import control_numbers

    for cell in ("tiny-exact.batch", "tiny-folded.batch", "tiny-exact.serve"):
        numbers = control_numbers(cell, 2**31 + 7, 1.0, "cpu", catalog)
        limits = catalog.limits(cell)
        assert any(v is not None and v > limits[k] for k, v in numbers.items()), (cell, numbers)
        stated = control_numbers(cell, 2**31 + 7, 1.0, "cpu", catalog, which="precision")
        assert all(v in (None, 0.0) for v in stated.values()), (cell, stated)
