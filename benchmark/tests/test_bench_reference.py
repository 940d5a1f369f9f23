"""The plain reference against the program's CPU path, at tiny sizes: on
every compared layer (the exact stage, retrieval's top-k and scores, the
fuzzy and model decisions, the probabilities) both retrieval engines and
single titles agree."""

import itertools
import random

import numpy as np
import pytest
import torch

from benchmark.drive import run_cell
from benchmark.reference.cascade import lcs_strings
from benchmark.tests.helpers import TINY, one_thread, tiny_catalog, unhooked

EXACT = {"decision_mismatch": 0.0, "retrieval_mismatch": 0.0, "retrieval_score_gap": 1e-6,
         "probability_gap": 1e-6}


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    one_thread()
    return tiny_catalog(str(tmp_path_factory.mktemp("tiny")), limits=EXACT)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_reference_equals_the_program_on_the_cpu(catalog, cell):
    out = run_cell(cell, 2**31 + 5, 1.0, False, device="cpu", catalog=catalog, log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["checks"]["decision_mismatch"]["value"] == 0.0
    assert out["checks"]["retrieval_mismatch"]["value"] == 0.0
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", ["tiny-exact.batch", "tiny-folded.batch", "tiny-exact.serve"])
def test_without_the_hooks_decisions_are_judged_on_the_references_own_top_k(catalog, cell):
    lines = []
    out = run_cell(cell, 2**31 + 6, 1.0, False, device="cpu", catalog=catalog, log=lines.append,
                   tamper=unhooked)
    assert out["correct"], out["checks"]
    assert "retrieval_mismatch" not in out["checks"]
    assert any("no candidates were copied out" in s for s in lines), lines
    assert any("own top-k decides as the program did on 1.0000" in s for s in lines), lines


def _lcs_python(a: str, b: str) -> int:
    prev = [0] * (len(b) + 1)
    for ch in a:
        cur = [0]
        for j, cb in enumerate(b):
            cur.append(max(prev[j + 1], cur[j], prev[j] + (ch == cb)))
        prev = cur
    return prev[-1]


def test_lcs_is_the_textbook_dynamic_programme():
    rng = random.Random(3)
    words = ["".join(rng.choice("ab c1") for _ in range(rng.randint(0, 12))) for _ in range(60)]
    pairs = list(itertools.islice(itertools.product(words, words), 400))
    got = lcs_strings([a for a, _ in pairs], [b for _, b in pairs], torch.device("cpu"))
    assert np.array_equal(got, [_lcs_python(a, b) for a, b in pairs])
