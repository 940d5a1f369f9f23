"""The comparison that decides ``correct``.

What the timed path produced for a sample of the window's queries is held
against the plain reference (``benchmark/reference``), which builds its own
index from the raw truth titles and takes nothing the program made:

- ``decision_mismatch``: the share of sampled queries whose final title id
  or stage differs from the reference's decision;
- ``retrieval_mismatch``: over the sampled queries that reached retrieval,
  the share of the k candidate slots where the program's list departs from
  the reference's top-k by the configuration's algorithm: a reference
  candidate missing from the program's list while it scores above the
  program's weakest candidate, or two neighbours of the program's list out
  of order; scores are the reference's, and a departure counts only past
  ``TOL``, so ties and rounding do not;
- ``retrieval_score_gap``: the largest gap between a score the program
  reported and the reference's score of the same title (only where the
  timed path reports scores);
- ``probability_gap``: the largest gap between the program's probability
  and the reference's for a query both decided in the model stage on the
  same title.

The reference decides the fuzzy and model stages on the program's own
candidates, which ``retrieval_mismatch`` judges on their own, so that a
near-tie at the edge of the top-k does not show as a wrong decision.  A
query whose candidates the harness could not copy out of the timed path
(its hook no longer on the path retrieval takes) is judged end to end
instead, on the reference's own top-k.  Beside the numbers, ``record``
holds how often the reference's own top-k decides as the program did, and
how many queries had no candidates: a record, not a gate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from benchmark.reference import cascade as C
from benchmark.reference import retrieval as R
from benchmark.reference.text import transform_title, trigram_lists

# a score departure smaller than this is rounding (scores lie in [0, 1])
TOL = 1e-5


@dataclass
class Answer:
    """One sampled query as the timed path answered it."""

    query: str                       # raw title
    batch: int                       # which batch of the run it came in
    single: bool
    title_id: int                    # -1 not found
    stage: int
    prediction: float
    cand: Optional[np.ndarray] = None    # truth rows retrieval ranked (k,)
    scores: Optional[np.ndarray] = None  # the scores reported with them


class Reference:
    """The reference over one world's truth titles."""

    def __init__(self, truth: Sequence[str], settings: Dict, model: Dict, device: str):
        self.truth = [transform_title(t) for t in truth]
        self.s = settings
        self.exact = C.exact_rows(self.truth)
        self.index = R.ReferenceIndex(self.truth, settings, device)
        self.cascade = C.Cascade(self.truth, settings, model, device)
        self.record: Dict[str, float] = {}

    def outputs(self, queries: Sequence[str], batches: Sequence[Sequence[str]],
                batch_of: Sequence[int], single: Sequence[bool], precision: Dict) -> List[Answer]:
        """The reference computed in ``precision`` put in the program's
        place: its own retrieval, then its own decisions (the control)."""
        k = int(self.s["top_n_predicting"])
        tq = [transform_title(q) for q in queries]
        waves = self._waves(batches, batch_of, single)
        out = [Answer(q, b, s, -1, C.STAGE_NONE, float("nan"))
               for q, b, s in zip(queries, batch_of, single)]
        past = [i for i, t in enumerate(tq) if t not in self.exact]
        for i, t in enumerate(tq):
            if t in self.exact:
                out[i].title_id, out[i].stage, out[i].prediction = self.exact[t] + 1, C.STAGE_EXACT, 1.0
        if past:
            vals, rows = self.index.topk(trigram_lists([tq[i] for i in past]), k,
                                         precision["coarse"], precision["rescore"])
            dec = self.cascade.decide([tq[i] for i in past], list(rows), [waves[i] for i in past],
                                      [single[i] for i in past], precision["features"])
            for j, i in enumerate(past):
                out[i].cand, out[i].scores = rows[j], vals[j]
                row, stage, p = dec[j]
                out[i].title_id, out[i].stage, out[i].prediction = row + 1 if row >= 0 else -1, stage, p
        return out

    def _waves(self, batches, batch_of, single) -> List[bool]:
        per_batch = [C.waves_for([transform_title(q) for q in b], self.exact, False,
                                 self.s["cascade_impl"]) for b in batches]
        return [False if s else per_batch[b] for b, s in zip(batch_of, single)]

    def _decide(self, rows, cands, tq, waves, answers, precision):
        """The reference's (title id, stage, probability) of ``rows`` of the
        answers, from the candidates ``cands`` (truth rows, ranked)."""
        dec = self.cascade.decide([tq[i] for i in rows], cands, [waves[i] for i in rows],
                                  [answers[i].single for i in rows], precision["features"])
        return [(r + 1 if r >= 0 else -1, stage, p) for r, stage, p in dec]

    def judge(self, answers: Sequence[Answer], batches: Sequence[Sequence[str]],
              precision: Dict) -> Dict[str, Optional[float]]:
        """The numbers compared, from the program's answers."""
        k = int(self.s["top_n_predicting"])
        tq = [transform_title(a.query) for a in answers]
        waves = self._waves(batches, [a.batch for a in answers], [a.single for a in answers])
        want = [(-1, C.STAGE_NONE, float("nan"))] * len(answers)
        for i, t in enumerate(tq):
            if t in self.exact:
                want[i] = (self.exact[t] + 1, C.STAGE_EXACT, 1.0)
        past = [i for i, t in enumerate(tq) if t not in self.exact]
        held = [j for j, i in enumerate(past) if answers[i].cand is not None]
        slots = departures = 0
        score_gap = None
        agree = 0
        if past:
            q_tri = trigram_lists([tq[i] for i in past])
            ref_vals, ref_rows = self.index.topk(q_tri, k, precision["coarse"], precision["rescore"])
            own = self._decide(past, list(ref_rows), tq, waves, answers, precision)
            for j, i in enumerate(past):
                agree += (answers[i].title_id, answers[i].stage) == own[j][:2]
                want[i] = own[j]
        if held:
            cand = np.stack([np.asarray(answers[past[j]].cand, dtype=np.int64) for j in held])
            mine = self.index.final_scores(q_tri[held], cand, precision["coarse"], precision["rescore"])
            for h, j in enumerate(held):
                departures += _departures(cand[h], mine[h], ref_rows[j], ref_vals[j])
                slots += k
                got = answers[past[j]].scores
                if got is not None:
                    gap = float(np.max(np.abs(np.asarray(got, np.float64) - mine[h])))
                    score_gap = gap if score_gap is None else max(score_gap, gap)
            rows = [past[j] for j in held]
            for i, d in zip(rows, self._decide(rows, list(cand), tq, waves, answers, precision)):
                want[i] = d
        self.record = {"own_topk_agree": agree / len(past) if past else float("nan"),
                       "past_exact": len(past), "without_candidates": len(past) - len(held)}
        wrong = 0
        prob_gap = None
        for a, (tid, stage, p) in zip(answers, want):
            if a.title_id != tid or a.stage != stage:
                wrong += 1
            elif stage == C.STAGE_MODEL:
                gap = abs(float(a.prediction) - p)
                prob_gap = gap if prob_gap is None else max(prob_gap, gap)
        return {
            "decision_mismatch": wrong / max(len(answers), 1),
            "retrieval_mismatch": departures / slots if slots else None,
            "retrieval_score_gap": score_gap,
            "probability_gap": prob_gap,
        }


def _departures(cand: np.ndarray, mine: np.ndarray, ref_rows: np.ndarray,
                ref_vals: np.ndarray) -> int:
    """Slots where the program's ranked list ``cand`` (reference scores
    ``mine``) departs from the reference's top-k (``ref_rows``, ``ref_vals``)
    by more than TOL: a reference candidate above the program's weakest that
    the program left out, or a neighbour pair out of order."""
    weakest = float(mine.min())
    held = set(int(c) for c in cand)
    missed = sum(1 for r, v in zip(ref_rows, ref_vals) if int(r) not in held and v > weakest + TOL)
    disorder = int(np.sum(mine[1:] > mine[:-1] + TOL))
    return missed + disorder


def verdict(numbers: Dict[str, Optional[float]], limits: Dict[str, float],
            failed: int) -> bool:
    """Correct: nothing failed, and every number read lies within its limit
    (a number with no reading in this run, such as the score gap on a path
    that reports no scores, is not compared)."""
    if failed:
        return False
    return all(v <= limits[name] for name, v in numbers.items() if v is not None)

