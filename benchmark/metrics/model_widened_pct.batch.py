"""Share of the rows that the model stage's wave A scores which wave B
widens to the tail candidates, over the traced predicts: 100 × the rows of
the ``doppel.model.wave`` spans of wave b over those of wave a."""

from benchmark.spans import program_spans


def read(run):
    if run.kind != "batch":
        return None
    rows = {"a": 0, "b": 0}
    for s in program_spans(run):
        if s.name == "doppel.model.wave":
            rows[s.counts["wave"]] += s.counts["rows"]
    return 100.0 * rows["b"] / rows["a"] if rows["a"] else None
