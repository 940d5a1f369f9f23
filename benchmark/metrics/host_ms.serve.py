"""Milliseconds per traced request that the host spends in the program on
its own work: its ``doppel.encode`` (the title transform) plus its
``doppel.predict`` less every ``.wait`` span and graph launch
(``doppel.replay``) under it."""

from benchmark.spans import children, host_seconds, program_spans


def read(run):
    if run.kind != "serve" or not run.trace_units:
        return None
    spans = program_spans(run)
    kids = children(spans)
    roots = [s for s in spans if s.parent is None and s.name in ("doppel.encode", "doppel.predict")]
    if not any(s.name == "doppel.predict" for s in roots):
        return None
    return 1e3 * sum(host_seconds(s, kids) for s in roots) / run.trace_units
