"""Milliseconds per traced request that the host spends planning a
one-dispatch request and staging it into the pinned input buffer: the
program's ``doppel.fused.plan`` spans less every ``.wait`` span and graph
launch under them, over the traced requests (the part of ``host_ms.serve``
that the exact or the folded plan takes)."""

from benchmark.spans import children, host_seconds, program_spans


def read(run):
    if run.kind != "serve" or not run.trace_units:
        return None
    spans = program_spans(run)
    kids = children(spans)
    plans = [s for s in spans if s.name == "doppel.fused.plan"]
    if not plans:
        return None
    return 1e3 * sum(host_seconds(s, kids) for s in plans) / run.trace_units
