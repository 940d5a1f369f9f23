"""Milliseconds per request in which an operation ran on the card, in the
profiled slice."""


def read(run):
    t = run.trace
    if run.kind != "serve" or t is None or not run.trace_units or t.busy_s <= 0:
        return None
    return 1e3 * t.busy_s / run.trace_units
