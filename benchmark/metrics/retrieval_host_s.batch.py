"""Mean seconds per traced predict that the host spends in the retrieval
stage on its own work: the program's ``doppel.retrieval`` span less its
``.wait`` spans and its graph launches (``doppel.replay``).  It is read
under the profiler, whose own per-operation recording on the host lies
inside it too."""

from benchmark.spans import stage_host_s


def read(run):
    return stage_host_s(run, "retrieval")
