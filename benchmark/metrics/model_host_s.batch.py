"""Mean seconds per traced predict that the host spends in the model stage
on its own work: the program's ``doppel.model`` span less its waves'
``.wait`` spans and graph launches (``doppel.replay``).

It holds the queries' spaceless encodings, which the program builds lazily
at their first use inside this stage (``doppel.encode.wo``, host text work,
most of this metric at 500k), until a later benchmark moves them to
``encode_s.batch``.  It is read under the profiler, whose own
per-operation recording on the host lies inside it too."""

from benchmark.spans import stage_host_s


def read(run):
    return stage_host_s(run, "model")
