"""Construction seconds of the matcher (``Matcher.init_seconds``, summed:
load, index, retrieval engine, rest)."""


def read(run):
    if not run.init_seconds:
        return None
    return sum(run.init_seconds.values())
