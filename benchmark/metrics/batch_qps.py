"""Queries matched per second over the window: whole predicts (the text
transform, then ``Matcher.predict``) from the window's start to the end of
its last predict."""


def read(run):
    if run.kind != "batch" or run.seconds <= 0:
        return None
    return run.queries / run.seconds
