"""Construction seconds of the matcher's host text pieces: the truth's word
split and its token-sorted encodings (``Matcher.init_seconds["words"]``
plus ``["token_sort"]``)."""


def read(run):
    parts = run.init_seconds
    if "words" not in parts or "token_sort" not in parts:
        return None
    return parts["words"] + parts["token_sort"]
