"""Retrieval's share of its roofline: the least time the card needs for the
scoring work these queries need (``benchmark/roofline.py``), over the
retrieval stage's measured seconds, summed over the traced window's
predicts."""


def read(run):
    r = run.roofline
    if not r or r["retrieval_s"] <= 0 or r["least_s"] <= 0:
        return None
    return 100.0 * r["least_s"] / r["retrieval_s"]
