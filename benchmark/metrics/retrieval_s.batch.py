"""Mean seconds per predict of the retrieval stage (the program's
``stage_seconds["retrieval"]``)."""

import numpy as np


def read(run):
    vals = [p["stages"]["retrieval"] for p in run.predicts if p.get("stages")]
    return float(np.mean(vals)) if run.kind == "batch" and vals else None
