"""Mean seconds per predict of the fuzzy stage (the program's
``stage_seconds["fuzzy"]``)."""

import numpy as np


def read(run):
    vals = [p["stages"]["fuzzy"] for p in run.predicts if p.get("stages")]
    return float(np.mean(vals)) if run.kind == "batch" and vals else None
