"""Mean seconds per predict of the model stage (the program's
``stage_seconds["model"]``)."""

import numpy as np


def read(run):
    vals = [p["stages"]["model"] for p in run.predicts if p.get("stages")]
    return float(np.mean(vals)) if run.kind == "batch" and vals else None
