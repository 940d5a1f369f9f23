"""Mean seconds per predict of the host text transform
(``TitleSet.from_titles``), by the benchmark's span."""

import numpy as np


def read(run):
    vals = [p["encode_s"] for p in run.predicts if p.get("stages")]
    return float(np.mean(vals)) if run.kind == "batch" and vals else None
