"""95th percentile latency of all the window's single-title requests, each
timed from when it was due (a failed request counts as infinitely late)."""

import numpy as np


def read(run):
    if run.kind != "serve" or not run.latencies_ms:
        return None
    return float(np.percentile(np.asarray(run.latencies_ms), 95))
