"""Seconds of the run's first predict, or of its first request that reaches the
card (op by op until a graph key is due), by the benchmark's clock."""


def read(run):
    return run.first_predict_s or None
