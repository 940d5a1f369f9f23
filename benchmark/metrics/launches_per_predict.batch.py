"""Host launch calls (``cudaLaunchKernel`` and ``cudaGraphLaunch``) per
predict in the profiled slice."""


def read(run):
    if run.kind != "batch" or run.trace is None or not run.trace_units or not run.trace.launches:
        return None
    return run.trace.launches / run.trace_units
