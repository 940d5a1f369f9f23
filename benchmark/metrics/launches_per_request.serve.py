"""Host launch calls (``cudaLaunchKernel`` and ``cudaGraphLaunch``) per
request in the profiled slice."""


def read(run):
    if run.kind != "serve" or run.trace is None or not run.trace_units or not run.trace.launches:
        return None
    return run.trace.launches / run.trace_units
