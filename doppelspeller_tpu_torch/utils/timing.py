"""The command-line verbs' timing decorator.

Logs ``Elapsed time [verb]: Xh | Ym | Z.ZZs`` at INFO when the verb ends.
With ``DOPPEL_PROFILE_DIR`` set, the verb runs under ``torch.profiler``
(CPU and, where there is a card, CUDA activity) and a Chrome trace is
written into that directory.
"""

from __future__ import annotations

import functools
import logging
import os
import time

LOGGER = logging.getLogger(__name__)


def _profiled(profile_dir: str, name: str, call):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        result = call()
    trace = os.path.join(profile_dir, f"{name}.{os.getpid()}.{int(time.time())}.trace.json")
    prof.export_chrome_trace(trace)
    LOGGER.info("profiler trace written to %s", trace)
    return result


def time_usage(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        profile_dir = os.environ.get("DOPPEL_PROFILE_DIR")
        start = time.time()
        if profile_dir:
            result = _profiled(profile_dir, func.__name__, lambda: func(*args, **kwargs))
        else:
            result = func(*args, **kwargs)
        elapsed = time.time() - start
        hours, rem = divmod(elapsed, 3600)
        minutes, seconds = divmod(rem, 60)
        LOGGER.info(
            "Elapsed time [%s]: %dh | %dm | %.2fs",
            func.__name__, int(hours), int(minutes), seconds,
        )
        return result

    return wrapper
