"""The device a matcher runs on.

The entry points (``Matcher``, ``JaccardScorer`` and the engines they build)
run on the card, ``"cuda"``, unless the caller names the CPU.  There is no
automatic choice and no fallback: asking for CUDA where there is none
raises.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    if device is None:
        raise ValueError("pass device explicitly, e.g. device='cuda' or device='cpu'")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (so host timings cover it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``, on the current stream, without a host sync: on a
    card through pinned memory (a copy from pageable memory waits for the
    stream); on the CPU the array itself."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
