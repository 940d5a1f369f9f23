"""The trace reader on a made-up session: busy time is the union of device
intervals inside the benchmark's spans, launches are counted there, and
idle gaps are named by the innermost span of the benchmark."""

import pytest

from benchmark.trace import read_events


class Ev:
    def __init__(self, name, start, dur, device="DeviceType.CPU"):
        self._n, self._s, self._d, self._t = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t

    def is_user_annotation(self):
        return self._n.startswith("bench.") and self._t.endswith("CUDA")


def test_busy_idle_launches_and_gaps():
    ms = 1_000_000
    events = [
        Ev("bench.encode", 0, 10 * ms), Ev("bench.predict", 10 * ms, 90 * ms),
        Ev("cudaLaunchKernel", 11 * ms, 1000), Ev("cudaGraphLaunch", 12 * ms, 1000),
        Ev("cudaLaunchKernel", 200 * ms, 1000),                         # outside the window
        Ev("kernel_a", 20 * ms, 30 * ms, "DeviceType.CUDA"),
        Ev("kernel_b", 40 * ms, 20 * ms, "DeviceType.CUDA"),            # overlaps kernel_a
        Ev("kernel_b", 95 * ms, 10 * ms, "DeviceType.CUDA"),            # past the window's end
        Ev("bench.predict", 20 * ms, 85 * ms, "DeviceType.CUDA"),       # the span's device copy
    ]
    r = read_events(events)
    assert r.window_s == pytest.approx(0.1)
    assert r.busy_s == pytest.approx(0.045)
    assert r.launches == 2
    assert r.device_ops[0] == ("kernel_a", pytest.approx(0.03))
    assert r.idle_gaps[0] == ("bench.predict", pytest.approx(0.035))
    assert r.idle_gaps[1] == ("bench.encode", pytest.approx(0.02))
