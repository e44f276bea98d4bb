"""The trace reduction at a timeline worked out by hand."""

from __future__ import annotations

import math

from torch.autograd import DeviceType

from benchmark.harness.trace import WINDOW, reduce


class Event:
    def __init__(self, name, start, end, device=DeviceType.CPU, annotation=False):
        self._n, self._s, self._d, self._dev, self._a = name, start, end - start, device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._a


def test_busy_ops_and_gaps():
    gpu = DeviceType.CUDA
    events = [
        Event(WINDOW, 1000, 11000),
        Event(WINDOW, 1000, 11000, gpu, annotation=True),  # the range mirrored on the device
        Event("k1", 500, 3000, gpu),  # starts before the window: clipped
        Event("k2", 2000, 4000, gpu),  # overlaps k1
        Event("k1", 6000, 7000, gpu),
        Event("k3", 10500, 12000, gpu),  # ends after the window: clipped
        Event("aten::sort", 4200, 5900),  # the host during the 4000-6000 gap
    ]
    s = reduce(events, spans=[(0.0, 2e-6, "retrieval")], t_enter=0.0)  # 1000-3000 on the trace clock
    assert math.isclose(s.window_s, 10e-6)
    assert math.isclose(s.busy_s, (4000 - 1000 + 1000 + 500) * 1e-9)
    assert math.isclose(s.device_ops["k1"], (2000 + 1000) * 1e-9) and math.isclose(s.device_ops["k3"], 500e-9)
    # gaps 4000-6000 (host sorting, after the span) and 7000-10500 (nothing)
    assert math.isclose(s.idle_gaps["harness/aten::sort"], 2000e-9)
    assert math.isclose(s.idle_gaps["harness/host"], 3500e-9)
    assert math.isclose(s.busy_s + sum(s.idle_gaps.values()), s.window_s)
    assert [n for n, _ in s.breakdown()["device_ops"]] == ["k1", "k2", "k3"]
