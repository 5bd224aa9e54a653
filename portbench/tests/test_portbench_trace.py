"""The trace's reduction on a made-up trace: busy time is the union of the
device's intervals inside the window, spans' shadows on the device are not
device work, and each idle gap is named by what the host ran across it."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import trace


class Event:  # the methods of a kineto event that the reduction reads
    def __init__(self, name, device, start, end):
        self._e = (name, device, start, end)

    def name(self):
        return self._e[0]

    def device_type(self):
        return self._e[1]

    def start_ns(self):
        return self._e[2]

    def duration_ns(self):
        return self._e[3] - self._e[2]


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def test_busy_is_the_union_inside_the_window_and_gaps_are_named():
    events = [
        Event(trace.WINDOW_SPAN, CPU, 1000, 2000),
        Event("portbench.step", CPU, 1000, 1900),
        Event("aten::where", CPU, 1500, 1700),
        Event("portbench.step", GPU, 1000, 1900),  # the span's shadow
        Event("void edge_tile::kernel<1, false>(float)", GPU, 900, 1100),
        Event("void (anonymous namespace)::dense_gnn_kernel<2>()", GPU,
              1050, 1200),
        Event("Memcpy HtoD (Pinned -> Device)", GPU, 1800, 1850),
        Event("void edge_tile::kernel<1, false>(float)", GPU, 1950, 2100),
    ]
    t = trace.summarize(_prof(events))
    assert t.window_s == pytest.approx(1000e-9)
    # [1000, 1200] + [1800, 1850] + [1950, 2000], clipped to the window
    assert t.busy_s == pytest.approx(300e-9)
    assert t.idle_pct() == pytest.approx(70.0)
    assert t.kernels == 3  # the copy is no kernel
    assert t.kernel_s(r"\bedge_tile::kernel\b") == (pytest.approx(150e-9), 2)
    assert t.kernel_s(r"\bdense_gnn_kernel\b") == (pytest.approx(150e-9), 1)
    assert t.idle_gaps[0] == ["portbench.step > aten::where",
                              pytest.approx(600e-9)]
    assert [g[1] for g in t.idle_gaps] == pytest.approx([600e-9, 100e-9])
    assert t.device_ops[0][1] == pytest.approx(150e-9)


def test_a_window_without_device_work_reads_nothing():
    events = [Event(trace.WINDOW_SPAN, CPU, 0, 10),
              Event("k", GPU, 20, 30)]
    assert trace.summarize(_prof(events)) is None
