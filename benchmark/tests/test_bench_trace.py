"""The trace reader on a made-up profile: kernel names, each device event
given to the span that launched it (a ctypes launch, with no host op, to
the span of the device event before it), busy time and idle stretches."""

from types import SimpleNamespace

import pytest

from torch.autograd import DeviceType

from benchmark.harness.trace import Trace, busy_seconds, kernel_name


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, link=0, annotation=False):
        self._v = (name, dev, start, dur, corr, link, annotation)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def is_user_annotation(self): return self._v[6]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
EVENTS = [
    Ev("env.step", CPU, 0, 100, corr=1, annotation=True),
    Ev("aten::cat", CPU, 10, 5, corr=2),
    Ev("obs", CPU, 120, 50, corr=3, annotation=True),
    Ev("aten::mul", CPU, 130, 5, corr=4),
    Ev("void at::native::vectorized_elementwise_kernel<4, float>(int, float*)", CUDA,
       200, 10, link=2),
    Ev("(anonymous namespace)::near_pass_kernel<false, false>(float const*)", CUDA,
       215, 30, link=999),                      # launched through ctypes: no host op
    Ev("env.step", CUDA, 200, 45, annotation=True),   # the device side of a span
    Ev("void at::native::reduce_kernel<512, 1>(float*)", CUDA, 260, 20, link=4),
]


def test_kernel_names():
    assert kernel_name(EVENTS[5].name()) == "near_pass_kernel"
    assert kernel_name(EVENTS[4].name()) == "at::native::vectorized_elementwise_kernel"


def test_spans_busy_and_gaps():
    tr = Trace(_prof(EVENTS), 1e-6, ("env.step", "obs"), {"env.step": 1, "obs": 1})
    assert [e[3] for e in tr.events] == ["env.step", "env.step", "obs"]
    assert tr.device_s("env.step") == pytest.approx(40e-9) and tr.count("env.step") == 2
    assert tr.device_s("env.step", {"near_pass_kernel"}) == pytest.approx(30e-9)
    assert tr.count("obs") == 1 and tr.device_s("obs") == pytest.approx(20e-9)
    assert dict(tr.idle_gaps) == {"env.step": 5, "obs": 15}
    name, seconds = tr.breakdown()["device_ops"][0]
    assert name == "near_pass_kernel" and seconds == pytest.approx(30e-9)
    assert busy_seconds(_prof(EVENTS)) == pytest.approx(60e-9)
