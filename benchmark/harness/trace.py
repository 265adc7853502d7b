"""The traced run: torch.profiler over whole chunks of the window, read in
memory (no Chrome trace is written).

Every device event (kernel, copy, set) is given to the benchmark span in
which the host launched it: the device event's linked correlation id names
the host op that launched it, and the span is the one whose interval holds
that op's start. A kernel launched through ctypes (the port's CUDA
kernels) has no host op in the trace; one stream runs its work in launch
order, so it goes to the span of the device event before it (each of the
port's kernels follows an op of its own layer: the island's pack, the
track pass's ``pack_cars``, ``view_inputs``). The spans are the rollout's own (``rollout.SPANS``), around
each call into a layer of the port. Busy time is the union of the device
events' intervals; an idle gap is a stretch between two of them, given to
the span that launched the event that ends it (what the host was doing
while the card waited).
"""

from __future__ import annotations

import bisect
import collections
import re


def kernel_name(name: str) -> str:
    """A device event's function name: without ``void``, anonymous
    namespaces, template and argument lists (``near_pass_kernel`` for
    ``(anonymous namespace)::near_pass_kernel<false, false>(float const*,
    ...)``)."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def function(name: str) -> str:
    """The last component of a kernel name, what the work counters list."""
    return name.rsplit("::", 1)[-1]


class Trace:
    """What the per-layer metrics read from one profiled stretch."""

    def __init__(self, prof, window_s: float, span_names, calls: dict):
        from torch.autograd import DeviceType

        spans, launch_at = [], {}
        device = []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            if ev.device_type() == DeviceType.CPU:
                if name in span_names and ev.is_user_annotation():
                    spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), name))
                launch_at[ev.correlation_id()] = ev.start_ns()
            elif ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation() \
                    and name not in span_names:
                device.append((ev.start_ns(), ev.duration_ns(), name,
                               ev.linked_correlation_id()))
        spans.sort()
        starts = [s[0] for s in spans]

        def span_of(t):                          # the benchmark's spans do not nest
            i = bisect.bisect_right(starts, t) - 1
            return spans[i][2] if i >= 0 and t <= spans[i][1] else "outside spans"

        self.window_s = window_s
        self.calls = dict(calls)                 # span -> calls in the traced stretch
        device.sort()
        self.events, prev = [], "outside spans"
        for t, dur, n, link in device:
            at = launch_at.get(link)
            span = prev if at is None else span_of(at)
            self.events.append((t, dur, kernel_name(n), span))
            prev = span
        self.idle_gaps = _busy_and_gaps((t, dur, span) for t, dur, _, span in self.events)[1]

    def device_s(self, span: str | None = None, kernels=None) -> float:
        """Device seconds of the events launched in ``span`` (any span when
        None) whose function is one of ``kernels`` (any when None)."""
        return 1e-9 * sum(dur for _, dur, k, s in self.events
                          if (span is None or s == span)
                          and (kernels is None or function(k) in kernels))

    def count(self, span: str | None = None, kernels=None) -> int:
        """Device events launched in ``span`` whose function is one of
        ``kernels`` (any when None)."""
        return sum(1 for _, _, k, s in self.events
                   if (span is None or s == span) and (kernels is None or function(k) in kernels))

    def breakdown(self) -> dict:
        """The ten device functions that took most time and the ten spans
        the idle stretches went to, in seconds. The host runs slower under
        the profiler's op recording, so the idle stretches here are longer
        than in a run without it; ``busy_seconds`` reads the idle share."""
        ops = collections.Counter()
        for _, dur, k, _ in self.events:
            ops[k] += dur * 1e-9
        return {"device_ops": [[k, v] for k, v in ops.most_common(10)],
                "idle_gaps": [[f"host in {k}", v * 1e-9]
                              for k, v in self.idle_gaps.most_common(10)]}


def _busy_and_gaps(events):
    """(busy ns, idle ns by span) of device events ``(start, duration,
    span)`` in start order: busy is the union of their intervals; an idle
    stretch goes to the span of the event that ends it."""
    busy, end, gaps = 0, None, collections.Counter()
    for t, dur, span in events:
        if end is not None and t > end:
            gaps[span] += t - end
        if end is None or t > end:
            busy, end = busy + dur, t + dur
        elif t + dur > end:
            busy, end = busy + (t + dur - end), t + dur
    return busy, gaps


def busy_seconds(prof) -> float:
    """The union of the device events' intervals of a profile taken with
    device activity alone (no host op recording, so the host runs at its
    own pace), in seconds."""
    from torch.autograd import DeviceType

    events = sorted((ev.start_ns(), ev.duration_ns(), None)
                    for ev in prof.profiler.kineto_results.events()
                    if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation())
    return _busy_and_gaps(events)[0] * 1e-9
