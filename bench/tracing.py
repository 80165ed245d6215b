"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's busy intervals, the benchmark's own ranges
(``bench.<span>``, ``bench.request``), and the breakdown of the result's
line.  All times are microseconds on the profiler's clock.
"""
from __future__ import annotations

import collections

import numpy as np

PREFIX = "bench."
NAME_CHARS = 160


def short(name: str) -> str:
    """A device operation's name without ``void `` and cut to 160
    characters (templated kernel names run to thousands)."""
    return name.removeprefix("void ")[:NAME_CHARS]


def merge(intervals) -> tuple:
    """The union of (start, end) intervals as sorted disjoint arrays."""
    if not intervals:
        return np.zeros(0), np.zeros(0)
    iv = np.asarray(sorted(intervals), dtype=np.float64)
    starts, ends = [iv[0, 0]], [iv[0, 1]]
    for s, e in iv[1:]:
        if s > ends[-1]:
            starts.append(s)
            ends.append(e)
        elif e > ends[-1]:
            ends[-1] = e
    return np.asarray(starts), np.asarray(ends)


def busy(merged: tuple, t0: float, t1: float) -> float:
    """Microseconds of [t0, t1] that the merged intervals cover."""
    starts, ends = merged
    return float(np.clip(np.minimum(ends, t1) - np.maximum(starts, t0),
                         0, None).sum())


def gaps(merged: tuple, t0: float, t1: float) -> list:
    """The idle (start, end) intervals of [t0, t1]."""
    starts, ends = merged
    inside = (ends > t0) & (starts < t1)
    s, e = np.maximum(starts[inside], t0), np.minimum(ends[inside], t1)
    edges = np.concatenate([[t0], e]), np.concatenate([s, [t1]])
    return [(a, b) for a, b in zip(*edges, strict=True) if b > a]


class Trace:
    """A profiled stretch of requests: ``device`` the device operations
    (start, end, name), ``ranges`` name -> [(start, end)] of the
    benchmark's ranges on the host (the profiler also draws each on the
    device's track: those are no device operations), and the host's
    ``aten::`` operations by start."""

    def __init__(self, events):
        from torch.autograd import DeviceType
        self.device, self.ranges, host = [], collections.defaultdict(list), []
        for e in events:
            t0, t1 = e.time_range.start, e.time_range.end
            if e.name.startswith(PREFIX):     # also on the device's track
                if e.device_type != DeviceType.CUDA:
                    self.ranges[e.name[len(PREFIX):]].append((t0, t1))
            elif e.device_type == DeviceType.CUDA:
                self.device.append((t0, t1, e.name))
            elif e.name.startswith("aten::"):
                host.append((t0, e.name))
        host.sort()
        self.host_starts = np.asarray([t for t, _ in host])
        self.host_names = [n for _, n in host]
        self.merged = merge([(a, b) for a, b, _ in self.device])

    def busy_in(self, name: str) -> float:
        """Device-busy microseconds inside the ranges ``bench.<name>``."""
        return sum(busy(self.merged, a, b) for a, b in self.ranges[name])

    def length(self, name: str) -> float:
        return sum(b - a for a, b in self.ranges[name])

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        total = collections.Counter()
        for t0, t1, name in self.device:
            total[short(name)] += (t1 - t0) / 1e6
        return [[n, s] for n, s in total.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host operation, seconds]]: the device's idle time inside the
        profiled requests, by the ``aten::`` operation the host had started
        last when each gap ended."""
        total = collections.Counter()
        for a, b in self.ranges["request"]:
            for g0, g1 in gaps(self.merged, a, b):
                i = int(np.searchsorted(self.host_starts, g1, "right")) - 1
                name = self.host_names[i] if i >= 0 else "(none)"
                total[name] += (g1 - g0) / 1e6
        return [[n, s] for n, s in total.most_common(top)]
