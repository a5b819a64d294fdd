"""The traced run's device side: ``torch.profiler`` over the window, read
from its raw events (building the profiler's event tree took 44-92 s of
host time for one decode-heavy run on an H100 machine).

``summary`` gives the union of the card's busy intervals within the
window (less the pauses in which the benchmark wrote inputs), each port
kernel's device seconds (by its symbol), the card's busy seconds inside
each named host span, and the breakdown: the device operations that took
most time and the longest idle gaps, each named by the benchmark's host
span it fell in."""

from __future__ import annotations

import time
from typing import Dict, List

# the port's kernels, as the profiler names them
KERNEL_SYMBOLS = {
    "k1": "band_forward_kernel",
    "k2": "band_backtrace_kernel",
    "k3": "state_emission_kernel",
}
CLOCK_MARK = "portbench_clock_mark"
TOP = 10


def merge(spans):
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_and_gaps(spans, lo: int, hi: int):
    """(busy ns, idle gaps [(start, end)]) of device intervals clipped to
    [lo, hi)."""
    merged = [[max(s, lo), min(e, hi)] for s, e in merge(spans) if e > lo and s < hi]
    busy = sum(e - s for s, e in merged)
    gaps, cur = [], lo
    for s, e in merged:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def segments(lo: int, hi: int, pauses):
    """[lo, hi) less the (start, end) pauses, as sorted disjoint intervals."""
    out, cur = [], lo
    for s, e in merge(pauses):
        if e <= cur or s >= hi:
            continue
        if s > cur:
            out.append([cur, s])
        cur = max(cur, e)
    if hi > cur:
        out.append([cur, hi])
    return out


def overlap(a, b) -> int:
    """The summed length of the intersection of two lists of sorted
    disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def label_gaps(gaps, host_spans, top: int = TOP):
    """The ``top`` longest gaps as [name, seconds], each named by the
    innermost host span (name, t0, t1) around its midpoint."""
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) // 2
        inside = [sp for sp in host_spans if sp[1] <= mid < sp[2]]
        name = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else "outside the jobs"
        out.append([name, (e - s) / 1e9])
    return out


class Profile:
    def __init__(self, device):
        self.device = device
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark_ns = time.perf_counter_ns()
        with record_function(CLOCK_MARK):
            pass

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def summary(self, window: dict, host_spans: List[tuple]) -> Dict[str, object]:
        """busy_s, window_s, kernel_s, breakdown. Host spans are on the
        ``perf_counter_ns`` clock; the profiler's events are moved onto it
        by its own record of the clock mark."""
        import torch

        events = self.prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        offset = 0
        device_spans, by_name = [], {}
        kernel_ns = {k: 0 for k in KERNEL_SYMBOLS}
        for e in events:
            if e.device_type() == cuda:
                s, d = e.start_ns(), e.duration_ns()
                device_spans.append((s, s + d))
                name = e.name()
                by_name[name] = by_name.get(name, 0) + d
                for k, sym in KERNEL_SYMBOLS.items():
                    if sym in name:
                        kernel_ns[k] += d
            elif e.name() == CLOCK_MARK:
                offset = self.mark_ns - e.start_ns()
        lo = int(window["t0"] * 1e9) - offset
        hi = int(window["t1"] * 1e9) - offset
        timed = segments(lo, hi, [(a - offset, b - offset) for a, b in window.get("pauses", [])])
        device = merge(device_spans)
        busy, gaps = 0, []
        for a, b in timed:
            part, part_gaps = busy_and_gaps(device, a, b)
            busy += part
            gaps += part_gaps
        spans = [(n, a - offset, b - offset) for n, a, b in host_spans]
        span_ns = {}
        for name in {sp[0] for sp in spans}:
            span_ns[name] = overlap(device, merge([(a, b) for n, a, b in spans if n == name]))
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {
            "on_device": self.device.type == "cuda",
            "busy_s": busy / 1e9,
            "window_s": sum(b - a for a, b in timed) / 1e9,
            "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
            "span_busy_s": {k: v / 1e9 for k, v in span_ns.items()},
            "breakdown": {
                "device_ops": [[n[:120], ns / 1e9] for n, ns in ranked],
                "idle_gaps": label_gaps(gaps, spans),
            },
        }
