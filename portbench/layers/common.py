"""What the per-layer readers share. A reader returns None where the
traced run holds nothing for it, and the harness then leaves its metric
out of the line."""

from __future__ import annotations

from portbench.work.peaks import FP32_ACCURATE_FLOP_PER_S, bound_s


def ms_per_audio_min(trace: dict, phases) -> float | None:
    """The summed seconds of the named phases, in ms a minute of audio."""
    got = trace.get("phases", {})
    if not trace.get("audio_s") or not any(p in got for p in phases):
        return None
    return 1000.0 * sum(got.get(p, 0.0) for p in phases) / (trace["audio_s"] / 60.0)


def roofline_pct(trace: dict, kernel: str) -> float | None:
    """A kernel's least time by its work counts over its device time, %."""
    if not trace.get("on_device"):
        return None
    work = trace.get("work", {}).get(kernel)
    seconds = trace.get("kernel_s", {}).get(kernel)
    if not work or not seconds:
        return None
    return 100.0 * bound_s(work["flops"], work["bytes"]) / seconds


def idle_pct(trace: dict) -> float | None:
    if not trace.get("on_device") or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu_pct(trace: dict, kernels) -> float | None:
    """The counted operations of the step over the window and the peak, %."""
    work = trace.get("work", {})
    if (not trace.get("on_device") or not trace.get("window_s")
            or not any(k in work for k in kernels)):
        return None
    flops = sum(work[k]["flops"] for k in kernels if k in work)
    return 100.0 * flops / (trace["window_s"] * FP32_ACCURATE_FLOP_PER_S)


def timer_ms(trace: dict, timer: str, count: str) -> float | None:
    """A benchmark timer's seconds in ms per counted item."""
    seconds, n = trace.get("timers", {}).get(timer), trace.get("counts", {}).get(count)
    if not seconds or not n:
        return None
    return 1000.0 * seconds / n


def span_roofline_pct(trace: dict, work_key: str, span: str) -> float | None:
    """A layer's counted work's least time over the card's busy seconds
    inside the benchmark's host spans of that layer (each span opens and
    closes on a synchronised card, so its device work falls inside), %."""
    if not trace.get("on_device"):
        return None
    work = trace.get("work", {}).get(work_key)
    seconds = trace.get("span_busy_s", {}).get(span)
    if not work or not seconds:
        return None
    return 100.0 * bound_s(work["flops"], work["bytes"]) / seconds
