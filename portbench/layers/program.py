"""What the readers of the program's own recording share: the spans and
counters ``montreal_forced_aligner_tpu_torch.tracing`` kept while the
traced window's profiler collected. The recording is the whole
process's: it holds the window alone only while nothing else (set-up,
the pauses, the check) runs under a profiler or ``tracing.collect()``. A
reader returns None where the program has no such recording, as before
the program had the module, or where it holds nothing of the named spans
or counters."""

from __future__ import annotations


def recording() -> dict | None:
    """The program's recording: spans, counters and self times."""
    try:
        from montreal_forced_aligner_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.recorded()


def span_ns(names, self_time: bool = False) -> int | None:
    """The summed ns of the closed spans of the named kinds (their self
    time with ``self_time``); None where none was recorded."""
    rec = recording()
    if rec is None:
        return None
    if self_time:
        got = [rec["self_ns"][n] for n in names if n in rec["self_ns"]]
    else:
        got = [s.t1_ns - s.t0_ns for s in rec["spans"]
               if s.name in names and s.t1_ns is not None]
    return sum(got) if got else None


def counter(name: str) -> int | None:
    rec = recording()
    return None if rec is None else rec["counters"].get(name) or None


def ms_per_audio_min(trace: dict, names) -> float | None:
    """The named spans' summed time in ms a minute of audio."""
    ns = span_ns(names)
    if ns is None or not trace.get("audio_s"):
        return None
    return ns / 1e6 / (trace["audio_s"] / 60.0)


def ms_per_count(names, count: str, self_time: bool = False) -> float | None:
    """The named spans' summed time in ms per unit of the counter."""
    ns, n = span_ns(names, self_time), counter(count)
    if ns is None or not n:
        return None
    return ns / 1e6 / n
