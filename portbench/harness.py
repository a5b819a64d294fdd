"""One run of one cell of ``BENCHMARK.json``: set-up, a closed loop of jobs
for the window, the result line.

Everything particular to a configuration, a traffic mix or a metric sits
in files found by name: ``configs/<config>.json`` (its ``kind`` names
``models/<kind>.py`` and ``reference/<kind>.py``), ``traffic/<mix>.json``
(its ``runner`` names ``runners/<runner>.py``), ``metrics/<name>.py`` for
an end-to-end metric, ``layers/<name>.py`` for a per-layer metric and
``limits/<cell>.json`` for the limits of the cell's correctness check."""

from __future__ import annotations

import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
# whole top-level module names that no run may have loaded
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "montreal_forced_aligner_tpu", "mfa_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path):
    """The module in the file ``path`` (names may hold dots and dashes)."""
    name = "portbench_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    if name in sys.modules:
        return sys.modules[name]
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


@dataclass
class JobRecord:
    """One timed job: what it did and what it returned (held for the
    check), and in a traced run what it measured."""

    index: int
    audio_s: float
    attempted: int
    failed: int
    outputs: object = None
    trace: Dict[str, float] = field(default_factory=dict)
    spans: List[tuple] = field(default_factory=list)  # (name, t0_ns, t1_ns)
    # (t0_ns, t1_ns) in which the benchmark wrote the job's inputs: left
    # out of the window's time
    pauses: List[tuple] = field(default_factory=list)

    @property
    def paused_s(self) -> float:
        return sum(b - a for a, b in self.pauses) / 1e9


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Context:
    manifest: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    cache_dir: Path
    work_dir: Path
    bench_dir: Path = BENCH_DIR


def cell(manifest: dict, name: str, bench_dir: Path = BENCH_DIR):
    """(workload, config, traffic, limits) of the cell ``name``."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in the manifest")
    w = by_name[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(manifest_path(configs[w["config"]]["file"], bench_dir))
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{name}.json")
    return w, config, traffic, limits


def manifest_path(rel: str, bench_dir: Path) -> Path:
    """A manifest path (relative to the checkout) under ``bench_dir``."""
    parts = Path(rel).parts
    return bench_dir.joinpath(*parts[1:])


def metrics_for(manifest: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports: those
    that list it, and those without a list that move (or are) a metric the
    cell reports."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def run_window(run_job: Callable[[int], JobRecord], seconds: float):
    """Jobs one after another from the window's start while it is open; a
    job started in the window runs to its end. The window's clock stops
    while a job's inputs are written. (records, the window's start on the
    host clock)."""
    records = []
    t0 = time.perf_counter()
    paused = 0.0
    while not records or time.perf_counter() - t0 - paused < seconds:
        records.append(run_job(len(records)))
        paused += records[-1].paused_s
    return records, t0


def run_cell(ctx: Context, t_start: Optional[float] = None, control: bool = False) -> dict:
    """Set-up, window and check of one run; the result line's object.
    Set-up counts from ``t_start`` (the process's start) where given. With
    ``control`` the line also holds the control's readings on the same
    sample (``portbench/control.py``; the benchmark's runs never read
    them)."""
    import torch

    t_setup = time.perf_counter() if t_start is None else t_start
    runner_mod = load_file(ctx.bench_dir / "runners" / f"{ctx.traffic['runner']}.py")
    runner = runner_mod.Runner(ctx)
    runner.setup()
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_setup

    prof = None
    if ctx.trace:
        from portbench import trace as tracing

        runner.begin_trace()
        prof = tracing.Profile(ctx.device)
        prof.start()
    records, t0 = run_window(runner.run_job, ctx.seconds)
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    pauses = [p for r in records for p in r.pauses]
    window = {"t0": t0, "t1": t_end, "pauses": pauses,
              "seconds": t_end - t0 - sum(r.paused_s for r in records),
              "audio_s": sum(r.audio_s for r in records), "setup_s": setup_s,
              "jobs": len(records)}
    trace_info = None
    if prof is not None:
        prof.stop()
        trace_info = runner.trace_summary(records, window)
        trace_info.update(prof.summary(window, [s for r in records for s in r.spans]))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted = sum(r.attempted for r in records)
    failed = sum(r.failed for r in records)
    runner.release()
    checks = runner.judge(records)

    result = {"correct": bool(failed == 0 and all(c.ok for c in checks)),
              "attempted": attempted, "failed": failed, "metrics": {}}
    manifest = ctx.manifest
    if ctx.trace:
        for m in metrics_for(manifest, ctx.workload["name"], "per_layer"):
            value = load_file(ctx.bench_dir / "layers" / f"{m['name']}.py").read(trace_info)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_for(manifest, ctx.workload["name"], "end_to_end"):
            value = load_file(ctx.bench_dir / "metrics" / f"{m['name']}.py").read(window)
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    if trace_info is not None:
        result["device"]["busy_s"] = trace_info["busy_s"]
        result["device"]["window_s"] = trace_info["window_s"]
        result["breakdown"] = trace_info["breakdown"]
    if control:
        result["control"] = {c.name: c.value for c in runner.judge(records, control=True)}
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def make_context(manifest: dict, workload: str, seed: int, seconds: float, trace: bool,
                 device, cache_dir: Path, bench_dir: Path = BENCH_DIR) -> Context:
    """The run's context; its inputs go to a new directory under TMPDIR."""
    w, config, traffic, limits = cell(manifest, workload, bench_dir)
    work_dir = Path(tempfile.mkdtemp(prefix="portbench-"))
    return Context(manifest, w, config, traffic, limits, seed, seconds, trace, device,
                   Path(cache_dir), work_dir, bench_dir)


def cleanup(ctx: Context) -> None:
    shutil.rmtree(ctx.work_dir, ignore_errors=True)
