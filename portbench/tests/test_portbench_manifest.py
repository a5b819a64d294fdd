"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup by name: each piece a file of its own."""

import json
import re
import shutil

import pytest

from portbench import harness

ROOT = harness.BENCH_DIR.parent
M = harness.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_and_names():
    assert set(M) == KEYS["top"]
    assert M["command"] == ["python3", "portbench/run.py"] and M["paths"] == ["portbench"]
    assert 1 <= M["run_seconds"] <= 51
    names = []
    for kind, items in (("config", M["configs"]), ("workload", M["workloads"]),
                        ("end_to_end", M["end_to_end"]), ("per_layer", M["per_layer"])):
        for item in items:
            assert set(item) - {"workloads"} == KEYS[kind], item["name"]
            assert NAME.fullmatch(item["name"]), item["name"]
            names.append(item["name"])
            for key in ("why", "layer", "source"):
                if key in item:
                    assert 1 <= len(item[key]) <= 200 and "\n" not in item[key]
    for group in (M["configs"], M["workloads"], M["end_to_end"] + M["per_layer"]):
        assert len({i["name"] for i in group}) == len(group)
    assert len(json.dumps(M)) <= 64 * 1024


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert (harness.BENCH_DIR / "layers" / f"{m['name']}.py").exists()
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
        # every cell that reports it reports the metric it moves
        for cell in m["workloads"]:
            reported = {e["name"] for e in harness.metrics_for(M, cell, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)


def test_layers_named_alike():
    by_layer = {}
    for m in M["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"])
    for layer in by_layer:
        assert layer.strip() == layer and 1 <= len(layer) <= 200


def test_every_cell_resolves():
    configs = {c["name"] for c in M["configs"]}
    used = set()
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        used.add(w["config"])
        workload, config, traffic, limits = harness.cell(M, w["name"])
        assert config["name"] == w["config"]
        assert (harness.BENCH_DIR / "runners" / f"{traffic['runner']}.py").exists()
        assert (harness.BENCH_DIR / "models" / f"{config['kind']}.py").exists()
        assert (harness.BENCH_DIR / "reference" / f"{config['kind']}.py").exists()
        cells = harness.metrics_for(M, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in cells} and len(cells) >= 2
        assert harness.metrics_for(M, w["name"], "per_layer")
        assert all(isinstance(v, (int, float)) for v in limits.values())
    assert used == configs
    for c in M["configs"]:
        cfg = harness.load_json(ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] in c["source"] + cfg["source"]


def test_a_new_mix_is_new_files_only(tmp_path):
    """A throwaway mix and its cell: new files and entries, no file
    edited."""
    bench = tmp_path / "portbench"
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns("cache", "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    mix = harness.load_json(bench / "traffic" / "librispeech-dev-clean.json")
    mix.update(name="throwaway", speakers=8, utterances_per_speaker=5, jobs=2)
    (bench / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    (bench / "limits" / "align-sat-throwaway.json").write_text(
        (bench / "limits" / "align-sat-librispeech.json").read_text())
    manifest = json.loads(json.dumps(M))
    manifest["workloads"].append({"name": "align-sat-throwaway", "config": "gmm-sat-5k",
                                  "traffic": "throwaway", "chips": 1, "why": "a test"})
    manifest["end_to_end"][0]["workloads"].append("align-sat-throwaway")
    w, config, traffic, limits = harness.cell(manifest, "align-sat-throwaway", bench)
    assert traffic["speakers"] == 8 and config["name"] == "gmm-sat-5k"
    assert {m["name"] for m in harness.metrics_for(manifest, "align-sat-throwaway",
                                                   "end_to_end")} == {"align_audio_s_per_s",
                                                                      "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data


def test_a_missing_piece_is_refused(tmp_path):
    manifest = json.loads(json.dumps(M))
    manifest["workloads"].append({"name": "nothing", "config": "gmm-sat-5k",
                                  "traffic": "no-such-mix", "chips": 1, "why": "a test"})
    with pytest.raises(FileNotFoundError):
        harness.cell(manifest, "nothing")
