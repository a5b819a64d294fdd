"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references import nothing of the program."""

import ast
import json
import subprocess
import sys

from portbench import harness

ROOT = harness.BENCH_DIR.parent


def _top_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_a_forbidden_package():
    for path in harness.BENCH_DIR.rglob("*.py"):
        assert not _top_imports(path) & set(harness.FORBIDDEN_MODULES), path


def test_references_import_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        assert "montreal_forced_aligner_tpu_torch" not in _top_imports(path), path
        assert "mfa_tpu_torch" not in _top_imports(path), path


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "montreal_forced_aligner_tpu_torch_x", sys)
    assert "montreal_forced_aligner_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_loaded()


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A tiny run of each cell's path in a fresh process, then the check the
    entry point makes on ``sys.modules``."""
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(harness.BENCH_DIR / 'tests')!r})
import tiny
from portbench import harness
for cell in ("align-sat-librispeech", "whisper-turbo-greedy"):
    r = harness.run_cell(tiny.context(cell, {str(tmp_path)!r}))
    assert r["correct"], r
print(json.dumps(harness.forbidden_loaded()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_entry_point_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
                          "align-sat-librispeech", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    import torch

    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout.strip() == ""
