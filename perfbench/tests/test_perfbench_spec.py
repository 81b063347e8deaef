"""The specification and the run's frame: the last line's shape, a cell
added as new files only, the import guard, and the reference's
independence from the program."""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

from perfbench import core
from perfbench.run import execute
from tinybench import REAL, job, tiny_tree

ROOT = REAL.parent


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


def test_last_line_shape(tree):
    j = job(*tree, "stosavi_clevrer.train")
    result, checks = execute(j.cell, j.seed, j.seconds, False, j.device,
                             j.process_start)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        core.emit(result, checks)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"setup_s", "train_clips_per_s",
                                    "train_peak_mem_gib"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    tail = err.getvalue().splitlines()[-len(checks):]
    assert [t.split()[1] for t in tail] == list(checks)
    assert all(" limit " in t for t in tail)


def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_as_new_files_only(tree, tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files (and entries in BENCHMARK.json) are found by name."""
    spec, bench = tiny_tree(tmp_path)
    before = _digest(bench)
    cfg = json.loads((bench / "configs" / "stosavi_clevrer.json").read_text())
    cfg["name"] = "stosavi_wide"
    cfg["params"]["slot_dict"]["num_slots"] = 4
    cfg["slot_attention"]["S"] = 4
    (bench / "configs" / "stosavi_wide.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "train_pool3.json").write_text(json.dumps(
        {"kind": "train", "why": "three batches", "pool_batches": 3,
         "check_steps": 3}))
    (bench / "metrics" / "steps_traced.train.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    shutil.copy(bench / "limits" / "stosavi_clevrer.train.json",
                bench / "limits" / "stosavi_wide.train_pool3.json")
    spec["configs"].append({"name": "stosavi_wide", "source": "x",
                            "file": "perfbench/configs/stosavi_wide.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "stosavi_wide.train_pool3",
                              "config": "stosavi_wide", "traffic": "train_pool3",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m.get("workloads") and "stosavi_clevrer.train" in m["workloads"]:
            m["workloads"].append("stosavi_wide.train_pool3")
    spec["per_layer"].append({"name": "steps_traced.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "trainer", "moves": "train_clips_per_s",
                              "workloads": ["stosavi_wide.train_pool3"]})
    changed = {k for k, v in _digest(bench).items() if before.get(k, v) != v}
    assert not changed
    j = job(spec, bench, "stosavi_wide.train_pool3", trace=True)
    result, checks = execute(j.cell, j.seed, j.seconds, True, j.device,
                             j.process_start)
    assert result["correct"], checks
    assert result["metrics"]["steps_traced.train"]["value"] == result["attempted"]


def test_banned_modules_compared_whole():
    code = ("import sys, types\n"
            "from perfbench import core\n"
            "sys.modules['slotformer_tpu_torch_x'] = types.ModuleType('a')\n"
            "sys.modules['jaxtyping'] = types.ModuleType('b')\n"
            "assert core.banned_modules() == [], core.banned_modules()\n"
            "sys.modules['slotformer_tpu.ops'] = types.ModuleType('c')\n"
            "sys.modules['jax'] = types.ModuleType('d')\n"
            "assert core.banned_modules() == ['jax', 'slotformer_tpu.ops']\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env=dict(os.environ, PYTHONPATH=str(ROOT)))


def test_a_run_loads_nothing_banned():
    """A whole tiny run, in a process of its own, leaves no module of JAX
    or of the JAX package loaded."""
    code = ("import sys, tempfile\n"
            f"sys.path.insert(0, {str(REAL / 'tests')!r})\n"
            "from tinybench import CELLS, STEVE, job, tiny_tree\n"
            "from perfbench import core\n"
            "from perfbench.run import execute\n"
            "with tempfile.TemporaryDirectory() as tmp:\n"
            "    tree = tiny_tree(tmp)\n"
            "    for name in CELLS + (STEVE,):\n"
            "        j = job(*tree, name, seconds=0.1)\n"
            "        execute(j.cell, j.seed, j.seconds, False, j.device, j.process_start)\n"
            "assert 'slotformer_tpu_torch' in sys.modules\n"
            "assert core.banned_modules() == [], core.banned_modules()\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=600)


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "typing", "torch", "nn", "train"}
    for path in (REAL / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)
    code = ("import sys\n"
            "import perfbench.reference.stosavi, perfbench.reference.slotformer\n"
            "import perfbench.reference.steve\n"
            "import perfbench.reference.train\n"
            "assert not [m for m in sys.modules if m.startswith('slotformer_tpu')]\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env=dict(os.environ, PYTHONPATH=str(ROOT)))


def test_run_refuses_without_the_program_or_a_card(tmp_path):
    """Without CUDA (this machine) and in a checkout holding only the
    benchmark, the command exits non-zero and prints no result."""
    shutil.copytree(REAL, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    args = ["--workload", "stosavi_clevrer.train", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (tmp_path, ROOT):
        p = subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd,
                           capture_output=True, text=True, env=env, timeout=300)
        if cwd == ROOT and p.returncode == 0:
            pytest.skip("this machine has a card")
        assert p.returncode != 0 and p.stdout == "", (cwd, p.stderr)
