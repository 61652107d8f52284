"""What a run may load: nothing of JAX or of the JAX package, and a
reference that takes nothing from the program it judges."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def imported(path):
    """Top-level names of every module a file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sources():
        bad = set(imported(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = set(imported(path))
        assert "waveunet_tpu_torch" not in names, path
        assert names <= {"__future__", "math", "fractions", "contextlib",
                         "typing", "numpy", "torch", "benchmark"}, (path,
                                                                    names)
        with open(path) as f:
            text = f.read()
        assert "benchmark." not in text.replace("benchmark.reference", ""), \
            path


def test_the_check_names_whole_top_level_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "waveunet_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "waveunet_tpu.config", sys)
    with pytest.raises(harness.RunError) as e:
        harness.check_imports()
    assert e.value.code == 4 and "waveunet_tpu.config" in str(e.value)


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_rehearsal_loads_neither_jax_nor_the_jax_package():
    p = _run(["-c", "import json, sys\n"
              "from benchmark import harness\n"
              "out, _ = harness.run('m5-highsr.clips', 3, 0.2, "
              "rehearsal=True)\n"
              "print(json.dumps([out['correct'], "
              "harness.forbidden_modules(), "
              "'waveunet_tpu_torch' in sys.modules]))"], ROOT)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.splitlines()[-1]) == [True, [], True]


def test_a_run_without_a_card_prints_no_result():
    p = _run(["-m", "benchmark.run", "--workload", "m5-highsr.songs",
              "--seed", "1", "--seconds", "1", "--trace", "0"], ROOT,
             dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_a_run_without_the_program_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(["-m", "benchmark.run", "--workload", "m5-highsr.songs",
              "--seed", "1", "--seconds", "1", "--trace", "0"],
             str(tmp_path), env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "the program is missing" in p.stderr
