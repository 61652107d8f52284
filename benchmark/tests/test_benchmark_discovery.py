"""A later PR adds a cell, a traffic mix and a per-layer metric as files,
and the harness lists and runs them with no file edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def digest(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            if "__pycache__" not in base:
                p = os.path.join(base, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, d)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_added_files_are_found_and_run(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(copy)
    (copy / "traffic" / "shorts.json").write_text(json.dumps({
        "kind": "separate", "why": "very short clips",
        "input_sr": 22050, "lengths_s": {"min": 0.2, "max": 0.6,
                                         "count": 4, "spacing": "log"},
        "check_extra": 2, "end_to_end": ["clip_latency_p95_ms"]}))
    (copy / "workloads" / "m6-multi.shorts.json").write_text(json.dumps({
        "config": "m6-multi", "traffic": "shorts", "chips": 1,
        "limits": {"stem_gap": 1e-5}}))
    (copy / "metrics" / "chunk_calls.shorts.py").write_text(
        'MOVES = "clip_latency_p95_ms"\nUNIT = "calls"\nLAYER = "forward"\n'
        '\n\ndef read(ctx):\n'
        '    return float(sum(c.op == "conv" for c in ctx.work["calls"]))\n')
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run(
        [sys.executable, "-c",
         "import json\nfrom benchmark import catalog, harness\n"
         "out, _ = harness.run('m6-multi.shorts', 5, 0.3, rehearsal=True)\n"
         "print(json.dumps([catalog.cells(), "
         "sorted(catalog.metric_readers()), out]))"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 0, p.stderr
    cells, readers, out = json.loads(p.stdout.splitlines()[-1])
    assert "m6-multi.shorts" in cells and "chunk_calls.shorts" in readers
    assert out["correct"] is True
    assert out["metrics"]["chunk_calls.shorts"]["value"] > 0
    assert out["device"]["platform"] == "cpu"
    after = digest(copy)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == [
        "metrics/chunk_calls.shorts.py", "traffic/shorts.json",
        "workloads/m6-multi.shorts.json"]
