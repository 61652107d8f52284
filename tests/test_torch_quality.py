"""The port's trained-quality tool at toy scale on the CPU.

``python -m waveunet_tpu_torch.tools.quality`` synthesises the set,
trains through ``python -m waveunet_tpu_torch train`` to early stop,
evaluates the best checkpoint and scores the mixture-as-estimate
baseline, as ``tools/quality.py`` does for the JAX package. Here every
stage runs at toy scale (``platform=cpu``, three layers, one epoch of three
iterations a round, one test song of 6 s); the artifact must have the JAX
tool's schema and the delta column must be model minus baseline. The
generator is held to ``tools/soak.py``'s bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from waveunet_tpu_torch.tools import synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import soak  # noqa: E402  (tools/soak.py, the JAX package's generator)


@pytest.mark.parametrize("fn", ["synth_song", "synth_song_multi"])
def test_generator_is_the_soak_tools(fn):
    a = getattr(synth, fn)(np.random.default_rng(1), 1, 8000)
    b = getattr(soak, fn)(np.random.default_rng(1), 1, 8000)
    a, b = (x if isinstance(x, dict) else dict(enumerate(x)) for x in (a, b))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def test_quality_tool_smoke(tmp_path):
    out = tmp_path / "quality.json"
    cmd = [sys.executable, "-m", "waveunet_tpu_torch.tools.quality",
           "--root", str(tmp_path / "q"),
           "--train-songs", "2", "--test-songs", "1", "--num-val-songs", "1",
           "--seconds", "6", "--epoch-it", "3", "--worse-epochs", "1",
           "--max-epochs", "1", "--out", str(out),
           # toy scale on the CPU; the fragments reach train and evaluate
           "platform=cpu", "num_layers=3", "num_frames=2048",
           "num_initial_filters=4", "batch_size=4",
           "num_snippets_per_track=4", "cache_size=8",
           "infer_num_frames=16384", "infer_batch=4"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stdout[-3000:] + "\n" + res.stderr[-3000:]
    assert "Quality table" in res.stdout
    for stage in (" train full_44KHz", " evaluate full_44KHz",
                  "checkpoint=best ->", "mixture-as-estimate baseline"):
        assert stage in res.stdout, stage

    table = json.loads(out.read_text())
    jax_keys = {"dataset", "preset", "task", "regime", "scoring", "model",
                "mixture_baseline", "delta_sdr_median"}
    assert jax_keys <= set(table)
    assert table["preset"] == "full_44KHz" and table["task"] == "voice"
    assert table["device"] == {"platform": "cpu", "nvidia_smi": None}
    assert table["dataset"]["test_songs"] == 1
    assert table["regime"]["max_epochs_per_round"] == 1
    assert table["regime"]["train_wall_s"] is not None
    assert "host fp64" in table["scoring"]
    assert set(table["model"]) == {"vocals", "accompaniment"}
    for src in ("vocals", "accompaniment"):
        for side in ("model", "mixture_baseline"):
            assert set(table[side][src]) == {"SDR", "ISR", "SIR", "SAR"}
            assert np.isfinite(table[side][src]["SDR"]["median"])
        want = round(table["model"][src]["SDR"]["median"]
                     - table["mixture_baseline"][src]["SDR"]["median"], 2)
        assert abs(table["delta_sdr_median"][src] - want) < 1e-9
