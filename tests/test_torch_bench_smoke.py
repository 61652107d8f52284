"""The port's bench (``python -m waveunet_tpu_torch.bench``) on the CPU.

``BENCH_SMOKE=1`` runs the bench's own code (warm-up, compute roof, the
three families' resident sweeps, the serial baselines, the interleaved e2e
reps, the FLOP count, the JSON line) with tiny models and a short song on
the CPU, the counterpart of tests/test_bench_smoke.py: its numbers mean
nothing, its schema is checked. The timing helpers and the analytic FLOP
count are checked on their own.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from waveunet_tpu_torch import bench
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.models import waveunet as model
from torch_cpu import few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_smoke_schema():
    # two threads, as few_threads gives this process
    env = dict(os.environ, BENCH_SMOKE="1", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "waveunet_tpu_torch.bench"],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    for k in bench.REQUIRED_KEYS:
        assert k in rec, f"bench JSON lost key {k!r}"
    assert rec["metric"] == "engine_device_resident_audio_s_per_s"
    assert rec["smoke"] is True
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["value_median"] > 0 and rec["value_spread"] >= 1
    for fam in ("m6_resident_audio_s_per_s", "u7_resident_audio_s_per_s",
                "compute_roof_audio_s_per_s", "e2e_rtf"):
        assert rec[fam] > 0, fam
    assert rec["flagship_flops_source"] == "analytic-conv-shapes"
    assert rec["e2e_reps"] == 2
    assert rec["device_name"] == "cpu" and rec["n_devices"] == 0


def test_bench_needs_a_card_unless_smoke(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.run(smoke=False)


def test_pick_k_contract():
    assert bench.pick_k(0.02) == 15
    assert bench.pick_k(0.2) == 4
    assert bench.pick_k(1.0) == 4
    assert bench.pick_k(0.0) == 32
    assert bench.pick_k(1e-9) == 32


def test_best_pipelined_adaptive_sizing(monkeypatch):
    """Two-stage sizing on a fake clock: a waited single call sizes k, the
    first batch's per-call time re-sizes it; an explicit k is kept."""
    clock = {"t": 0.0}
    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock["t"])

    def make(prog_s, ovh_s):
        def dispatch():
            clock["t"] += prog_s

        def wait(_):
            clock["t"] += ovh_s
        return dispatch, wait

    d, w = make(0.005, 0.015)
    p = bench.best_pipelined(d, wait=w)
    assert p.k == 32 and abs(p.best - (0.005 + 0.015 / 32)) < 1e-9
    assert len(p.times) == 3
    d, w = make(0.2, 0.015)
    p = bench.best_pipelined(d, wait=w)
    assert p.k == 4 and abs(p.best - (0.2 + 0.015 / 4)) < 1e-9
    assert len(p.times) == 3  # the refining batch is kept as a scored one
    d, w = make(0.005, 0.015)
    p = bench.best_pipelined(d, k=8, wait=w)
    assert p.k == 8 and abs(p.best - (0.005 + 0.015 / 8)) < 1e-9


def test_flagship_flops_match_the_recorded_window_cost():
    """37.48 GFLOP per 65,536-frame window (PERF.md section 4), 25.2 GFLOP
    per audio-second, against the JAX bench's cost-analysis 25.3."""
    from waveunet_tpu_torch.ops import shapes

    cfg = get_config("full_44KHz")
    in_len, out_len = shapes.get_padding(cfg, 65536)
    flops = bench.waveunet_conv_flops(cfg, in_len)
    assert abs(flops / 1e9 - 37.487) < 0.001
    assert abs(flops / 1e9 / (out_len / 44100) - 25.22) < 0.01


@pytest.mark.parametrize("preset,kw", [
    ("full_44KHz", dict(num_layers=4, num_initial_filters=6)),
    ("baseline", dict(num_layers=3, num_initial_filters=5)),
    ("full_multi_instrument", dict(num_layers=3, num_initial_filters=4)),
    ("baseline_context_smallfilter_deep", dict(num_layers=5))])
def test_conv_flops_count_every_conv_of_the_forward(preset, kw, monkeypatch):
    """The analytic count equals 2*MACs summed over the convs the model
    actually runs on a window."""
    cfg = get_config(preset, **kw)
    in_len, _ = model.io_shapes(cfg)
    counted = []
    real_act, real_conv = model.conv1d_lrelu, model.conv1d

    def act(x, w, b):
        y = real_act(x, w, b)
        counted.append(2 * y.shape[1] * w.numel())
        return y

    def conv(x, p, **k):
        y = real_conv(x, p, **k)
        counted.append(2 * y.shape[1] * p["kernel"].numel())
        return y

    monkeypatch.setattr(model, "conv1d_lrelu", act)
    monkeypatch.setattr(model, "conv1d", conv)
    params = model.init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")
    model.apply_waveunet(params, cfg, torch.zeros(1, in_len,
                                                  cfg.num_channels))
    assert bench.waveunet_conv_flops(cfg, in_len) == sum(counted)
