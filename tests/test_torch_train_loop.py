"""The port's training loop on the CPU: both rounds of ``optimise``, the
Adam slots carried across the round boundary and across a resume, the
fused epoch against the eager loop bit for bit (chunked, unchunked and
resumed), and the checkpoint writer's retention, ordering and partial
directories.
"""

import json
import os

import numpy as np
import pytest
import torch

from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.data import cache
from waveunet_tpu_torch.data.audio_io import write_wav
from waveunet_tpu_torch.data.device_cache import DeviceBank
from waveunet_tpu_torch.ops import shapes
from waveunet_tpu_torch.train import checkpoint as ckpt
from waveunet_tpu_torch.train import loop as loop_mod
from waveunet_tpu_torch.train import step as step_mod
from waveunet_tpu_torch.train.loop import (TrainState, init_state, optimise,
                                           train_one_epoch)
from waveunet_tpu_torch.train.step import make_scanned_epoch, make_train_step
from torch_cpu import few_threads  # noqa: F401


def tiny_cfg(tmp_path, **over):
    kw = dict(num_layers=2, num_frames=256, num_initial_filters=4,
              batch_size=2, epoch_it=3, worse_epochs=1, scan_chunk=2,
              num_snippets_per_track=4, cache_size=8, num_workers=1,
              data_path=str(tmp_path / "cache"),
              model_base_dir=str(tmp_path / "ckpt"),
              log_dir=str(tmp_path / "logs"))
    kw.update(over)
    return get_config("full_44KHz", **kw)


def make_cache(tmp_path, cfg, n_songs=2, seconds=0.4):
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    rng = np.random.default_rng(0)
    for part in ("train", "valid", "test"):
        samples = []
        for i in range(n_songs):
            n = int(cfg.expected_sr * seconds)
            t = np.arange(n) / cfg.expected_sr
            tracks = {}
            for j, name in enumerate(cfg.source_names):
                sig = (0.3 * np.sin(2 * np.pi * (200.0 * (j + 1) + 50 * i)
                                    * t) + 0.05 * rng.standard_normal(n))
                tracks[name] = np.tile(sig[:, None].astype(np.float32),
                                       (1, cfg.num_channels))
            tracks["mix"] = sum(tracks.values())
            d = tmp_path / "wav" / part
            d.mkdir(parents=True, exist_ok=True)
            paths = {}
            for k, v in tracks.items():
                paths[k] = str(d / f"s{i}_{k}.wav")
                write_wav(paths[k], v, cfg.expected_sr, subtype="FLOAT")
            samples.append(paths)
        cache.preprocess_partition(cfg, part, samples,
                                   pad_frames=(in_len - out_len) // 2)


def assert_same(a, b):
    for k in a:
        for n in a[k]:
            assert torch.equal(a[k][n], b[k][n]), (k, n)


def test_optimise_runs_both_rounds(tmp_path, capsys):
    cfg = tiny_cfg(tmp_path)
    make_cache(tmp_path, cfg)
    best, test_loss = optimise(cfg, experiment_id="e", max_epochs_per_round=1,
                               device="cpu")
    out = capsys.readouterr().out
    assert "entering fine-tuning stage" in out
    assert "epoch 1 wall: train" in out
    assert np.isfinite(test_loss)
    d = tmp_path / "ckpt" / "e"
    assert sorted(os.listdir(d)) == ["best.txt", "step_0000000003",
                                     "step_0000000006"]
    assert open(d / "best.txt").read().strip() == best
    r = ckpt.restore_checkpoint(best)
    assert r["step"] == int(r["opt_state"]["count"]) == int(best[-10:])
    recs = [json.loads(line) for line in
            open(tmp_path / "logs" / "e" / "metrics.jsonl")]
    keys = set().union(*recs)
    assert {"step", "time", "sep_loss", "epoch_mean_loss", "steps_per_sec",
            "valid_loss", "epoch_wall_s", "valid_wall_s",
            "checkpoint_wall_s", "test_loss"} <= keys
    assert (tmp_path / "logs" / "e" / "config.json").exists()


def test_optimise_initialises_adam_once_and_carries_it(tmp_path,
                                                       monkeypatch):
    """The Adam slots are made once, in init_state; round 2 and its lr go on
    from round 1's count and moments."""
    calls = []
    real_init = step_mod.Adam.init

    def counted(self, params):
        calls.append(self.lr)
        return real_init(self, params)
    monkeypatch.setattr(step_mod.Adam, "init", counted)
    lrs = []
    real_update = step_mod.Adam.update_

    def recorded(self, params, grads, state):
        lrs.append((self.lr, int(state["count"])))
        return real_update(self, params, grads, state)
    monkeypatch.setattr(step_mod.Adam, "update_", recorded)
    cfg = tiny_cfg(tmp_path, init_sup_sep_lr=1e-4)
    make_cache(tmp_path, cfg)
    optimise(cfg, experiment_id="s", max_epochs_per_round=1, device="cpu")
    assert calls == [1e-4]
    assert lrs == [(1e-4, 0), (1e-4, 1), (1e-4, 2),
                   (1e-5, 3), (1e-5, 4), (1e-5, 5)]


def test_optimise_resumes_with_the_saved_slots(tmp_path):
    cfg = tiny_cfg(tmp_path)
    make_cache(tmp_path, cfg)
    best, _ = optimise(cfg, experiment_id="a", max_epochs_per_round=1,
                       device="cpu")
    saved = ckpt.restore_checkpoint(best)
    optimise(cfg, experiment_id="b", resume_path=best,
             max_epochs_per_round=1, device="cpu")
    first = ckpt.restore_checkpoint(
        ckpt.step_path(cfg.model_base_dir, "b", saved["step"] + 3))
    assert int(first["opt_state"]["count"]) == saved["step"] + 3
    assert first["step"] == saved["step"] + 3


def _bank_and_state(tmp_path, **over):
    cfg = tiny_cfg(tmp_path, **over)
    make_cache(tmp_path, cfg)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    bank = DeviceBank(cfg, "train", in_len, out_len, device="cpu")
    return cfg, bank


def test_fused_epoch_equals_eager_loop_bit_for_bit(tmp_path):
    cfg, bank = _bank_and_state(tmp_path, epoch_it=5)
    lr = cfg.init_sup_sep_lr
    eager = init_state(cfg, device="cpu")
    _, step_fn = make_train_step(cfg, lr, device="cpu")
    eager, eager_loss = train_one_epoch(cfg, eager, step_fn,
                                        bank.batches(7, start=0))
    for chunk in (None, 2):
        fused = init_state(cfg, device="cpu")
        epoch_fn = make_scanned_epoch(cfg, lr, cfg.epoch_it, bank.sample,
                                      chunk=chunk, device="cpu")
        fused, fused_loss = loop_mod.train_one_epoch_scanned(cfg, fused,
                                                             epoch_fn, 7)
        assert fused.step == eager.step == 5
        assert fused_loss == eager_loss
        assert_same(fused.params, eager.params)
        for tree in ("mu", "nu"):
            assert_same(fused.opt_state[tree], eager.opt_state[tree])
        assert int(fused.opt_state["count"]) == 5


def test_resumed_epochs_equal_uninterrupted_ones(tmp_path):
    """Two epochs in one go against one epoch, a checkpoint, a restore and
    another epoch: the same stream, the same parameters."""
    cfg, bank = _bank_and_state(tmp_path)
    epoch_fn = make_scanned_epoch(cfg, 1e-3, cfg.epoch_it, bank.sample,
                                  chunk=cfg.scan_chunk, device="cpu")
    straight = init_state(cfg, device="cpu")
    for _ in range(2):
        straight, _ = loop_mod.train_one_epoch_scanned(cfg, straight,
                                                       epoch_fn, 3)
    first = init_state(cfg, device="cpu")
    first, _ = loop_mod.train_one_epoch_scanned(cfg, first, epoch_fn, 3)
    path = ckpt.save_checkpoint(str(tmp_path / "ck"), "r", first.step,
                                first.as_dict())
    r = ckpt.restore_checkpoint(path)
    resumed = TrainState(r["params"], r["model_state"], r["opt_state"],
                         r["step"])
    resumed, _ = loop_mod.train_one_epoch_scanned(
        cfg, resumed, make_scanned_epoch(cfg, 1e-3, cfg.epoch_it, bank.sample,
                           device="cpu"),
        3)
    assert resumed.step == straight.step == 6
    assert_same(resumed.params, straight.params)
    assert int(resumed.opt_state["count"]) == 6


def test_u7_fused_epoch_equals_eager_loop(tmp_path):
    """U7 draws its dropout masks per absolute step, so its fused epoch is
    the eager loop too (and moves its batch-norm statistics)."""
    cfg = get_config("unet_spectrogram", num_layers=3, num_initial_filters=4,
                     num_frames=768 * 7 + 1024, batch_size=1, epoch_it=2,
                     data_path=str(tmp_path / "cache"))
    make_cache(tmp_path, cfg, seconds=1.2)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    bank = DeviceBank(cfg, "train", in_len, out_len, device="cpu")
    eager = init_state(cfg, device="cpu")
    stats0 = {k: v["mean"].clone() for k, v in eager.model_state.items()}
    _, step_fn = make_train_step(cfg, 1e-4, device="cpu")
    eager, el = train_one_epoch(cfg, eager, step_fn, bank.batches(1, start=0))
    fused = init_state(cfg, device="cpu")
    fused, fl = loop_mod.train_one_epoch_scanned(
        cfg, fused, make_scanned_epoch(cfg, 1e-4, cfg.epoch_it, bank.sample,
                           device="cpu"),
        1)
    assert el == fl
    assert_same(fused.params, eager.params)
    assert_same(fused.model_state, eager.model_state)
    assert any(not torch.equal(stats0[k], eager.model_state[k]["mean"])
               for k in stats0)


def test_optimise_refuses_multi_gpu(tmp_path, monkeypatch):
    """A mesh that is not the port's raises TypeError; several processes
    without a mesh raise the JAX package's ValueError."""
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        optimise(tiny_cfg(tmp_path), mesh=object(), device="cpu")
    monkeypatch.setattr(loop_mod, "world", lambda: (0, 2))
    with pytest.raises(ValueError, match="pod training requires a mesh"):
        optimise(tiny_cfg(tmp_path), device="cpu")


# -- checkpoints -------------------------------------------------------------

def test_checkpoint_round_trip_and_async_matches_sync(tmp_path):
    base = str(tmp_path / "ck")
    state = {"step": 7, "params": {"a": {"w": torch.arange(12.0)}},
             "opt_state": {"count": torch.tensor(7, dtype=torch.int32)}}
    sync = ckpt.save_checkpoint(base, "sync", 7, state)
    paths = [ckpt.save_checkpoint_async(base, "async", s, dict(state, step=s),
                                        prune_keep=2,
                                        protect=(None if s == 0 else
                                                 ckpt.step_path(base, "async",
                                                                0),))
             for s in range(4)]
    ckpt.wait_for_saves()
    left = sorted(os.listdir(tmp_path / "ck" / "async"))
    assert left == [os.path.basename(p) for p in (paths[0], *paths[2:])]
    got, want = ckpt.restore_checkpoint(paths[3]), ckpt.restore_checkpoint(
        sync)
    assert got["step"] == 3 and want["step"] == 7
    assert torch.equal(got["params"]["a"]["w"], want["params"]["a"]["w"])
    assert got["opt_state"]["count"].dtype == torch.int32


def test_async_snapshot_is_taken_at_save_time(tmp_path):
    w = torch.zeros(4)
    path = ckpt.save_checkpoint_async(str(tmp_path), "s", 1, {"w": w})
    w.add_(1.0)  # the next step updates the state in place
    ckpt.wait_for_saves()
    assert torch.equal(ckpt.restore_checkpoint(path)["w"], torch.zeros(4))


def test_after_saves_runs_behind_pending_writes(tmp_path):
    order = []
    ckpt.after_saves(lambda: order.append("inline"))
    assert order == ["inline"]
    path = ckpt.save_checkpoint_async(str(tmp_path), "o", 5,
                                      {"w": torch.ones(1000)})
    ckpt.after_saves(lambda: order.append(os.path.isdir(path)))
    ckpt.wait_for_saves()
    assert order == ["inline", True]


def test_latest_and_pruning_ignore_partial_directories(tmp_path):
    base = str(tmp_path)
    paths = [ckpt.save_checkpoint(base, "e", s, {"step": s}) for s in range(4)]
    partial = os.path.join(base, "e", "step_0000000009.tmp-123")
    os.makedirs(partial)
    assert ckpt.latest_checkpoint(base, "e") == paths[-1]
    ckpt.prune_checkpoints(base, "e", 0)
    assert len(os.listdir(os.path.join(base, "e"))) == 5
    ckpt.prune_checkpoints(base, "e", 2, protect=(paths[0],))
    left = sorted(os.listdir(os.path.join(base, "e")))
    assert left == sorted([os.path.basename(paths[0]),
                           os.path.basename(paths[2]),
                           os.path.basename(paths[3]),
                           os.path.basename(partial)])
    assert ckpt.latest_checkpoint(base, "missing") is None


def test_metric_log_and_profiler_trace(tmp_path):
    from waveunet_tpu_torch.train.metrics import MetricLogger

    log = MetricLogger(str(tmp_path), "m", use_tensorboard=False)
    log.log(3, sep_loss=torch.tensor(0.5), steps_per_sec=2)
    log.close()
    rec = json.loads(open(tmp_path / "m" / "metrics.jsonl").read())
    assert rec["step"] == 3 and rec["sep_loss"] == 0.5 and "time" in rec
