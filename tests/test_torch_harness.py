"""The port's MUSDB harness against the JAX package's, on the CPU.

A WAV-layout test set of noise stems (so every window's Gram is well
conditioned) goes through ``evaluate_musdb`` of both packages with the same
weights at a shrunk Wave-U-Net: the per-track JSONs agree within 1e-3 dB of
SDR and 0.01 dB of the other metrics (the forwards differ by fp32 rounding).
Then the port alone: resume, track sharding, the device scorers through the
harness, a mono track through a stereo model, a broken scoring pool,
``self_check_separator``, and what it refuses.
"""

import concurrent.futures
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from waveunet_tpu.config import get_config as jax_get_config
from waveunet_tpu.eval.harness import evaluate_musdb as jax_evaluate_musdb

from waveunet_tpu_torch.compat.params import params_from_numpy
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.data.audio_io import load_wav, write_wav
from waveunet_tpu_torch.eval import harness
from waveunet_tpu_torch.eval.harness import (aggregate_and_print,
                                             evaluate_musdb,
                                             self_check_separator,
                                             separate_track)
from waveunet_tpu_torch.infer.engine import Separator
from test_torch_model import numpy_params
from torch_cpu import few_threads  # noqa: F401

SR = 4096
SONGS = ("songA", "songB", "songC")
KW = dict(num_layers=3, num_initial_filters=4, num_frames=1024,
          expected_sr=SR)


def make_db(root, songs=SONGS, seconds=2.0, channels=2, seed=0):
    """Noise vocals and accompaniment, their clipped sum the mixture."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    for song in songs:
        d = root / "test" / song
        d.mkdir(parents=True)
        stems = {s: (0.2 * rng.standard_normal((n, channels))).astype(
            np.float32) for s in ("vocals", "accompaniment")}
        for s, v in stems.items():
            write_wav(str(d / f"{s}.wav"), v, SR)
        write_wav(str(d / "mixture.wav"), np.clip(sum(stems.values()), -1, 1),
                  SR)


def _frames(path):
    with open(path) as f:
        return {t["name"]: t["frames"] for t in json.load(f)["targets"]}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("harness")
    make_db(root / "db")
    cfg = get_config("baseline_stereo", musdb_path=str(root / "db"), **KW)
    params = numpy_params(cfg)
    env = {"root": root, "cfg": cfg, "np_params": params,
           "params": params_from_numpy(params, "cpu")}
    # the host scorer in its spawned pool, as a user runs it
    env["stats"] = evaluate_musdb(cfg, env["params"],
                                  output_path=str(root / "port"),
                                  max_tracks=2, scoring_workers=1,
                                  device="cpu")
    return env


def test_evaluate_musdb_matches_jax_package(env, tmp_path):
    jcfg = jax_get_config("baseline_stereo", musdb_path=env["cfg"].musdb_path,
                          **KW)
    jax_evaluate_musdb(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                    env["np_params"]),
                       output_path=str(tmp_path / "jax"), max_tracks=2,
                       scoring_workers=1)
    assert len(env["stats"]) == 2
    port = env["root"] / "port"
    for song in SONGS[:2]:
        got = _frames(port / "test" / f"{song}.json")
        want = _frames(tmp_path / "jax" / "test" / f"{song}.json")
        assert list(got) == list(want) == ["vocals", "accompaniment"]
        for name in got:
            assert len(got[name]) == len(want[name]) == 2
            for fg, fw in zip(got[name], want[name]):
                assert (fg["time"], fg["duration"]) == (fw["time"],
                                                        fw["duration"])
                for k, v in fw["metrics"].items():
                    tol = 1e-3 if k == "SDR" else 0.01
                    assert abs(fg["metrics"][k] - v) <= tol, (song, name, k)
        # the estimates written beside the JSONs: one int16 step apart
        for s in ("vocals", "accompaniment"):
            a = load_wav(str(port / song / f"{s}.wav"))[0]
            b = load_wav(str(tmp_path / "jax" / song / f"{s}.wav"))[0]
            assert np.abs(a - b).max() <= 1.0 / 32768 + 1e-7
    assert not os.path.exists(port / "test" / "songC.json")


def test_resume_skips_scored_tracks(env, tmp_path, capsys):
    out = str(tmp_path / "est")
    kw = dict(output_path=out, max_tracks=1, tpu_bss=True,
              self_check=False, device="cpu")
    evaluate_musdb(env["cfg"], env["params"], **kw)
    first = (tmp_path / "est" / "test" / "songA.json").read_bytes()
    capsys.readouterr()
    stats = evaluate_musdb(env["cfg"], env["params"], **kw)
    assert "Skipping songA (already evaluated)" in capsys.readouterr().out
    assert len(stats) == 2
    assert (tmp_path / "est" / "test" / "songA.json").read_bytes() == first


def test_track_sharding(env, tmp_path, capsys):
    out = tmp_path / "est"
    res_dir = out / "test"
    kw = dict(output_path=str(out), tpu_bss=True, self_check=False,
              aggregate=False, device="cpu")
    assert evaluate_musdb(env["cfg"], env["params"], shard_index=0,
                          shard_count=2, **kw) is None
    assert set(os.listdir(res_dir)) == {"songA.json", "songC.json"}
    text = capsys.readouterr().out
    assert "Skipping songB (shard 1/2's track)" in text
    assert ": SDR median" not in text
    evaluate_musdb(env["cfg"], env["params"], shard_index=1, shard_count=2,
                   **kw)
    assert set(os.listdir(res_dir)) == {f"{s}.json" for s in SONGS}
    capsys.readouterr()
    assert len(aggregate_and_print(str(res_dir))) == 2
    assert ": SDR median" in capsys.readouterr().out
    # max_tracks counts the global enumeration: shard 1 owns none of it
    for f in os.listdir(res_dir):
        os.remove(res_dir / f)
    evaluate_musdb(env["cfg"], env["params"], shard_index=1, shard_count=2,
                   max_tracks=1, **kw)
    assert os.listdir(res_dir) == []


@pytest.mark.filterwarnings("ignore::scipy.linalg.LinAlgWarning")
@pytest.mark.parametrize("tpu_bss,tol", [(True, 0.01), ("f64", 1e-6)])
def test_device_scorers_through_the_harness(env, tmp_path, tpu_bss, tol):
    """The device scorers score the harness's estimates as the host does:
    the fp32 one within its 0.01 dB, the fp64 one within 1e-6 dB (these
    noise windows are well conditioned, where the assemblies agree)."""
    dev_dir = tmp_path / "dev"
    evaluate_musdb(env["cfg"], env["params"], output_path=str(dev_dir),
                   tpu_bss=tpu_bss, max_tracks=1, self_check=False,
                   device="cpu")
    got = _frames(dev_dir / "test" / "songA.json")
    want = _frames(env["root"] / "port" / "test" / "songA.json")
    for name in want:
        for fg, fw in zip(got[name], want[name]):
            for k, v in fw["metrics"].items():
                assert abs(fg["metrics"][k] - v) <= tol + 1e-4 * abs(v), \
                    (name, k)


def test_mono_track_through_a_stereo_model(env, tmp_path):
    """A stereo model duplicates a mono track's channel; the estimates are
    downmixed back, so a mono track scores against mono references."""
    make_db(tmp_path / "db", songs=("mono",), channels=1, seed=1)
    cfg = env["cfg"].replace(musdb_path=str(tmp_path / "db"))
    stats = evaluate_musdb(cfg, env["params"],
                           output_path=str(tmp_path / "est"), tpu_bss=True,
                           self_check=False, device="cpu")
    assert len(stats) == 2
    frames = _frames(tmp_path / "est" / "test" / "mono.json")
    assert all(np.isfinite(f["metrics"]["SDR"]) for f in frames["vocals"])

    class FakeSep:
        def separate(self, mix, rate):
            assert mix.shape[1] == 1
            return {s: np.tile(0.5 * mix, [1, 2]) for s in cfg.source_names}

    mix = np.linspace(-0.5, 0.5, SR // 4, dtype=np.float32)[:, None]
    for est in separate_track(FakeSep(), cfg, mix, SR).values():
        np.testing.assert_allclose(est, 0.5 * mix, atol=1e-6)


def test_survives_a_broken_scoring_pool(env, tmp_path, monkeypatch, capsys):
    class PoisonedPool:
        def __init__(self, *a, **kw):
            pass

        def submit(self, *a, **kw):
            raise concurrent.futures.process.BrokenProcessPool(
                "worker died (simulated)")

        def shutdown(self, *a, **kw):
            pass

    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor",
                        PoisonedPool)
    stats = evaluate_musdb(env["cfg"], env["params"],
                           output_path=str(tmp_path / "est"), max_tracks=2,
                           self_check=False, device="cpu")
    assert len(stats) == 2
    assert {"songA.json", "songB.json"} <= set(
        os.listdir(tmp_path / "est" / "test"))
    assert "scoring pool broken" in capsys.readouterr().out


def test_self_check_separator(env):
    cfg = env["cfg"]
    self_check_separator(cfg, Separator(cfg, env["params"], device="cpu"))

    def bad_forward(p, x):
        from waveunet_tpu_torch.models.waveunet import apply_waveunet
        out = apply_waveunet(p, cfg, x, training=False)
        return {"not_a_source": out[cfg.source_names[0]]}

    bad = Separator(cfg, env["params"], forward_fn=bad_forward, device="cpu")
    with pytest.raises(RuntimeError, match="self-check failed"):
        self_check_separator(cfg, bad)


def test_refusals(env, tmp_path):
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        evaluate_musdb(env["cfg"], env["params"], mesh=object(),
                       device="cpu")
    with pytest.raises(ImportError, match="musdb package"):
        next(harness.iter_tracks(str(tmp_path / "nowhere"), "test"))
