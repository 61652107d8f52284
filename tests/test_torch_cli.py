"""The port's command line on the CPU (``platform=cpu``): the counterpart of
each ``tests/test_cli.py`` test, every command driven through ``cli.main``
on tiny configs, a checkpoint trained by the ``train`` command itself, and
the outputs of ``predict`` and ``evaluate`` equal to the library calls'.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

from waveunet_tpu_torch import cli
from waveunet_tpu_torch.config import config_from_cli, get_config
from waveunet_tpu_torch.data.audio_io import load, write_wav
from test_torch_train_loop import make_cache
from torch_cpu import few_threads  # noqa: F401

_SR = 8192
_CFG_ARGS = ["num_layers=2", "num_frames=256", "num_initial_filters=4",
             f"expected_sr={_SR}", "batch_size=4", "epoch_it=2",
             "num_snippets_per_track=4", "cache_size=8", "worse_epochs=1"]
_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "waveunet_tf",
                       "same_linear_direct_mono", "model.ckpt")
_CONV_ARGS = ["num_layers=3", "num_frames=512", "num_initial_filters=8"]


def run(*argv):
    cli.main(list(argv) + ["platform=cpu"])


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """A synthetic song cache, a WAV-layout test set, and a checkpoint
    trained through ``cli train``."""
    root = tmp_path_factory.mktemp("cli")
    args = (_CFG_ARGS
            + [f"data_path={root / 'cache'}", f"musdb_path={root / 'db'}",
               f"model_base_dir={root / 'ckpts'}", f"log_dir={root / 'logs'}"])
    make_cache(root, config_from_cli(["baseline"] + args), n_songs=3)

    d = root / "db" / "test" / "songC"
    d.mkdir(parents=True)
    t = np.arange(_SR * 2) / _SR
    voc = (0.3 * np.sin(2 * np.pi * 440 * t))[:, None].astype(np.float32)
    acc = (0.3 * np.sin(2 * np.pi * 220 * t))[:, None].astype(np.float32)
    write_wav(str(d / "vocals.wav"), voc, _SR)
    write_wav(str(d / "accompaniment.wav"), acc, _SR)
    write_wav(str(d / "mixture.wav"), np.clip(voc + acc, -1, 1), _SR)

    run("train", "baseline", *args, "experiment_id=clitest", "max_epochs=1")
    best = open(root / "ckpts" / "clitest" / "best.txt").read().strip()
    assert os.path.isdir(best)
    return {"root": root, "args": args, "best": best,
            "mix": str(d / "mixture.wav")}


def test_presets_lists_all(capsys):
    run("presets")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    # the JAX package's 11 and BS-RoFormer's
    assert len(lines) == 12
    assert any(ln.startswith("full_44KHz") for ln in lines)
    assert any(ln.startswith("bs_roformer") and "net=bs_roformer" in ln
               for ln in lines)


def test_no_command_exits_2():
    with pytest.raises(SystemExit) as e:
        cli.main([])
    assert e.value.code == 2


def test_unknown_preset_is_config_error(capsys):
    with pytest.raises(SystemExit) as e:
        run("train", "nonesuch_preset")
    assert e.value.code == 2
    assert "error:" in capsys.readouterr().err


def test_predict_requires_input_path():
    with pytest.raises(SystemExit) as e:
        run("predict", "baseline")
    assert e.value.code == 2


@pytest.mark.parametrize("opt,message", [
    ("coordinator=host0:1234", "coordinator= needs num_processes="),
    ("num_processes=2", "num_processes=2 needs coordinator="),
    # process_id alone runs one process, as in the JAX package: on to the
    # evaluation's own error
    ("process_id=0", "no checkpoint given")])
def test_pod_options_name_the_multi_gpu_slice(opt, message, capsys):
    with pytest.raises(SystemExit) as e:
        run("evaluate", "baseline", opt)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert message in err
    assert ("pod options" in err) == (opt != "process_id=0")


def test_train_wrote_checkpoint_and_metrics(cli_env):
    root = cli_env["root"]
    assert os.path.exists(root / "logs" / "clitest" / "metrics.jsonl")
    assert os.path.exists(root / "logs" / "clitest" / "config.json")


def test_predict_cli_equals_the_library_call(cli_env, tmp_path):
    """The command's WAVs are ``separate_file``'s, byte for byte."""
    from waveunet_tpu_torch.infer.engine import separate_file
    from waveunet_tpu_torch.train.checkpoint import restore_checkpoint

    run("predict", "baseline", *cli_env["args"],
        f"input_path={cli_env['mix']}", f"checkpoint={cli_env['best']}",
        f"output_path={tmp_path / 'cli'}")
    cfg = config_from_cli(["baseline"] + cli_env["args"])
    params = restore_checkpoint(cli_env["best"])["params"]
    separate_file(cfg, params, cli_env["mix"],
                  output_path=str(tmp_path / "lib"), device="cpu")
    n = load(cli_env["mix"], sr=None, mono=False)[0].shape[0]
    for s in ("vocals", "accompaniment"):
        got = tmp_path / "cli" / f"mixture.wav_{s}.wav"
        assert got.read_bytes() == \
            (tmp_path / "lib" / f"mixture.wav_{s}.wav").read_bytes()
        y, sr = load(str(got), sr=None, mono=False)
        assert sr == _SR and y.shape[0] == n


def test_predict_cli_checkpoint_auto(cli_env, tmp_path, capsys):
    root = cli_env["root"]
    for extra in (["experiment_id=clitest"], []):
        run("predict", "baseline", *cli_env["args"],
            f"input_path={cli_env['mix']}", "checkpoint=auto",
            f"output_path={tmp_path}", *extra)
        out = capsys.readouterr().out
        assert "checkpoint=auto -> " in out
        assert str(root / "ckpts" / "clitest") in out
    assert (tmp_path / "mixture.wav_vocals.wav").exists()


def test_predict_checkpoint_auto_empty_is_error(cli_env, tmp_path):
    with pytest.raises(SystemExit) as e:
        run("predict", "baseline", *cli_env["args"],
            f"input_path={cli_env['mix']}", "checkpoint=auto",
            f"model_base_dir={tmp_path / 'nothing'}")
    assert e.value.code == 2


def test_predict_cli_checkpoint_best(cli_env, tmp_path, capsys):
    for extra in (["experiment_id=clitest"], []):
        run("predict", "baseline", *cli_env["args"],
            f"input_path={cli_env['mix']}", "checkpoint=best",
            f"output_path={tmp_path}", *extra)
        assert f"checkpoint=best -> {cli_env['best']}" in \
            capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        run("predict", "baseline", *cli_env["args"],
            f"input_path={cli_env['mix']}", "checkpoint=best",
            f"model_base_dir={tmp_path / 'nothing'}")
    assert e.value.code == 2


def test_checkpoint_best_dangling_newest_is_error(cli_env, tmp_path):
    """The newest experiment's best.txt names a removed directory: an
    error, not a silent fall back to an older experiment's best."""
    base = tmp_path / "ckpts2"
    old = base / "older"
    old.mkdir(parents=True)
    kept = old / os.path.basename(cli_env["best"])
    shutil.copytree(cli_env["best"], kept)
    (old / "best.txt").write_text(str(kept) + "\n")
    time.sleep(0.05)
    new = base / "newer"
    new.mkdir()
    (new / "best.txt").write_text(str(new / "step_0000000099") + "\n")
    os.utime(new / "best.txt")
    with pytest.raises(SystemExit) as e:
        run("predict", "baseline", *cli_env["args"],
            f"input_path={cli_env['mix']}", "checkpoint=best",
            f"model_base_dir={base}", f"output_path={tmp_path}")
    assert e.value.code == 2


def test_no_checkpoint_is_error_unless_random_init(cli_env, tmp_path,
                                                   capsys):
    for cmd, extra in (("predict", [f"input_path={cli_env['mix']}"]),
                       ("evaluate", ["subset=test"]),
                       ("stream", [f"input_path={cli_env['mix']}"])):
        with pytest.raises(SystemExit) as e:
            run(cmd, "baseline", *cli_env["args"], *extra,
                f"output_path={tmp_path}")
        assert e.value.code == 2
        assert "no checkpoint given" in capsys.readouterr().err
    run("predict", "baseline", *cli_env["args"],
        f"input_path={cli_env['mix']}", "random_init=1",
        f"output_path={tmp_path}")
    assert "WARNING: no checkpoint" in capsys.readouterr().out


def test_evaluate_cli_equals_the_library_call(cli_env, tmp_path):
    """``evaluate`` with ``random_init=1`` and the fp32 device scorer writes
    the JSON that ``evaluate_musdb`` writes for the same seeded weights."""
    from waveunet_tpu_torch.eval.harness import evaluate_musdb
    from waveunet_tpu_torch.train.loop import init_state

    run("evaluate", "baseline", *cli_env["args"], "random_init=1",
        "subset=test", f"output_path={tmp_path / 'cli'}", "max_tracks=1",
        "tpu_bss=1")
    cfg = config_from_cli(["baseline"] + cli_env["args"])
    evaluate_musdb(cfg, init_state(cfg, device="cpu").params,
                   output_path=str(tmp_path / "lib"), max_tracks=1,
                   tpu_bss=True, device="cpu")
    got = (tmp_path / "cli" / "test" / "songC.json").read_bytes()
    assert got == (tmp_path / "lib" / "test" / "songC.json").read_bytes()
    names = {t["name"] for t in json.loads(got)["targets"]}
    assert names == {"vocals", "accompaniment"}


def test_evaluate_cli_checkpoint_and_host_scorer(cli_env, tmp_path):
    run("evaluate", "baseline", *cli_env["args"],
        f"checkpoint={cli_env['best']}", "subset=test",
        f"output_path={tmp_path}", "max_tracks=1", "self_check=0")
    rec = json.loads((tmp_path / "test" / "songC.json").read_text())
    assert {t["name"] for t in rec["targets"]} == {"vocals", "accompaniment"}


def test_stream_cli(cli_env, tmp_path):
    run("stream", "baseline", *cli_env["args"],
        f"input_path={cli_env['mix']}", f"checkpoint={cli_env['best']}",
        "chunk_ms=100", "batch_windows=2", f"output_path={tmp_path}")
    n = load(cli_env["mix"], sr=None, mono=False)[0].shape[0]
    for s in ("vocals", "accompaniment"):
        y, sr = load(str(tmp_path / f"mixture.wav_{s}_stream.wav"), sr=None,
                     mono=False)
        assert sr == _SR and y.shape[0] == n


def test_warmup_cli_needs_the_card(cli_env, capsys):
    """warmup captures CUDA graphs: on the CPU it says so and exits 2."""
    with pytest.raises(SystemExit) as e:
        run("warmup", "baseline", *cli_env["args"],
            f"checkpoint={cli_env['best']}", "max_song_s=2")
    assert e.value.code == 2
    assert "CUDA graphs" in capsys.readouterr().err


def test_profile_cli(cli_env, tmp_path, capsys):
    run("profile", "baseline", *cli_env["args"],
        f"checkpoint={cli_env['best']}", f"output_path={tmp_path}")
    trace = tmp_path / "separate_trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    out = capsys.readouterr().out
    assert "span separate.stitch:" in out
    assert "counter separate.windows:" in out


def test_profile_cli_shows_bs_roformer_parts(tmp_path, capsys):
    """The profiled separation runs the forward eagerly, so BS-RoFormer's
    own spans show beside the engine's; the difference source comes from
    the chunk program (the float32 wire), counted, with no host span."""
    run("profile", "bs_roformer", "dim=16", "depth=2", "heads=2",
        "dim_head=8", "stft_n_fft=64", "stft_hop=16",
        "freqs_per_bands=[4,4,4,4,8,9]", "num_frames=22050",
        "random_init=1", f"output_path={tmp_path}")
    out = capsys.readouterr().out
    for part in ("stft", "band_split", "time_layer", "band_layer", "mask",
                 "istft"):
        assert f"span roformer.{part}:" in out
    assert "  counter separate.device_difference: 1" in out.splitlines()
    assert "span separate.difference:" not in out


def test_prepare_data_cli(cli_env, tmp_path, capsys):
    """prepare-data builds a cache from a WAV-layout MUSDB."""
    db = tmp_path / "db"
    rng = np.random.default_rng(0)
    for part, songs in (("train", ("a", "b")), ("test", ("c",))):
        for song in songs:
            d = db / part / song
            d.mkdir(parents=True)
            stems = {s: (0.1 * rng.standard_normal((_SR, 2))).astype(
                np.float32) for s in ("vocals", "accompaniment")}
            for s, v in stems.items():
                write_wav(str(d / f"{s}.wav"), v, _SR)
            write_wav(str(d / "mixture.wav"), sum(stems.values()), _SR)
    run("prepare-data", "baseline", *_CFG_ARGS,
        f"data_path={tmp_path / 'cache2'}", f"musdb_path={db}",
        "num_val_songs=1", f"ccmixter_xml={tmp_path / 'none.xml'}")
    assert "Cache ready" in capsys.readouterr().out


def test_convert_checkpoint_cli(tmp_path, capsys):
    """A reference TF checkpoint -> the port's checkpoint via the command,
    then predict with it: the WAVs of predicting from the TF checkpoint."""
    if not os.path.exists(_GOLDEN + ".index"):
        pytest.skip("golden TF checkpoint missing")
    run("convert-checkpoint", "baseline", *_CONV_ARGS,
        f"checkpoint={_GOLDEN}", f"output_path={tmp_path}")
    conv = capsys.readouterr().out.strip().splitlines()[-1].split(
        "written to ")[-1]
    sr = get_config("baseline").expected_sr
    mix = (0.1 * np.random.default_rng(0).standard_normal((sr, 1))
           ).astype(np.float32)
    src = str(tmp_path / "m.wav")
    write_wav(src, mix, sr)
    for ck, out in ((conv, "out"), (_GOLDEN, "out_tf")):
        run("predict", "baseline", *_CONV_ARGS, f"input_path={src}",
            f"checkpoint={ck}", f"output_path={tmp_path / out}")
    a = (tmp_path / "out" / "m.wav_vocals.wav").read_bytes()
    assert a == (tmp_path / "out_tf" / "m.wav_vocals.wav").read_bytes()


def test_platform_fragment_is_consumed(cli_env, tmp_path, capsys):
    """``platform=`` is taken wherever it stands and is not a Config key;
    an unknown platform exits 2."""
    cli.main(["predict", "platform=cpu", "baseline", *cli_env["args"],
              f"input_path={cli_env['mix']}",
              f"checkpoint={cli_env['best']}", f"output_path={tmp_path}"])
    assert (tmp_path / "mixture.wav_vocals.wav").exists()
    with pytest.raises(SystemExit) as e:
        cli.main(["predict", "baseline", "platform=tpu",
                  f"input_path={cli_env['mix']}", "random_init=1"])
    assert e.value.code == 2
    assert "platform" in capsys.readouterr().err


def test_figures_cli(cli_env, tmp_path, capsys):
    run("evaluate", "baseline", *cli_env["args"],
        f"checkpoint={cli_env['best']}", "subset=test",
        f"output_path={tmp_path}", "max_tracks=1", "tpu_bss=1",
        "self_check=0")
    mix = str(tmp_path / "mixture.wav")
    shutil.copy(cli_env["mix"], mix)
    violin = tmp_path / "sdr.png"
    run("figures", f"results_dir={tmp_path / 'test'}",
        f"output_path={violin}", f"input_path={mix}")
    out = capsys.readouterr().out
    assert violin.exists() and violin.stat().st_size > 0
    assert os.path.exists(str(tmp_path / "mixture_spec.png"))
    assert "figure written" in out
    for argv in (["figures"], ["figures", f"results_dir={tmp_path / 'test'}",
                               f"outputpath={violin}"]):
        with pytest.raises(SystemExit) as e:
            run(*argv)
        assert e.value.code == 2


def test_train_checkpoint_auto_resumes_across_experiments(cli_env, tmp_path,
                                                          capsys):
    args = [a for a in cli_env["args"]
            if not a.startswith(("model_base_dir=", "log_dir="))]
    args += [f"model_base_dir={tmp_path / 'ckpts'}",
             f"log_dir={tmp_path / 'logs'}"]
    run("train", "baseline", *args, "experiment_id=first", "max_epochs=1")
    capsys.readouterr()
    run("train", "baseline", *args, "checkpoint=auto", "max_epochs=1")
    out = capsys.readouterr().out
    assert "auto-resume: " in out and "fresh start" not in out
    assert os.path.join("ckpts", "first") in out.split(
        "auto-resume: ", 1)[1].splitlines()[0]


def test_zoo_checkpoint_resolver(tmp_path):
    cfg = get_config("full_44KHz", model_base_dir=str(tmp_path))
    assert cli._resolve_zoo_tf_checkpoint(cfg, "full_44KHz") is None
    d = tmp_path / "full_44KHz"
    d.mkdir()
    for step in (1000, 236118, 5):
        (d / f"full_44KHz-{step}.index").touch()
        (d / f"full_44KHz-{step}.data-00000-of-00001").touch()
    (d / "checkpoint").touch()
    (d / "full_44KHz-bad.index").touch()
    assert cli._resolve_zoo_tf_checkpoint(cfg, "full_44KHz") == \
        str(d / "full_44KHz-236118")


def test_predict_zoo_default_end_to_end(tmp_path, capsys):
    if not os.path.exists(_GOLDEN + ".index"):
        pytest.skip("golden TF checkpoint missing")
    zoo = tmp_path / "zoo" / "baseline"
    zoo.mkdir(parents=True)
    shutil.copy(_GOLDEN + ".index", zoo / "baseline-1000.index")
    shutil.copy(_GOLDEN + ".data-00000-of-00001",
                zoo / "baseline-1000.data-00000-of-00001")
    sr = get_config("baseline").expected_sr
    mix = (0.1 * np.random.default_rng(0).standard_normal((sr, 1))
           ).astype(np.float32)
    src = str(tmp_path / "m.wav")
    write_wav(src, mix, sr)
    for extra in ([], ["random_init=0"]):
        out_dir = tmp_path / ("out_ri0" if extra else "out")
        run("predict", "baseline", *_CONV_ARGS, *extra, f"input_path={src}",
            f"model_base_dir={tmp_path / 'zoo'}", f"output_path={out_dir}")
        assert "using zoo checkpoint" in capsys.readouterr().out
        y, ysr = load(str(out_dir / "m.wav_vocals.wav"), sr=None, mono=False)
        assert ysr == sr and y.shape[0] == mix.shape[0]
