"""What the PyTorch/CUDA port may import and where it may run.

The port imports neither JAX nor the JAX package, so it starts on a machine
that has neither. Its entry points run on the CUDA card unless the caller
asks for the CPU, and without a card they raise instead of running on the
host.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "waveunet_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_jax_package_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "waveunet_tpu", "flax", "optax"), (
            f"{os.path.relpath(path, ROOT)} imports {mod}")


def test_package_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['waveunet_tpu'] = None\n"
            "import waveunet_tpu_torch as w\n"
            "import waveunet_tpu_torch.infer.engine, "
            "waveunet_tpu_torch.models.waveunet, "
            "waveunet_tpu_torch.compat.params, "
            "waveunet_tpu_torch.data.audio_io, "
            "waveunet_tpu_torch.ops.kernels.build, "
            "waveunet_tpu_torch.train.loop, waveunet_tpu_torch.train.step, "
            "waveunet_tpu_torch.train.checkpoint, "
            "waveunet_tpu_torch.train.metrics, "
            "waveunet_tpu_torch.data.device_cache, "
            "waveunet_tpu_torch.data.pipeline, "
            "waveunet_tpu_torch.data.ingest, waveunet_tpu_torch.data.cache, "
            "waveunet_tpu_torch.data.sampler, waveunet_tpu_torch.cli, "
            "waveunet_tpu_torch.__main__, waveunet_tpu_torch.eval.bsseval, "
            "waveunet_tpu_torch.eval.aggregate, "
            "waveunet_tpu_torch.eval.bsseval_tpu, "
            "waveunet_tpu_torch.eval.bsseval_tpu64, "
            "waveunet_tpu_torch.eval.harness, waveunet_tpu_torch.eval.plot\n"
            "assert w.optimise is waveunet_tpu_torch.train.loop.optimise\n"
            "assert w.Separator is waveunet_tpu_torch.infer.engine.Separator\n"
            "assert not any(m.startswith(('jax', 'triton', 'matplotlib')) "
            "for m in sys.modules if sys.modules[m] is not None)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_kernel_sources_include_no_pytorch_header():
    from waveunet_tpu_torch.ops.kernels import build

    names = sorted(os.path.basename(s) for s in build.sources())
    assert names == ["conv1d_lrelu.cu", "conv1d_lrelu_im2col.cu",
                     "learned_interp.cu"]
    for src in build.sources():
        with open(src) as f:
            text = f.read()
        assert "torch/" not in text and "ATen" not in text, src
        assert 'extern "C"' in text and "cudaGetLastError" in text, src


def test_build_without_nvcc_raises(monkeypatch):
    from waveunet_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


@pytest.mark.parametrize("entry", ["init_waveunet", "params_from_numpy",
                                   "Separator", "separate_file",
                                   "StreamingSeparator",
                                   "init_spectrogram_unet",
                                   "load_tf_waveunet", "load_tf_spectrogram",
                                   "griffin_lim", "optimise", "init_state",
                                   "DeviceBank", "EvalBank",
                                   "make_train_step", "make_scanned_epoch",
                                   "make_eval_step", "evaluate_musdb",
                                   "bss_eval_framewise_tpu",
                                   "bss_eval_framewise_tpu64",
                                   "draw_spectrogram"])
def test_entry_points_without_a_card_raise(monkeypatch, tmp_path, entry):
    """No device argument means the card; without one they raise and do not
    fall back to the CPU."""
    import waveunet_tpu_torch as w
    from waveunet_tpu_torch.data.audio_io import write_wav
    from waveunet_tpu_torch.eval.bsseval_tpu import bss_eval_framewise_tpu
    from waveunet_tpu_torch.eval.bsseval_tpu64 import (
        bss_eval_framewise_tpu64)
    from waveunet_tpu_torch.eval.harness import evaluate_musdb
    from waveunet_tpu_torch.eval.plot import draw_spectrogram
    from waveunet_tpu_torch.ops.stft import griffin_lim
    from waveunet_tpu_torch.train.step import (make_eval_step,
                                               make_scanned_epoch,
                                               make_train_step)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = w.get_config("full", num_layers=2, num_initial_filters=4)
    params = w.init_waveunet(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    wav = str(tmp_path / "mix.wav")
    write_wav(wav, np.zeros((1000, 2), np.float32), 44100)
    refs = np.ones((2, 1000, 1), np.float32)
    calls = {
        "init_waveunet": lambda: w.init_waveunet(torch.Generator(), cfg),
        "params_from_numpy": lambda: w.params_from_numpy(
            w.params_to_numpy(params)),
        "Separator": lambda: w.Separator(cfg, params),
        "separate_file": lambda: w.separate_file(cfg, params, wav),
        "StreamingSeparator": lambda: w.StreamingSeparator(cfg, params),
        "init_spectrogram_unet": lambda: w.init_spectrogram_unet(
            torch.Generator(), w.get_config("unet_spectrogram")),
        "load_tf_waveunet": lambda: w.load_tf_waveunet(
            str(tmp_path / "missing.ckpt"), cfg),
        "load_tf_spectrogram": lambda: w.load_tf_spectrogram(
            str(tmp_path / "missing.ckpt"), w.get_config("unet_spectrogram")),
        "griffin_lim": lambda: griffin_lim(np.ones((4, 513), np.float32)),
        "optimise": lambda: w.optimise(cfg.replace(
            log_dir=str(tmp_path / "logs"))),
        "init_state": lambda: w.init_state(cfg),
        "DeviceBank": lambda: w.DeviceBank(cfg, "train", 100, 50),
        "EvalBank": lambda: w.EvalBank(cfg, "valid", 100, 50),
        "make_train_step": lambda: make_train_step(cfg, 1e-4),
        "make_scanned_epoch": lambda: make_scanned_epoch(
            cfg, 1e-4, 2, lambda key, step: {}),
        "make_eval_step": lambda: make_eval_step(cfg),
        "evaluate_musdb": lambda: evaluate_musdb(
            cfg, params, output_path=str(tmp_path / "logs")),
        "bss_eval_framewise_tpu": lambda: bss_eval_framewise_tpu(
            refs, refs, 1000),
        "bss_eval_framewise_tpu64": lambda: bss_eval_framewise_tpu64(
            refs, refs, 1000),
        "draw_spectrogram": lambda: draw_spectrogram(wav),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    assert not os.path.exists(str(tmp_path / "mix.wav_vocals.wav"))
    assert not os.path.exists(str(tmp_path / "logs"))


def test_wrappers_refuse_other_devices():
    from waveunet_tpu_torch.ops.kernels import conv1d_fused, interp

    x = torch.zeros(1, 8, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv1d_fused.conv1d_lrelu(x, torch.zeros(3, 2, 4, device="meta"),
                                  torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        interp.learned_interp(x, torch.zeros(2, device="meta"), True)


@pytest.mark.parametrize("command", ["predict", "evaluate", "stream",
                                     "profile", "train"])
def test_cli_without_a_card_exits_2(monkeypatch, tmp_path, capsys, command):
    """Without ``platform=cpu`` a command runs on the card; with none it
    exits 2 saying how to run on the host, before it touches any file."""
    from waveunet_tpu_torch import cli
    from waveunet_tpu_torch.data.audio_io import write_wav

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = str(tmp_path / "mix.wav")
    write_wav(wav, np.zeros((1000, 2), np.float32), 44100)
    with pytest.raises(SystemExit) as e:
        cli.main([command, "full", "num_layers=2", f"input_path={wav}",
                  "random_init=1", f"output_path={tmp_path / 'out'}",
                  f"log_dir={tmp_path / 'logs'}",
                  f"data_path={tmp_path / 'cache'}",
                  f"musdb_path={tmp_path / 'db'}"])
    assert e.value.code == 2
    assert "platform=cpu" in capsys.readouterr().err
    assert sorted(os.listdir(tmp_path)) == ["mix.wav"]
