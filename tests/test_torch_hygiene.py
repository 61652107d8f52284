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
            "waveunet_tpu_torch.ops.kernels.build\n"
            "assert w.Separator is waveunet_tpu_torch.infer.engine.Separator\n"
            "assert not any(m.startswith(('jax', 'triton')) "
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
                                   "griffin_lim"])
def test_entry_points_without_a_card_raise(monkeypatch, tmp_path, entry):
    """No device argument means the card; without one they raise and do not
    fall back to the CPU."""
    import waveunet_tpu_torch as w
    from waveunet_tpu_torch.data.audio_io import write_wav
    from waveunet_tpu_torch.ops.stft import griffin_lim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = w.get_config("full", num_layers=2, num_initial_filters=4)
    params = w.init_waveunet(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    wav = str(tmp_path / "mix.wav")
    write_wav(wav, np.zeros((1000, 2), np.float32), 44100)
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
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    assert not os.path.exists(str(tmp_path / "mix.wav_vocals.wav"))


def test_wrappers_refuse_other_devices():
    from waveunet_tpu_torch.ops.kernels import conv1d_fused, interp

    x = torch.zeros(1, 8, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv1d_fused.conv1d_lrelu(x, torch.zeros(3, 2, 4, device="meta"),
                                  torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        interp.learned_interp(x, torch.zeros(2, device="meta"), True)
