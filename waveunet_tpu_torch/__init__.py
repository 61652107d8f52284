"""waveunet_tpu_torch — the PyTorch/CUDA port of waveunet_tpu.

The JAX package ``waveunet_tpu`` stays the reference; this package imports
nothing from it (nor JAX) and keeps its own copies of what it needs. Its
entry points run on the CUDA card unless the caller passes ``device="cpu"``.
Every conv + LeakyReLU and learned interpolation of the inference forward
runs in hand-written CUDA kernels (``ops/kernels/``) on the card.

The serving surface: ``Separator`` (song and slab modes, CUDA graphs from
``precompile``, the device-resident ``resident_sweep``),
``StreamingSeparator``, both model families (Wave-U-Net and the U7
spectrogram U-Net), TensorFlow-free checkpoint loaders and the bench
(``python -m waveunet_tpu_torch.bench``). Training: ``optimise`` (two
early-stopped rounds, checkpoints, resume), ``init_state``, and the
device-resident data banks ``DeviceBank`` and ``EvalBank``; the training
step runs plain differentiable ops, validation runs through the kernels.
Evaluation: ``evaluate_musdb`` (``eval/``: the host fp64 BSS-Eval scorer,
the fp32 and fp64 device scorers). The command line: ``python -m
waveunet_tpu_torch <command>`` (``cli.py``).

Importing the package loads only the configuration; the models, the engine
and the kernels load on first use.
"""

from waveunet_tpu_torch.config import Config, get_config, preset_names

__version__ = "0.1.0"

_LAZY = {
    "Separator": "waveunet_tpu_torch.infer.engine",
    "separate_file": "waveunet_tpu_torch.infer.engine",
    "StreamingSeparator": "waveunet_tpu_torch.infer.streaming",
    "init_waveunet": "waveunet_tpu_torch.models.waveunet",
    "apply_waveunet": "waveunet_tpu_torch.models.waveunet",
    "init_spectrogram_unet": "waveunet_tpu_torch.models.spectrogram_unet",
    "apply_spectrogram_unet": "waveunet_tpu_torch.models.spectrogram_unet",
    "load_tf_waveunet": "waveunet_tpu_torch.compat.tf_checkpoint",
    "load_tf_spectrogram": "waveunet_tpu_torch.compat.tf_checkpoint",
    "params_from_numpy": "waveunet_tpu_torch.compat.params",
    "params_to_numpy": "waveunet_tpu_torch.compat.params",
    "optimise": "waveunet_tpu_torch.train.loop",
    "init_state": "waveunet_tpu_torch.train.loop",
    "DeviceBank": "waveunet_tpu_torch.data.device_cache",
    "EvalBank": "waveunet_tpu_torch.data.device_cache",
    "evaluate_musdb": "waveunet_tpu_torch.eval.harness",
}

__all__ = ["Config", "get_config", "preset_names", *_LAZY, "__version__"]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'waveunet_tpu_torch' has no attribute {name!r}")
