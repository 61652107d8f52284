"""waveunet_tpu_torch — the PyTorch/CUDA port of waveunet_tpu.

The JAX package ``waveunet_tpu`` stays the reference; this package imports
nothing from it (nor JAX) and keeps its own copies of what it needs. Its
entry points run on the CUDA card unless the caller passes ``device="cpu"``.
Every conv + LeakyReLU and learned interpolation of the inference forward
runs in hand-written CUDA kernels (``ops/kernels/``) on the card.

The serving surface: ``Separator``, whose ``separate`` is the one path every
caller takes (song and slab modes, CUDA graphs from ``precompile``),
``StreamingSeparator``, three model families (Wave-U-Net, the U7
spectrogram U-Net and BS-RoFormer, which is served but not trained) and
TensorFlow-free checkpoint loaders. The benchmark that measures the port on
the card is ``python3 -m benchmark.run`` (``benchmark/``). Training:
``optimise`` (two early-stopped rounds, checkpoints, resume),
``init_state``, and the device-resident data banks ``DeviceBank`` and
``EvalBank``; the training
step runs plain differentiable ops, validation runs through the kernels.
Evaluation: ``evaluate_musdb`` (``eval/``: the host fp64 BSS-Eval scorer,
the fp32 and fp64 device scorers). The command line: ``python -m
waveunet_tpu_torch <command>`` (``cli.py``). Several cards: one process a
card joined by ``torch.distributed`` (``parallel/``), with ``make_mesh``
over the ranks for data-parallel training of the Wave-U-Net and U7
(``optimise``, the sharded bank ``ShardedBank``; U7's batch norm takes its
statistics over every rank's rows), window-parallel ``Separator`` and
``evaluate_musdb``, and ``dryrun_multichip``, the multi-process dry run on
the CPU. Also: ``resample_device`` (the polyphase
resampler on the card), MPEG audio through ``data.audio_io.load``
(libmpg123), the reference's ``Utils`` names in
``waveunet_tpu_torch.utils``, and the trained-quality tool ``python -m
waveunet_tpu_torch.tools.quality``.

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
    "ShardedBank": "waveunet_tpu_torch.data.device_cache",
    "Mesh": "waveunet_tpu_torch.parallel.mesh",
    "make_mesh": "waveunet_tpu_torch.parallel.mesh",
    "dryrun_multichip": "waveunet_tpu_torch.parallel.dryrun",
    "resample_device": "waveunet_tpu_torch.ops.resample",
}

__all__ = ["Config", "get_config", "preset_names", *_LAZY, "__version__"]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'waveunet_tpu_torch' has no attribute {name!r}")
