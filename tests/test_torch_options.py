"""A sweep of the Config options that change inference, one value at a
time, the port against the JAX package on the CPU.

From a tiny base of each family (Wave-U-Net: baseline at 3 layers and 4
filters; U7: 3 layers and 4 filters) one field at a time takes each of its
values. Both packages then build the model (their own init, which may
refuse the config) and run the inference forward on the same seeded
parameters and mixture; ``infer_wire_dtype`` runs ``Separator.separate``,
since the wire lies outside the forward. Either both raise, or both succeed
and agree: fp32 within 2e-5 (Wave-U-Net) and 5e-5 (U7), bf16 within the
JAX package's own bounds, -45 dB for Wave-U-Net
(tests/test_model_waveunet.py) and 5e-3 for U7 (tests/test_spectrogram.py),
and every bf16 case differs from the port's fp32 output by more than 1e-5.
The int16 wire adds one int16 step. A sweep by behaviour finds a refusal
that a comparison of public names cannot see.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.config import get_config as jax_get_config
from waveunet_tpu.infer.engine import Separator as JaxSeparator
from waveunet_tpu.models import spectrogram_unet as jax_su
from waveunet_tpu.models import waveunet as jax_wu
from waveunet_tpu.ops import shapes as jax_shapes

from waveunet_tpu_torch.compat.params import params_from_numpy
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.infer.engine import Separator
from waveunet_tpu_torch.models import spectrogram_unet as su
from waveunet_tpu_torch.models import waveunet as wu
from waveunet_tpu_torch.ops import shapes
from torch_cpu import few_threads  # noqa: F401

BASES = {
    "waveunet": ("baseline", dict(num_layers=3, num_initial_filters=4,
                                  num_frames=256, infer_batch=2,
                                  infer_num_frames=None)),
    "u7": ("unet_spectrogram", dict(num_layers=3, num_initial_filters=4,
                                    num_frames=768 * 7 + 1024,
                                    infer_batch=2, infer_num_frames=None)),
}
FIELDS = {
    "compute_dtype": ["float32", "bfloat16"],
    "conv_precision": [None, "default", "high", "highest"],
    "decimate_lowering": ["dilate", "slice"],
    "upsampling": ["linear", "learned"],
    "context": [False, True],
    "output_type": ["direct", "difference"],
    "output_activation": ["tanh", "linear"],
    "mono_downmix": [True, False],
    "infer_wire_dtype": ["float32", "int16"],
}
FP32_ATOL = {"waveunet": 2e-5, "u7": 5e-5}
WAVEUNET_BF16_DB = -45.0
U7_BF16_ATOL = 5e-3
DIFFERS = 1e-5
WIRE_STEP = 1.0 / 32767
CASES = [(family, field, value) for family in BASES
         for field, values in FIELDS.items() for value in values]


def _configs(family, **over):
    preset, kw = BASES[family]
    return (jax_get_config(preset, **kw, **over),
            get_config(preset, **kw, **over))


def _jax_model(family, jcfg):
    """JAX's init of ``jcfg`` (it may refuse), as numpy: (params, state)
    with its biases, interpolation weights and statistics perturbed so that
    every parameter kind reaches the output."""
    key = jax.random.PRNGKey(0)
    if family == "waveunet":
        p, st = jax_wu.init_waveunet(key, jcfg), {}
    else:
        p, st = jax_su.init_spectrogram_unet(key, jcfg)
    rng = np.random.default_rng(0)

    def perturb(tree, fn=lambda a: a):
        return {k: {n: np.asarray(a) if n == "kernel" else fn(
            np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
                np.float32)) for n, a in leaves.items()}
            for k, leaves in tree.items()}
    return perturb(p), perturb(st, np.abs)


def _port_init(family, cfg):
    gen = torch.Generator().manual_seed(0)
    if family == "waveunet":
        wu.init_waveunet(gen, cfg, "cpu")
    else:
        su.init_spectrogram_unet(gen, cfg, "cpu")


def _jax_run(family, field, jcfg, p, st, mix, audio):
    if field == "infer_wire_dtype":
        return JaxSeparator(jcfg, jax.tree_util.tree_map(jnp.asarray, p),
                            model_state=jax.tree_util.tree_map(
                                jnp.asarray, st)).separate(
            audio, jcfg.expected_sr)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    if family == "waveunet":
        out = jax_wu.apply_waveunet(jp, jcfg, jnp.asarray(mix),
                                    training=False)
    else:
        out, _ = jax_su.apply_spectrogram_unet(
            jp, jcfg, jnp.asarray(mix), training=False,
            state=jax.tree_util.tree_map(jnp.asarray, st))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_run(family, field, cfg, p, st, mix, audio):
    tp, tst = params_from_numpy(p, "cpu"), params_from_numpy(st, "cpu")
    if field == "infer_wire_dtype":
        return Separator(cfg, tp, model_state=tst, device="cpu").separate(
            audio, cfg.expected_sr)
    if family == "waveunet":
        out = wu.apply_waveunet(tp, cfg, torch.from_numpy(mix))
    else:
        out, _ = su.apply_spectrogram_unet(tp, cfg, torch.from_numpy(mix),
                                           state=tst)
    return {k: v.numpy() for k, v in out.items()}


def _outcome(fn):
    try:
        return fn(), None
    except (NotImplementedError, ValueError, AssertionError) as e:
        return None, e


@pytest.mark.parametrize("family,field,value", CASES,
                         ids=[f"{f}-{k}-{v}" for f, k, v in CASES])
def test_option_agrees_or_both_refuse(family, field, value):
    jcfg, cfg = _configs(family, **{field: value})
    model, jerr = _outcome(lambda: _jax_model(family, jcfg))
    _, perr = _outcome(lambda: _port_init(family, cfg))
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    assert (in_len, out_len) == jax_shapes.get_padding(jcfg,
                                                       jcfg.num_frames)
    rng = np.random.default_rng(1)
    mix = (0.3 * rng.standard_normal((2, in_len, cfg.num_channels))
           ).astype(np.float32)
    audio = (0.2 * rng.standard_normal((3 * cfg.num_frames + 77, 2))
             ).astype(np.float32)
    # both build the model, or both refuse to; then both run, or both raise
    assert (jerr is None) == (perr is None), (jerr, perr)
    if jerr is None:
        want, jerr = _outcome(lambda: _jax_run(family, field, jcfg, *model,
                                               mix, audio))
        got, perr = _outcome(lambda: _port_run(family, field, cfg, *model,
                                               mix, audio))
        assert (jerr is None) == (perr is None), (jerr, perr)
    if jerr is not None:
        return
    assert sorted(got) == sorted(want)
    for s in want:
        assert got[s].shape == want[s].shape, s
    wire = WIRE_STEP if cfg.infer_wire_dtype == "int16" else 0.0
    if cfg.compute_dtype != "bfloat16":
        for s in want:
            np.testing.assert_allclose(got[s], want[s], rtol=0,
                                       atol=FP32_ATOL[family] + wire,
                                       err_msg=s)
        return
    for s in want:
        if family == "waveunet":
            err_db = 10 * np.log10(np.sum((got[s] - want[s]) ** 2)
                                   / np.sum(want[s] ** 2))
            assert err_db <= WAVEUNET_BF16_DB, (s, err_db)
        else:
            assert float(np.abs(got[s] - want[s]).max()) <= U7_BF16_ATOL, s
    fp32 = _port_run(family, field, cfg.replace(compute_dtype="float32"),
                     *model, mix, audio)
    assert max(float(np.abs(got[s] - fp32[s]).max()) for s in got) \
        > DIFFERS
