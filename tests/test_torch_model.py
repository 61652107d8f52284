"""The port's Wave-U-Net forward against the JAX package's, on the CPU.

Same parameters (made with numpy from a seed, moved into the port through
``params_from_numpy``) and the same mixture on both sides; tolerance 2e-5,
the reference's own (tests/test_compat.py). The port runs its kernels' plain
versions here, since the tensors lie on the CPU.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.config import get_config as jax_get_config
from waveunet_tpu.config import preset_names as jax_preset_names
from waveunet_tpu.models.waveunet import apply_waveunet as jax_apply
from waveunet_tpu.models.waveunet import init_waveunet as jax_init
from waveunet_tpu.models.waveunet import io_shapes as jax_io_shapes

from waveunet_tpu_torch.compat.params import params_from_numpy, params_to_numpy
from waveunet_tpu_torch.config import get_config, preset_names
from waveunet_tpu_torch.models.waveunet import (apply_waveunet, init_waveunet,
                                                io_shapes)

FORWARD_ATOL = 2e-5

_WAVEUNET_PRESETS = [n for n in preset_names()
                     if get_config(n).network == "unet"]

_SMALL = {
    # full_44KHz shrunk to 4 layers and 8 filters (context, learned, stereo)
    "full_44khz_small": ("full_44KHz", dict(num_layers=4,
                                            num_initial_filters=8,
                                            num_frames=1024)),
    # a same-padded preset: linear upsampling, direct output, mono
    "baseline_small": ("baseline", dict(num_layers=3, num_initial_filters=6,
                                        num_frames=512)),
    # even filter widths in same padding (asymmetric explicit pads)
    "same_evenfilter": ("baseline", dict(num_layers=3, num_frames=512,
                                         filter_size=16, merge_filter_size=6,
                                         num_initial_filters=6)),
    # four sources, difference output, linear upsampling with context
    "multi_instrument_small": ("full_multi_instrument", dict(
        num_layers=3, num_initial_filters=6, num_frames=512)),
    # same-padded learned upsampling with a linear (clipped) output
    "same_learned_linear": ("baseline", dict(
        num_layers=3, num_initial_filters=6, num_frames=512,
        upsampling="learned", output_activation="linear")),
}


def numpy_params(cfg, seed=0):
    """Parameters of ``cfg``'s shapes drawn with numpy: glorot-scale
    kernels, small non-zero biases, interpolation weights around 0."""
    shapes = {layer: {n: tuple(t.shape) for n, t in leaves.items()}
              for layer, leaves in init_waveunet(
                  torch.Generator().manual_seed(0), cfg, "cpu").items()}
    rng = np.random.default_rng(seed)
    params = {}
    for layer, leaves in shapes.items():
        params[layer] = {}
        for name, shape in leaves.items():
            if name == "kernel":
                lim = np.sqrt(6.0 / (shape[0] * (shape[1] + shape[2])))
                a = rng.uniform(-lim, lim, shape)
            elif name == "bias":
                a = 0.05 * rng.standard_normal(shape)
            else:
                a = rng.uniform(-1.0, 1.0, shape)
            params[layer][name] = a.astype(np.float32)
    return params


# What the port has and the JAX package has not: the BS-RoFormer network,
# its preset and its fields (models/bs_roformer.py).
PORT_ONLY_PRESETS = {"bs_roformer"}
PORT_ONLY_FIELDS = {"dim", "depth", "heads", "dim_head", "ff_mult",
                    "stft_n_fft", "stft_hop", "freqs_per_bands"}


def test_presets_round_trip_between_packages():
    """Every preset of the JAX package is the port's, field for field; the
    port adds BS-RoFormer's preset and fields alone."""
    assert set(preset_names()) - set(jax_preset_names()) == PORT_ONLY_PRESETS
    assert set(jax_preset_names()) <= set(preset_names())
    for name in jax_preset_names():
        port = get_config(name).to_dict()
        jax_side = jax_get_config(name).to_dict()
        assert set(port) - set(jax_side) == PORT_ONLY_FIELDS
        assert {k: port[k] for k in jax_side} == jax_side


@pytest.mark.parametrize("preset", _WAVEUNET_PRESETS)
def test_init_and_io_shapes_match_jax(preset):
    cfg, jcfg = get_config(preset), jax_get_config(preset)
    assert io_shapes(cfg) == jax_io_shapes(jcfg)
    got = init_waveunet(torch.Generator().manual_seed(0), cfg, device="cpu")
    got_shapes = {layer: {n: tuple(t.shape) for n, t in leaves.items()}
                  for layer, leaves in got.items()}
    assert all(t.dtype == torch.float32
               for leaves in got.values() for t in leaves.values())
    # JAX's init cannot be shape-traced with learned upsampling (it takes a
    # float() of a jnp value), so the learned presets compare against their
    # linear twin plus one interp_i per up level, with one weight per
    # channel of the map it upsamples.
    learned = cfg.upsampling == "learned"
    twin = jcfg.replace(upsampling="linear") if learned else jcfg
    want = jax.eval_shape(lambda k: jax_init(k, twin), jax.random.PRNGKey(0))
    want_shapes = {}
    for layer, leaves in want.items():
        if learned and layer.startswith("up_"):
            i = int(layer[3:])
            skip = want[f"down_{cfg.num_layers - 1 - i}"]["kernel"].shape[2]
            want_shapes[f"interp_{i}"] = {
                "weights": (leaves["kernel"].shape[1] - skip,)}
        want_shapes[layer] = {n: tuple(s.shape) for n, s in leaves.items()}
    assert got_shapes == want_shapes


@pytest.mark.parametrize("case", sorted(_SMALL))
def test_forward_matches_jax(case):
    preset, kw = _SMALL[case]
    jcfg, cfg = jax_get_config(preset, **kw), get_config(preset, **kw)
    in_len, out_len = io_shapes(cfg)
    params = numpy_params(cfg)
    mix = (0.5 * np.random.default_rng(1).standard_normal(
        (2, in_len, cfg.num_channels))).astype(np.float32)
    want = jax_apply(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                     jnp.asarray(mix), training=False)
    got = apply_waveunet(params_from_numpy(params, "cpu"), cfg,
                         torch.from_numpy(mix))
    assert list(got) == list(want)
    for name in cfg.source_names:
        assert got[name].shape == (2, out_len, cfg.num_channels)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=FORWARD_ATOL, err_msg=name)


def test_golden_context_learned_diff_stereo():
    """The reference code's own output (tests/golden/waveunet_ref), through
    the checkpoint the JAX package loads, at the reference's 2e-5."""
    from waveunet_tpu.compat.tf_checkpoint import load_tf_waveunet

    gdir = os.path.join(os.path.dirname(__file__), "golden", "waveunet_ref")
    case = "context_learned_diff_stereo"
    kw = dict(num_layers=3, num_frames=512, num_initial_filters=8)
    jparams = load_tf_waveunet(os.path.join(gdir, case, "model.ckpt"),
                               jax_get_config("full", **kw))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    z = np.load(os.path.join(gdir, f"{case}.npz"))
    cfg = get_config("full", **kw)
    got = apply_waveunet(params, cfg, torch.from_numpy(z["mix"]))
    for name in cfg.source_names:
        want = z[f"out_{name}"]
        assert got[name].shape == want.shape
        np.testing.assert_allclose(got[name].numpy(), want, atol=FORWARD_ATOL,
                                   err_msg=name)


def test_params_round_trip():
    params = numpy_params(get_config("full", num_layers=2,
                                     num_initial_filters=4))
    back = params_to_numpy(params_from_numpy(params, "cpu"))
    assert list(back) == list(params)
    for layer, leaves in params.items():
        for name, a in leaves.items():
            np.testing.assert_array_equal(back[layer][name], a)


def test_inference_only():
    """The inference forward builds no autograd graph, even for parameters
    that require grad (the kernels have no backward); the training forward
    (tests/test_torch_train_step.py) is the differentiable one, and an
    unported network raises."""
    cfg = get_config("full", num_layers=2, num_initial_filters=4)
    params = init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")
    for leaves in params.values():
        for t in leaves.values():
            t.requires_grad_(True)
    mix = torch.zeros(1, 300, 2)
    assert all(v.grad_fn is None
               for v in apply_waveunet(params, cfg, mix).values())
    assert all(v.grad_fn is not None for v in apply_waveunet(
        params, cfg, mix, training=True).values())
    with pytest.raises(NotImplementedError):
        apply_waveunet(params, cfg.replace(network="unet_spectrogram"), mix)


# -- the analytic FLOP count of chip_smoke.py (phase train's rates) ----------

def test_flagship_flops_match_the_recorded_window_cost():
    """37.48 GFLOP per 65,536-frame window (PERF.md section 4), 25.2 GFLOP
    per audio-second, against the JAX bench's cost-analysis 25.3."""
    import chip_smoke
    from waveunet_tpu_torch.ops import shapes

    cfg = get_config("full_44KHz")
    in_len, out_len = shapes.get_padding(cfg, 65536)
    flops = chip_smoke.waveunet_conv_flops(cfg, in_len)
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
    import chip_smoke
    from waveunet_tpu_torch.models import waveunet as model

    cfg = get_config(preset, **kw)
    in_len, _ = io_shapes(cfg)
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
    params = init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")
    apply_waveunet(params, cfg, torch.zeros(1, in_len, cfg.num_channels))
    assert chip_smoke.waveunet_conv_flops(cfg, in_len) == sum(counted)
