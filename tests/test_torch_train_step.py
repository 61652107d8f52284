"""The port's training side against the JAX package's, on the CPU.

The same parameters and batches (made with numpy from a seed) go through
both packages: the training forward at 2e-5 (the reference's forward
tolerance), one step's loss at 2e-5 relative and every gradient within
1e-4 of its tensor's largest magnitude (fp32 sums in another order, through
a backward of up to 16 layers), and Adam against optax. The hand-written
kernels' wrappers refuse autograd, on the CPU as on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from waveunet_tpu.config import get_config as jax_get_config
from waveunet_tpu.models import spectrogram_unet as jax_su
from waveunet_tpu.models.waveunet import apply_waveunet as jax_apply
from waveunet_tpu.train.step import make_loss_fn as jax_make_loss_fn

from waveunet_tpu_torch.compat.params import (adam_state_from_numpy,
                                              adam_state_to_numpy,
                                              params_from_numpy,
                                              params_to_numpy)
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.models import spectrogram_unet as su
from waveunet_tpu_torch.models.waveunet import apply_waveunet, init_waveunet
from waveunet_tpu_torch.ops import shapes
from waveunet_tpu_torch.ops.kernels import conv1d_fused, conv1d_im2col, interp
from waveunet_tpu_torch.train.step import (Adam, make_loss_fn,
                                           make_train_step, value_and_grad)
from torch_cpu import few_threads  # noqa: F401

FORWARD_ATOL = 2e-5
LOSS_RTOL = 2e-5
GRAD_TOL = 1e-4  # of each gradient tensor's largest magnitude

CASES = {
    # the full_44KHz family: context, learned upsampling, difference, stereo
    "context_learned_diff": ("full_44KHz", dict(num_layers=4,
                                                num_initial_filters=8,
                                                num_frames=1024)),
    "context_learned_diff_slice": ("full_44KHz", dict(
        num_layers=4, num_initial_filters=8, num_frames=1024,
        decimate_lowering="slice")),
    # same padding, bilinear upsampling, direct output, mono
    "same_bilinear_direct": ("baseline", dict(num_layers=3,
                                              num_initial_filters=6,
                                              num_frames=512)),
    "same_bilinear_direct_slice": ("baseline", dict(
        num_layers=3, num_initial_filters=6, num_frames=512,
        decimate_lowering="slice")),
    # even filter widths: the dilated lowering's asymmetric SAME pads
    "same_even_filters": ("baseline", dict(num_layers=3, num_frames=512,
                                           filter_size=16,
                                           merge_filter_size=6,
                                           num_initial_filters=6)),
    # a smaller full_44KHz for the slow bf16 convs of XLA on the CPU
    "context_learned_diff_tiny": ("full_44KHz", dict(num_layers=3,
                                                     num_initial_filters=6,
                                                     num_frames=256)),
}


def configs(case):
    preset, over = CASES[case]
    return get_config(preset, **over), jax_get_config(preset, **over)


def numpy_params(cfg, seed=0):
    """Glorot-scale kernels, small biases, interpolation weights around 0,
    drawn with numpy in the shapes of ``cfg``."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, leaves in init_waveunet(torch.Generator().manual_seed(0),
                                       cfg, "cpu").items():
        out[layer] = {}
        for name, t in leaves.items():
            shape = tuple(t.shape)
            if name == "kernel":
                lim = np.sqrt(6.0 / (shape[0] * (shape[1] + shape[2])))
                a = rng.uniform(-lim, lim, shape)
            elif name == "bias":
                a = 0.05 * rng.standard_normal(shape)
            else:
                a = rng.uniform(-1.0, 1.0, shape)
            out[layer][name] = a.astype(np.float32)
    return out


def numpy_batch(cfg, n=2, seed=1):
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    rng = np.random.default_rng(seed)
    batch = {name: (0.2 * rng.standard_normal(
        (n, out_len, cfg.num_channels))).astype(np.float32)
        for name in cfg.source_names}
    batch["mix"] = (0.3 * rng.standard_normal(
        (n, in_len, cfg.num_channels))).astype(np.float32)
    return batch


def torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def jax_grads(jcfg, params, batch):
    loss_fn = jax_make_loss_fn(jcfg, True)
    (loss, _), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), {},
        {k: jnp.asarray(v) for k, v in batch.items()}, None)
    return float(loss), jax.tree_util.tree_map(np.asarray, g)


def port_grads(cfg, params, batch):
    loss, _, g = value_and_grad(make_loss_fn(cfg, True),
                                params_from_numpy(params, "cpu"), {},
                                torch_tree(batch))
    return float(loss), params_to_numpy(g)


def assert_grads_close(got, want, tol, floor=0.0):
    """Each gradient within ``tol`` of its largest magnitude, or of
    ``floor`` times the largest over all tensors where that is larger."""
    assert set(got) == set(want)
    top = max(float(np.max(np.abs(w))) for leaves in want.values()
              for w in leaves.values())
    for layer in want:
        for name, w in want[layer].items():
            scale = max(float(np.max(np.abs(w))), floor * top)
            assert scale > 0, f"{layer}/{name} has a zero gradient"
            err = float(np.max(np.abs(got[layer][name] - w)))
            assert err <= tol * scale, (layer, name, err, scale)


@pytest.mark.parametrize("case", sorted(set(CASES)
                                        - {"context_learned_diff_tiny"}))
def test_training_forward_matches_jax(case):
    cfg, jcfg = configs(case)
    params = numpy_params(cfg)
    mix = numpy_batch(cfg)["mix"]
    want = jax_apply(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                     jnp.asarray(mix), training=True)
    tp = params_from_numpy(params, "cpu")
    for leaves in tp.values():
        for t in leaves.values():
            t.requires_grad_(True)
    got = apply_waveunet(tp, cfg, torch.from_numpy(mix), training=True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].grad_fn is not None, k
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=FORWARD_ATOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["context_learned_diff",
                                  "same_bilinear_direct",
                                  "same_even_filters"])
def test_loss_and_every_gradient_match_jax(case):
    cfg, jcfg = configs(case)
    params, batch = numpy_params(cfg), numpy_batch(cfg)
    want_loss, want = jax_grads(jcfg, params, batch)
    got_loss, got = port_grads(cfg, params, batch)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert_grads_close(got, want, GRAD_TOL)


def test_remat_matches_plain_grads():
    cfg, _ = configs("context_learned_diff")
    params, batch = numpy_params(cfg), numpy_batch(cfg)
    l0, g0 = port_grads(cfg, params, batch)
    l1, g1 = port_grads(cfg.replace(remat=True), params, batch)
    assert l0 == l1
    for layer in g0:
        for name in g0[layer]:
            np.testing.assert_array_equal(g1[layer][name], g0[layer][name])


# bf16 training convs round every conv output to 8 bits of mantissa, and
# XLA and PyTorch accumulate before that rounding in different orders, so
# the two packages' bf16 gradients differ by up to 9% of a tensor's largest
# value (measured). They are held instead by how far each lies from the fp32
# gradient: the port's distance at most BF16_FACTOR times JAX's own, or
# BF16_FLOOR of the tensor's largest value (measured: at most 3.6 times).
BF16_LOSS_RTOL = 1e-4  # measured 3e-5
BF16_FACTOR = 5.0
BF16_FLOOR = 5e-3


def test_bf16_training_matches_jax_bf16():
    cfg32, jcfg32 = configs("context_learned_diff_tiny")
    cfg, jcfg = (cfg32.replace(compute_dtype="bfloat16"),
                 jcfg32.replace(compute_dtype="bfloat16"))
    params, batch = numpy_params(cfg), numpy_batch(cfg)
    _, fp32 = jax_grads(jcfg32, params, batch)
    want_loss, want = jax_grads(jcfg, params, batch)
    got_loss, got = port_grads(cfg, params, batch)
    assert abs(got_loss - want_loss) <= BF16_LOSS_RTOL * abs(want_loss)
    for layer in fp32:
        for name, ref in fp32[layer].items():
            scale = float(np.max(np.abs(ref)))
            e_jax = float(np.max(np.abs(want[layer][name] - ref))) / scale
            e_port = float(np.max(np.abs(got[layer][name] - ref))) / scale
            assert e_port <= max(BF16_FACTOR * e_jax, BF16_FLOOR), (
                layer, name, e_port, e_jax)
    # and the bf16 training step is not the fp32 one
    fp32_loss, _ = port_grads(cfg32, params, batch)
    assert got_loss != fp32_loss


# bf16 inference rounds each conv's operands to bf16 and accumulates in
# fp32 in both packages; a rounding that flips at one layer's input moves
# the next by up to one bf16 step of that value (measured: 3.7e-5).
BF16_FORWARD_ATOL = 2e-4


def test_bf16_inference_matches_jax_bf16():
    cfg, jcfg = configs("context_learned_diff_tiny")
    cfg, jcfg = (cfg.replace(compute_dtype="bfloat16"),
                 jcfg.replace(compute_dtype="bfloat16"))
    params, mix = numpy_params(cfg), numpy_batch(cfg)["mix"]
    want = jax_apply(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                     jnp.asarray(mix), training=False)
    got = apply_waveunet(params_from_numpy(params, "cpu"), cfg,
                         torch.from_numpy(mix))
    fp32 = apply_waveunet(params_from_numpy(params, "cpu"),
                          cfg.replace(compute_dtype="float32"),
                          torch.from_numpy(mix))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=BF16_FORWARD_ATOL, rtol=0,
                                   err_msg=k)
        assert not torch.equal(got[k], fp32[k])


# -- Adam against optax ------------------------------------------------------

ADAM_RTOL = 1e-6
ADAM_ATOL = 1e-9


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return {layer: {n: (1e-2 * rng.standard_normal(a.shape)).astype(
        np.float32) for n, a in leaves.items()}
        for layer, leaves in params.items()}


def _assert_tree_close(got, want, what):
    for layer in want:
        for n in want[layer]:
            np.testing.assert_allclose(got[layer][n], np.asarray(want[layer][n]),
                                       rtol=ADAM_RTOL, atol=ADAM_ATOL,
                                       err_msg=f"{what} {layer}/{n}")


def _optax_adam_fields(opt_state):
    adam = opt_state[0]
    return (int(adam.count), jax.tree_util.tree_map(np.asarray, adam.mu),
            jax.tree_util.tree_map(np.asarray, adam.nu))


def test_adam_two_steps_match_optax():
    cfg, _ = configs("context_learned_diff")
    params = numpy_params(cfg)
    lr = 1e-3
    tx = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    update = jax.jit(tx.update)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    port = Adam(lr)
    tp = params_from_numpy(params, "cpu")
    ts = port.init(tp)
    for seed in (1, 2):
        g = _grads_like(params, seed)
        upd, js = update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        port.update_(tp, params_from_numpy(g, "cpu"), ts)
        _assert_tree_close(params_to_numpy(tp), jp, f"params after {seed}")
        count, mu, nu = _optax_adam_fields(js)
        got_count, got_mu, got_nu = adam_state_to_numpy(ts)
        assert int(got_count) == count == seed
        _assert_tree_close(got_mu, mu, "mu")
        _assert_tree_close(got_nu, nu, "nu")


def test_optax_state_carries_into_the_port_and_back():
    """A JAX step's optax state continues in the port (and the port's state
    back in optax) as if one package had taken every step."""
    cfg, _ = configs("same_bilinear_direct")
    params = numpy_params(cfg)
    lr = 1e-4
    tx = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    update = jax.jit(tx.update)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    g1, g2, g3 = (_grads_like(params, s) for s in (1, 2, 3))
    upd, js = update(jax.tree_util.tree_map(jnp.asarray, g1), js, jp)
    jp = optax.apply_updates(jp, upd)

    # into the port after one JAX step
    count, mu, nu = _optax_adam_fields(js)
    ts = adam_state_from_numpy(count, mu, nu, "cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    Adam(lr).update_(tp, params_from_numpy(g2, "cpu"), ts)
    upd, js = update(jax.tree_util.tree_map(jnp.asarray, g2), js, jp)
    jp = optax.apply_updates(jp, upd)
    _assert_tree_close(params_to_numpy(tp), jp, "params after the carry-in")
    assert int(ts["count"]) == 2

    # and back into optax for a third step; copied (jnp.array), since
    # jnp.asarray of these views aliases the port's tensors on the CPU, and
    # the port's in-place step below could then race optax's dispatched one
    c, m, v = adam_state_to_numpy(ts)
    back = (optax.ScaleByAdamState(
        count=jnp.array(c), mu=jax.tree_util.tree_map(jnp.array, m),
        nu=jax.tree_util.tree_map(jnp.array, v)), optax.EmptyState())
    jb = jax.tree_util.tree_map(jnp.array, params_to_numpy(tp))
    upd, back = update(jax.tree_util.tree_map(jnp.asarray, g3), back, jb)
    jb = optax.apply_updates(jb, upd)
    Adam(lr).update_(tp, params_from_numpy(g3, "cpu"), ts)
    _assert_tree_close(params_to_numpy(tp), jb, "params after the carry-back")


def test_train_step_updates_in_place_and_learns():
    cfg, _ = configs("context_learned_diff")
    params = params_from_numpy(numpy_params(cfg), "cpu")
    batch = torch_tree(numpy_batch(cfg))
    init_opt, step = make_train_step(cfg, 1e-3, device="cpu")
    opt = init_opt(params)
    before = {k: v.clone() for k, v in params["down_0"].items()}
    losses = []
    for _ in range(30):
        p, _, o, loss = step(params, {}, opt, batch)
        assert p is params and o is opt
        losses.append(float(loss))
    assert int(opt["count"]) == 30
    assert not torch.equal(params["down_0"]["kernel"], before["kernel"])
    assert losses[-1] < 0.8 * losses[0], losses


# -- the spectrogram U-Net's training side -----------------------------------

U7_SMALL = dict(num_layers=3, num_frames=768 * 7 + 1024,
                num_initial_filters=4)
U7_ATOL = 5e-5


@pytest.fixture(scope="module")
def u7():
    jcfg = jax_get_config("unet_spectrogram", **U7_SMALL)
    p, st = jax_su.init_spectrogram_unet(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), p)
    st = jax.tree_util.tree_map(
        lambda a: np.abs(np.asarray(a) + 0.1 * rng.standard_normal(
            a.shape).astype(np.float32)), st)
    mix = (0.3 * rng.standard_normal((2, jcfg.num_frames, 1))).astype(
        np.float32)
    return jcfg, get_config("unet_spectrogram", **U7_SMALL), p, st, mix


def test_batch_norm_training_statistics_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 8, 5)).astype(np.float32) * 2 + 0.5
    beta = rng.standard_normal(5).astype(np.float32)
    stats = {"mean": rng.standard_normal(5).astype(np.float32),
             "var": np.abs(rng.standard_normal(5)).astype(np.float32)}
    wy, wst = jax_su._bn_apply(jnp.asarray(x), jnp.asarray(beta),
                               jax.tree_util.tree_map(jnp.asarray, stats),
                               True)
    gy, gst = su._bn_train(torch.from_numpy(x), torch.from_numpy(beta),
                           torch_tree(stats))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=U7_ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]),
                                   atol=U7_ATOL, rtol=0)


def test_u7_training_moves_the_statistics_as_jax(u7):
    """The down path and the first up layer's batch norm come before any
    dropout, so their moved statistics match JAX's exactly (to 5e-5)."""
    jcfg, cfg, p, st, mix = u7
    _, want = jax_su.apply_spectrogram_unet(
        jax.tree_util.tree_map(jnp.asarray, p), jcfg, jnp.asarray(mix), True,
        jax.tree_util.tree_map(jnp.asarray, st), rng=jax.random.PRNGKey(0))
    _, got = su.apply_spectrogram_unet(
        params_from_numpy(p, "cpu"), cfg, torch.from_numpy(mix),
        training=True, state=params_from_numpy(st, "cpu"),
        generator=torch.Generator().manual_seed(0))
    keys = [k for k in want if "/down_" in k or k.endswith("/up_0_bn")]
    assert len(keys) == 2 * (jcfg.num_layers + 1)
    for k in keys:
        for s in ("mean", "var"):
            np.testing.assert_allclose(got[k][s].numpy(),
                                       np.asarray(want[k][s]), atol=U7_ATOL,
                                       rtol=0, err_msg=f"{k}/{s}")
            assert not np.array_equal(got[k][s].numpy(), st[k][s])


def test_dropout_keeps_half_scaled_by_two():
    x = torch.full((200_000,), 3.0)
    a = su.dropout(x, torch.Generator().manual_seed(1))
    b = su.dropout(x, torch.Generator().manual_seed(1))
    c = su.dropout(x, torch.Generator().manual_seed(2))
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.005
    assert torch.all(a[kept] == 6.0)
    assert torch.equal(a, b)
    assert not torch.equal(kept, c != 0)


def test_u7a_l1_loss_and_grads_match_jax_with_dropout_keeping_all(
        u7, monkeypatch):
    """JAX's masks cannot be drawn in PyTorch, so both packages keep every
    value here (still scaled by 2): the rest of the training forward, batch
    statistics included, and the L1 magnitude loss must then agree."""
    jcfg, cfg, p, st, mix = u7
    jcfg, cfg = (jcfg.replace(raw_audio_loss=False),
                 cfg.replace(raw_audio_loss=False))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.ones(shape, bool))
    monkeypatch.setattr(su, "dropout", lambda x, gen, mesh=None: x / 0.5)
    rng = np.random.default_rng(5)
    batch = {s: (0.2 * rng.standard_normal(mix.shape)).astype(np.float32)
             for s in cfg.source_names}
    batch["mix"] = mix
    (wl, _), wg = jax.jit(jax.value_and_grad(jax_make_loss_fn(jcfg, True),
                                             has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p),
        jax.tree_util.tree_map(jnp.asarray, st),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    gl, _, gg = value_and_grad(make_loss_fn(cfg, True),
                               params_from_numpy(p, "cpu"),
                               params_from_numpy(st, "cpu"),
                               torch_tree(batch))
    assert abs(float(gl) - float(wl)) <= LOSS_RTOL * abs(float(wl))
    # a conv bias just before a training batch norm is subtracted out again
    # with the batch mean: its true gradient is 0 and both packages give
    # rounding noise (up to 7e-7 of the largest gradient), so every tensor
    # is held to 1e-4 of its own largest gradient or of 1e-2 of the largest
    # over all tensors
    assert_grads_close(params_to_numpy(gg),
                       jax.tree_util.tree_map(np.asarray, wg), GRAD_TOL,
                       floor=1e-2)


# -- the kernels refuse autograd ---------------------------------------------

def _wrapper_calls():
    x = torch.randn(2, 20, 3)
    w = torch.randn(5, 3, 4)
    b = torch.randn(4)
    return {
        "conv1d_lrelu": (conv1d_fused.conv1d_lrelu, (x, w, b)),
        "conv1d_lrelu_im2col": (conv1d_im2col.conv1d_lrelu_im2col,
                                (x.transpose(1, 2).contiguous(), w, b)),
        "learned_interp": (interp.learned_interp,
                           (x, torch.randn(3), True)),
    }


@pytest.mark.parametrize("op", ["conv1d_lrelu", "conv1d_lrelu_im2col",
                                "learned_interp"])
@pytest.mark.parametrize("which", [0, 1])
def test_kernel_wrappers_refuse_autograd(op, which):
    fn, args = _wrapper_calls()[op]
    want = fn(*args)
    args = list(args)
    args[which] = args[which].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match=op):
        fn(*args)
    with torch.no_grad():
        # the plain conv's matmul folds differently for an operand that
        # requires grad: equal to fp32 rounding, not bit for bit
        torch.testing.assert_close(fn(*args), want, rtol=1e-6, atol=1e-6)


def test_inference_forward_unaffected_by_parameters_that_require_grad():
    cfg, _ = configs("context_learned_diff")
    params = params_from_numpy(numpy_params(cfg), "cpu")
    mix = torch.from_numpy(numpy_batch(cfg)["mix"])
    want = apply_waveunet(params, cfg, mix)
    for leaves in params.values():
        for t in leaves.values():
            t.requires_grad_(True)
    got = apply_waveunet(params, cfg, mix)
    for k in want:
        assert got[k].grad_fn is None and torch.equal(got[k], want[k])
