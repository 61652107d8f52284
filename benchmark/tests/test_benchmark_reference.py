"""The benchmark's reference against the port, on the CPU at a tiny size.

The reference decides ``correct`` on the card; here it is held against the
program it judges, so that a disagreement on the card is the program's
and not the reference's. Run with ``python -m pytest benchmark/tests``.
"""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.families import unet
from benchmark.reference import engine, resample, shapes, train, waveunet
from benchmark.reference.sources import source_names

torch.set_num_threads(2)
CPU = torch.device("cpu")


def tiny(**kw):
    a = dict(network="unet", task="voice", num_layers=3,
             num_initial_filters=4, filter_size=15, input_filter_size=15,
             merge_filter_size=5, output_filter_size=1, num_frames=1024,
             expected_sr=44100, mono_downmix=False, context=True,
             upsampling="learned", output_type="difference",
             output_activation="tanh", batch_size=2, init_sup_sep_lr=1e-4,
             augmentation=True, infer_num_frames=-1, infer_batch=4,
             infer_wire_dtype="float32", compute_dtype="float32",
             conv_precision=None, preset="full_44KHz")
    a.update(kw)
    return a


M5 = tiny()
M6 = tiny(preset="full_multi_instrument", task="multi_instrument",
          expected_sr=22050, upsampling="linear")


def port_cfg(arch, **kw):
    from benchmark import port
    return port.config(arch, **kw)


@pytest.mark.parametrize("arch", [M5, M6], ids=["learned", "bilinear"])
def test_shapes_match_the_port(arch):
    from waveunet_tpu_torch.ops import shapes as ps
    cfg = port_cfg(arch)
    for frames in (1024, 4096, 16384, 65536):
        assert shapes.get_padding(arch, frames) == ps.get_padding(cfg,
                                                                   frames)
    assert shapes.infer_frames(arch) == ps.auto_infer_frames(cfg)
    full = dict(arch, num_layers=12, num_initial_filters=24,
                num_frames=16384)
    assert shapes.get_padding(full, shapes.infer_frames(full)) == (196595,
                                                                   65541)
    assert source_names(arch) == cfg.source_names


@pytest.mark.parametrize("arch", [M5, M6], ids=["learned", "bilinear"])
@pytest.mark.parametrize("training", [False, True])
def test_forward_matches_the_port(arch, training):
    from waveunet_tpu_torch.models.waveunet import apply_waveunet
    params, _ = unet.weights(arch, 3, CPU)
    in_len, _ = shapes.get_padding(arch, 1024)
    x = torch.rand((2, in_len, 2), generator=torch.Generator().manual_seed(
        1)) * 1.6 - 0.8
    ref = waveunet.forward(params, arch, x, training=training)
    got = apply_waveunet(params, port_cfg(arch), x, training=training)
    assert set(ref) == set(got)
    for k in ref:
        torch.testing.assert_close(got[k].detach(), ref[k].detach(),
                                   atol=2e-6, rtol=0)


@pytest.mark.parametrize("arch,sr,seconds", [
    (M5, 44100, 0.05),   # shorter than one network input
    (M5, 44100, 1.3),
    (M6, 44100, 1.3),    # resampled to the model's 22.05 kHz
    (M6, 22050, 0.9),
], ids=["short", "m5", "m6-44k", "m6-22k"])
def test_separation_matches_the_port(arch, sr, seconds):
    from waveunet_tpu_torch.infer.engine import Separator
    params, state = unet.weights(arch, 4, CPU)
    song = inputs.songs([seconds], sr, 5, CPU)[0]
    got = Separator(port_cfg(arch), params, model_state=state,
                    device="cpu").separate(song, sr)
    ref = engine.separate(
        lambda wins: unet.forward(params, state, arch, wins, "fp32"),
        unet.window(arch), arch, song, sr, CPU, batch=arch["infer_batch"])
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], ref[k], atol=2e-6, rtol=0)


@pytest.mark.parametrize("rates", [(44100, 22050), (48000, 44100),
                                   (22050, 44100), (44100, 44100)])
def test_resampler_matches_the_port(rates):
    from waveunet_tpu_torch.ops.resample import resample as port_resample
    x = inputs.songs([0.2], rates[0], 6, CPU)[0]
    got = port_resample(x, *rates)
    ref = resample.resample(torch.as_tensor(x), *rates).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.14159265, 1e-30], dtype=torch.float32)
    r = waveunet.round_tf32(x)
    # 1 + 2^-11 ties to the even 1.0; 1 + 3*2^-11 ties up to 1 + 2^-9
    expect = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9],
                          dtype=torch.float32)
    assert torch.equal(r[:4], expect)
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert torch.allclose(r, x, rtol=2 ** -11, atol=0)


def _bank_songs(arch, n_songs=2, seconds=0.5):
    gen = torch.Generator().manual_seed(9)
    n = int(seconds * arch["expected_sr"])
    return [{s: (0.45 * inputs.audio(gen, n, arch["expected_sr"],
                                     CPU)).numpy()
             for s in source_names(arch)} for _ in range(n_songs)]


def _port_bank(arch, songs, tmp_path, batch):
    import os

    from benchmark import port
    d = port.song_dir(arch, str(tmp_path))
    os.makedirs(d)
    for i, s in enumerate(songs):
        port.write_song(os.path.join(d, f"song_{i:04d}.npz"),
                        dict(s, mix=sum(s.values())))
    return port.fused_epoch(arch, str(tmp_path), batch, CPU)


def test_sampler_draws_match_the_port(tmp_path):
    songs = _bank_songs(M5)
    bank, _ = _port_bank(M5, songs, tmp_path, 3)
    ref_bank = [torch.as_tensor(np.stack([train.quantise(s[k]) for k in
                                          source_names(M5)]))
                for s in songs]
    in_len, out_len = shapes.get_padding(M5, M5["num_frames"])
    for key, step in ((7, 0), (2 ** 31 + 11, 5), (12345678901, 123)):
        got = bank.sample(key, step)
        ref, rows = train.batch_at(ref_bank, M5, key, step, 3, in_len,
                                   out_len)
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (key, step, k)
        assert len(set(rows)) == 3


def test_training_steps_match_the_port(tmp_path):
    songs = _bank_songs(M5)
    params, _ = unet.weights(M5, 8, CPU)
    p0 = {k: {n: t.clone() for n, t in v.items()} for k, v in params.items()}
    _, epoch = _port_bank(M5, songs, tmp_path, 2)
    from benchmark import port
    opt = port.adam_state(M5, params)
    losses = [float(epoch(params, {}, opt, 99, t)[3][0]) for t in range(3)]
    ref_bank = [torch.as_tensor(np.stack([train.quantise(s[k]) for k in
                                          source_names(M5)]))
                for s in songs]
    ref = train.run_steps(p0, M5, ref_bank, 99, 3, 2, 1e-4)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for (k, n), t in ref["params"].items():
        torch.testing.assert_close(params[k][n].detach(), t, atol=1e-7,
                                   rtol=1e-5)
