"""The difference source built by the chunk program, on the CPU.

On the float32 wire ``Separator.separate`` takes the last source of a
difference-output Wave-U-Net or BS-RoFormer from each window's forward,
``clip(mix_window - sum(others), -1, 1)``, copies it back and stitches it
like the others. Every stitched sample of every source comes from the same
window, where the mix is the staged song, so for a float32 song the stem
must be bit for bit the host's rebuild from the returned stems, in song
and slab mode, through a power-of-two split tail and a song shorter than
one input. Each such request counts one ``separate.device_difference``.
On the int16 wire the host still rebuilds it (``separate.difference``).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from waveunet_tpu_torch import tracing
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.infer.engine import Separator, window_positions
from waveunet_tpu_torch.models import bs_roformer
from waveunet_tpu_torch.models.waveunet import init_waveunet
from torch_cpu import few_threads  # noqa: F401

SMALL = dict(num_layers=3, num_initial_filters=4, infer_num_frames=256,
             infer_batch=16)
TINY_ROFORMER = dict(dim=16, depth=2, heads=2, dim_head=8, stft_n_fft=64,
                     stft_hop=16, freqs_per_bands=(4,) * 4 + (8, 9),
                     num_frames=1024, infer_batch=2,
                     compute_dtype="float32")
PRESETS = ["full_44KHz", "full_multi_instrument"]


@pytest.fixture(autouse=True)
def clean_record():
    tracing.reset()
    yield
    tracing.reset()


def unet(preset, **kw):
    cfg = get_config(preset, **{**SMALL, **kw})
    return cfg, init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")


def roformer(**kw):
    cfg = get_config("bs_roformer", **{**TINY_ROFORMER, **kw})
    return cfg, bs_roformer.init_bs_roformer(
        torch.Generator().manual_seed(0), cfg, "cpu")


def song(n, seed=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (0.6 * rng.standard_normal((n, 2))).astype(dtype)


def host_rebuild(cfg, mix, out):
    """What ``separate`` built on the host before: the others summed in
    source order, subtracted from the mix, clipped, as float32."""
    acc = sum(out[s] for s in cfg.source_names[:-1])
    return np.clip(mix - acc, -1.0, 1.0).astype(np.float32)


def traced_separate(sep, mix, sr):
    with profile(activities=[ProfilerActivity.CPU]):
        out = sep.separate(mix, sr)
    return out, tracing.record()


def check_device_difference(sep, mix, sr):
    out, rec = traced_separate(sep, mix, sr)
    cfg = sep.cfg
    assert list(out) == list(cfg.source_names)
    last = out[cfg.source_names[-1]]
    assert last.dtype == np.float32 and last.shape == mix.shape
    np.testing.assert_array_equal(last, host_rebuild(cfg, mix, out))
    assert rec["counters"]["separate.device_difference"] == 1
    assert "separate.difference" not in rec["spans"]
    return out, rec


# windows of the request: a song shorter than one input (padded to one
# input, two windows), 11 (chunks 8 + 4), 12 with the last right-aligned
# at a partial hop (8 + 4), 40 (16 + 16 + 8)
LENGTHS = {"short": lambda sep: sep.in_len // 3,
           "split_tail": lambda sep: 10 * sep.out_len + sep.out_len // 2,
           "partial_hop": lambda sep: 11 * sep.out_len + 9,
           "three_chunks": lambda sep: 40 * sep.out_len - 5}
CHUNKS = {"short": [2], "split_tail": [8, 4], "partial_hop": [8, 4],
          "three_chunks": [16, 16, 8]}


@pytest.mark.parametrize("length", sorted(LENGTHS))
@pytest.mark.parametrize("mode", ["song", "slabs"])
@pytest.mark.parametrize("preset", PRESETS)
def test_the_wave_u_net_difference_is_the_host_rebuild(preset, mode, length):
    cfg, params = unet(preset)
    sep = Separator(cfg, params, device="cpu", h2d_mode=mode)
    mix = song(LENGTHS[length](sep))
    n_win = len(window_positions(max(len(mix), sep.in_len), sep.out_len))
    assert sep._chunk_sizes(n_win) == CHUNKS[length]
    _, rec = check_device_difference(sep, mix, cfg.expected_sr)
    assert rec["counters"]["separate.chunks"] == len(CHUNKS[length])


@pytest.mark.parametrize("mode", ["song", "slabs"])
def test_the_bs_roformer_difference_is_the_host_rebuild(mode):
    cfg, params = roformer()
    sep = Separator(cfg, params, device="cpu", h2d_mode=mode)
    mix = song(3 * sep.out_len + 300)
    out, _ = check_device_difference(sep, mix, 44100)
    assert sorted(out) == ["accompaniment", "vocals"]


@pytest.mark.parametrize("preset", PRESETS)
def test_each_request_counts_one(preset):
    cfg, params = unet(preset)
    sep = Separator(cfg, params, device="cpu")
    mixes = [song(n, seed) for seed, n in enumerate((700, 3000, 5000))]
    with profile(activities=[ProfilerActivity.CPU]):
        for mix in mixes:
            sep.separate(mix, cfg.expected_sr)
    assert tracing.record()["counters"]["separate.device_difference"] == 3


@pytest.mark.parametrize("family", ["full_44KHz", "full_multi_instrument",
                                    "bs_roformer"])
def test_the_chunk_program_gives_the_last_source_on_the_float32_wire_only(
        family):
    """float32: every source a window, the last the window's own rule;
    int16: the others only, quantised for the wire."""
    for wire in ("float32", "int16"):
        cfg, params = (roformer(infer_wire_dtype=wire)
                       if family == "bs_roformer"
                       else unet(family, infer_wire_dtype=wire))
        sep = Separator(cfg, params, device="cpu")
        mix = song(2 * sep.out_len)
        staged = sep._stage(mix, len(mix) + 2 * sep.pad).to(sep.device,
                                                            copy=True)
        pos = torch.from_numpy(window_positions(len(mix), sep.out_len))
        out = sep._chunk_fwd(sep.params, staged, pos)
        names = list(cfg.source_names)
        if wire == "int16":
            assert list(out) == names[:-1]
            assert all(v.dtype == torch.int16 for v in out.values())
            continue
        assert list(out) == names
        mix_win = sep._frame(staged, pos)[:, sep.pad:sep.pad + sep.out_len]
        acc = sum(out[s] for s in names[:-1])
        assert torch.equal(out[names[-1]],
                           torch.clamp(mix_win - acc, -1.0, 1.0))


@pytest.mark.parametrize("family", ["full_44KHz", "full_multi_instrument",
                                    "bs_roformer"])
def test_the_int16_wire_keeps_the_host_rebuild(family):
    cfg, params = (roformer(infer_wire_dtype="int16")
                   if family == "bs_roformer"
                   else unet(family, infer_wire_dtype="int16"))
    sep = Separator(cfg, params, device="cpu")
    mix = song(3 * sep.out_len + 17)
    out, rec = traced_separate(sep, mix, cfg.expected_sr)
    assert rec["spans"]["separate.difference"][0] == 1
    assert "separate.device_difference" not in rec["counters"]
    np.testing.assert_array_equal(out[cfg.source_names[-1]],
                                  host_rebuild(cfg, mix, out))


@pytest.mark.parametrize("preset", PRESETS)
def test_a_float64_mix_differs_by_its_fp32_rounding_at_most(preset):
    """The chunk program subtracts from the staged fp32 mix, the old host
    rebuild from the float64 one: they part by the mix's rounding and one
    rounding of the result, within an fp32 ulp at 2."""
    cfg, params = unet(preset)
    sep = Separator(cfg, params, device="cpu")
    mix = song(5 * sep.out_len, dtype=np.float64)
    out, _ = traced_separate(sep, mix, cfg.expected_sr)
    last = out[cfg.source_names[-1]]
    assert last.dtype == np.float32
    np.testing.assert_allclose(last, host_rebuild(cfg, mix, out), rtol=0,
                               atol=float(np.spacing(np.float32(2.0))))
