"""The FLOP and byte arithmetic that the mfu and roofline readers use."""

import pytest

from benchmark import catalog, work
from benchmark.families import unet
from benchmark.reference import shapes
from benchmark.reference.sources import source_names

M5 = catalog.load("configs", "m5-highsr")
M6 = catalog.load("configs", "m6-multi")


def test_windows_of_the_configurations():
    assert shapes.get_padding(M5, shapes.infer_frames(M5)) == (196595, 65541)
    assert shapes.get_padding(M5, M5["num_frames"]) == (147443, 16389)
    assert shapes.get_padding(M6, shapes.infer_frames(M6)) == (196595, 65541)


@pytest.mark.parametrize("arch,in_len,gflop", [
    (M5, 196595, 37.487), (M5, 147443, 22.790)],
    ids=["m5-inference", "m5-training"])
def test_conv_flops_reproduce_the_copied_count(arch, in_len, gflop):
    assert unet.waveunet_conv_flops(arch, in_len) / 1e9 == pytest.approx(
        gflop, abs=5e-4)
    calls = unet.calls(arch, in_len)
    assert sum(c.flops for c in calls if c.op != "interp") == \
        unet.waveunet_conv_flops(arch, in_len)


@pytest.mark.parametrize("arch", [M5, M6], ids=["m5", "m6"])
def test_calls_of_a_forward(arch):
    calls = unet.calls(arch, 196595)
    ops = [c.op for c in calls]
    learned = arch["upsampling"] == "learned"
    assert ops.count("conv") == 25
    assert ops.count("interp") == (12 if learned else 0)
    assert ops.count("conv_out") == len(source_names(arch)) - 1
    # the first down conv: 2 -> 24 channels, 15 taps over 196,595 samples
    c = calls[0]
    assert c.flops == 2 * 196581 * 15 * 2 * 24
    assert c.bytes == 4 * (196595 * 2 + 15 * 2 * 24 + 24 + 196581 * 24)
    assert c.bound_s() == c.bytes / work.PEAK_BYTES_PER_S  # memory-bound
    assert unet.waveunet_conv_flops(M6, 196595) != unet.waveunet_conv_flops(
        M5, 196595)


def test_calls_scale_with_the_batch_and_chunk_by_infer_batch():
    one = unet.calls(M5, 196595, 1)
    four = unet.calls(M5, 196595, 4)
    for a, b in zip(one, four):
        assert b.flops == 4 * a.flops
        assert a.bytes < b.bytes < 4 * a.bytes + 1
    assert list(work.chunks(37, 16)) == [16, 16, 5]
    calls = list(work.request_calls(unet.calls, M5, 196595, 37))
    assert len(calls) == 3 * len(one)
    assert sum(c.flops for c in calls) == 37 * sum(c.flops for c in one)


def test_interp_call():
    c = unet.interp_call(2, 10, 3)
    assert c.flops == 3 * 2 * 9 * 3
    assert c.bytes == 4 * (2 * 10 * 3 + 3 + 2 * 19 * 3)
