"""Each chunk's windows placed straight into the answer, on the CPU.

``Separator.separate`` copies each chunk's real windows below the song's
last into their place in the answer as one block a source, and the last
window, right-aligned, after it. The answer must be exactly the bytes of
the window rule it replaces: every window written in window order at its
position (later writes win), over the same chunk outputs, then the int16
wire's dequantiser and host difference source. Written here as that loop
(``stitch``), for a Wave-U-Net of two and of four sources and a tiny
BS-RoFormer, on both wires, in song and slab mode, through a song that
fills its windows exactly, a right-aligned last window, a song shorter
than one input and a split power-of-two tail. ``separate.placed_windows``
counts the windows a copy placed; it equals ``separate.windows``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from waveunet_tpu_torch import tracing
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.infer.engine import Separator, window_positions
from waveunet_tpu_torch.infer.wire import from_wire_np
from waveunet_tpu_torch.models import bs_roformer
from waveunet_tpu_torch.models.waveunet import init_waveunet
from torch_cpu import few_threads  # noqa: F401

SMALL = dict(num_layers=3, num_initial_filters=4, infer_num_frames=256,
             infer_batch=16)
TINY_ROFORMER = dict(dim=16, depth=2, heads=2, dim_head=8, stft_n_fft=64,
                     stft_hop=16, freqs_per_bands=(4,) * 4 + (8, 9),
                     num_frames=1024, infer_batch=16,
                     compute_dtype="float32")
FAMILIES = ["full_44KHz", "full_multi_instrument", "bs_roformer"]

# a song that fills 12 windows exactly; 12 windows, the last right-aligned
# over its neighbour; shorter than one input (padded to one); 11 windows,
# chunks 8 + 4 with a padded slot
LENGTHS = {"exact": lambda sep: 12 * sep.out_len,
           "right_aligned": lambda sep: 11 * sep.out_len + 9,
           "short": lambda sep: sep.in_len // 3,
           "split_tail": lambda sep: 10 * sep.out_len + sep.out_len // 2}


@pytest.fixture(autouse=True)
def clean_record():
    tracing.reset()
    yield
    tracing.reset()


def separator(family, wire, mode=None):
    if family == "bs_roformer":
        cfg = get_config(family, infer_wire_dtype=wire, **TINY_ROFORMER)
        params = bs_roformer.init_bs_roformer(
            torch.Generator().manual_seed(0), cfg, "cpu")
    else:
        cfg = get_config(family, infer_wire_dtype=wire, **SMALL)
        params = init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")
    return Separator(cfg, params, device="cpu", h2d_mode=mode)


def song(n, seed=4):
    rng = np.random.default_rng(seed)
    return (0.6 * rng.standard_normal((n, 2))).astype(np.float32)


def recording(sep):
    """Keep a copy of every chunk's outputs as ``separate`` runs them."""
    chunks = []
    run = sep._run_chunk

    def spy(mode, inp, pos):
        res = run(mode, inp, pos)
        chunks.append({k: v.clone() for k, v in res.items()})
        return res

    sep._run_chunk = spy
    return chunks


def stitch(sep, chunks, mix):
    """The window rule over the chunk outputs: window by window in window
    order, later writes win, padded slots dropped; then the int16 wire's
    dequantiser and host difference source, as ``separate`` had them."""
    n = mix.shape[0]
    n_total = max(n, sep.in_len)
    positions = window_positions(n_total, sep.out_len)
    dtype = np.int16 if sep._wire16 else np.float32
    out = {name: np.empty((n_total, sep.cfg.num_channels), dtype)
           for name in chunks[0]}
    wi = 0
    for res in chunks:
        wins = {name: v.numpy() for name, v in res.items()}
        for b in range(min(len(next(iter(wins.values()))),
                           len(positions) - wi)):
            p = int(positions[wi])
            for name, w in wins.items():
                out[name][p:p + sep.out_len] = w[b]
            wi += 1
    assert wi == len(positions)
    if sep._wire16:
        out = {name: from_wire_np(v) for name, v in out.items()}
    out = {name: v[:n] for name, v in out.items()}
    if sep._host_reconstruct_last:
        names = sep.cfg.source_names
        acc = sum(out[s] for s in names[:-1])
        out[names[-1]] = np.clip(mix - acc, -1.0, 1.0).astype(np.float32)
    return out


def traced(sep, mix):
    with profile(activities=[ProfilerActivity.CPU]):
        out = sep.separate(mix, sep.cfg.expected_sr)
    rec = tracing.record()
    tracing.reset()
    return out, rec


def same_bytes(got, want):
    assert list(got) == list(want)
    for name in want:
        g, w = got[name], want[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("length", sorted(LENGTHS))
@pytest.mark.parametrize("mode", ["song", "slabs"])
@pytest.mark.parametrize("wire", ["float32", "int16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_the_answer_is_the_window_rule_bit_for_bit(family, wire, mode,
                                                   length):
    sep = separator(family, wire, mode)
    mix = song(LENGTHS[length](sep))
    n_win = len(window_positions(max(len(mix), sep.in_len), sep.out_len))
    if length == "split_tail":
        assert sep._chunk_sizes(n_win) == [8, 4]
    if length == "right_aligned":
        assert window_positions(len(mix), sep.out_len)[-1] % sep.out_len
    chunks = recording(sep)
    out, rec = traced(sep, mix)
    same_bytes(out, stitch(sep, chunks, mix))
    counters = rec["counters"]
    assert counters["separate.windows"] == n_win
    assert counters["separate.placed_windows"] == n_win
    assert len(chunks) == counters["separate.chunks"]


@pytest.mark.parametrize("wire", ["float32", "int16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_every_request_places_every_window(family, wire):
    sep = separator(family, wire)
    for seed, windows in enumerate((1, 3, 17, 40)):
        mix = song(windows * sep.out_len - 7, seed)
        _, rec = traced(sep, mix)
        counters = rec["counters"]
        assert counters["separate.placed_windows"] == counters[
            "separate.windows"], (windows, counters)


@pytest.mark.parametrize("wire", ["float32", "int16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_a_held_answer_outlives_later_requests(family, wire):
    """Request 1's answer is unchanged by requests 2 and 3 of other
    lengths (one longer, one shorter), and no two answers share memory."""
    sep = separator(family, wire)
    first = sep.separate(song(6 * sep.out_len + 5, 1), sep.cfg.expected_sr)
    kept = {name: v.copy() for name, v in first.items()}
    later = [sep.separate(song(n, seed), sep.cfg.expected_sr)
             for seed, n in ((2, 20 * sep.out_len + 3),
                             (3, 2 * sep.out_len + 1))]
    same_bytes(first, kept)
    for out in later:
        for name, v in out.items():
            assert not np.shares_memory(v, first[name]), name
    assert not any(np.shares_memory(a, b) for a in later[0].values()
                   for b in later[1].values())
