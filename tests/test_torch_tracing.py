"""The port's spans and counters (``waveunet_tpu_torch/tracing.py``) on the
CPU: off without a profiler (``record_function`` never entered, the record
empty), on under ``torch.profiler``, nested under ``separate`` in the
exported trace, self times that add up, counters that match the engine's
schedule; and the benchmark's readers of the engine layer over a known
record.

``separate.wait`` spans only a card's event: the CPU engine has none to
wait on, so it is left out here and read on the card (``chip_smoke.py``
phase ``graphs``, the benchmark's ``engine_wait_share.songs``).
"""

import json
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from waveunet_tpu_torch import tracing
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.infer.engine import Separator, window_positions
from waveunet_tpu_torch.models.waveunet import init_waveunet
from waveunet_tpu_torch.ops.resample import resample, resample_device
from torch_cpu import few_threads  # noqa: F401

CHILDREN = ("resample", "separate.stage", "separate.chunk",
            "separate.stitch")


def children(sep):
    """The spans under ``separate``: the host builds the difference source
    (``separate.difference``) on the int16 wire alone."""
    if sep.cfg.infer_wire_dtype == "int16":
        return CHILDREN + ("separate.difference",)
    return CHILDREN


@pytest.fixture(scope="module", params=["float32", "int16"])
def sep(request):
    """A shrunk full_44KHz at 22.05 kHz: a 44.1 kHz request goes through
    the resampler; the difference source comes from the chunk program on
    the float32 wire and is rebuilt on the host on the int16 wire."""
    cfg = get_config("full_44KHz", num_layers=3, num_initial_filters=4,
                     infer_num_frames=256, infer_batch=4, expected_sr=22050,
                     infer_wire_dtype=request.param)
    params = init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")
    return Separator(cfg, params, device="cpu")


@pytest.fixture(autouse=True)
def clean_record():
    tracing.reset()
    yield
    tracing.reset()


def _song(seconds=0.5, sr=44100):
    rng = np.random.default_rng(5)
    return (0.3 * rng.standard_normal((int(seconds * sr), 2))).astype(
        np.float32)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_off_without_a_profiler(sep, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    sep.separate(_song(), 44100)
    resample_device(_song(0.1), 44100, 22050, device="cpu")
    assert tracing.record() == {"spans": {}, "counters": {}}
    assert tracing.span("a") is tracing.span("b")  # one shared nullcontext


def test_spans_nest_under_separate_in_the_trace(sep, tmp_path):
    _, prof = _traced(lambda: sep.separate(_song(), 44100))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (outer,) = [e for e in events if e["name"] == "separate"]
    a, b = outer["ts"], outer["ts"] + outer["dur"]
    assert ("separate.difference" in {e["name"] for e in events}) == (
        sep.cfg.infer_wire_dtype == "int16")
    for name in children(sep):
        inner = [e for e in events if e["name"] == name]
        assert inner, name
        for e in inner:
            assert e["tid"] == outer["tid"], name
            assert a <= e["ts"] and e["ts"] + e["dur"] <= b + 1e-3, name


def test_record_self_times_and_counters(sep):
    song = _song(0.7)
    out, _ = _traced(lambda: sep.separate(song, 44100))
    rec = tracing.record()
    spans = rec["spans"]
    names = children(sep)
    assert set(spans) == {"separate", *names}
    n, total, own = spans["separate"]
    assert n == 1
    inner = sum(spans[c][1] for c in names)
    assert inner <= total
    assert own == pytest.approx(total - inner, abs=1e-8)
    for c in names:
        cn, ct, cs = spans[c]
        assert cn >= 1 and cs == pytest.approx(ct, abs=1e-12)  # no children
    n_total = next(iter(out.values())).shape[0]
    positions = window_positions(max(n_total, sep.in_len), sep.out_len)
    sizes = sep._chunk_sizes(len(positions))
    assert len(sizes) >= 2
    counters = {"separate.windows": len(positions),
                "separate.placed_windows": len(positions),
                "separate.window_slots": sum(sizes),
                "separate.chunks": len(sizes),
                "separate.eager_chunks": len(sizes)}
    if sep.cfg.infer_wire_dtype == "float32":
        counters["separate.device_difference"] = 1
    assert rec["counters"] == counters
    assert spans["separate.chunk"][0] == len(sizes)


ROFORMER = ("roformer.stft", "roformer.band_split", "roformer.time_layer",
            "roformer.band_layer", "roformer.mask", "roformer.istft")


def test_bs_roformer_parts_nest_under_each_chunk(tmp_path):
    """BS-RoFormer's eager forward names its parts inside ``separate.chunk``
    (one each a chunk, the layers one a block a chunk), in the trace and
    in the record; off without a profiler; and the ``attention`` counter is
    one of ``launch_counts()`` (it counts the card's flash calls)."""
    from waveunet_tpu_torch.models.bs_roformer import init_bs_roformer
    from waveunet_tpu_torch.ops.kernels import launch_counts
    cfg = get_config("bs_roformer", dim=16, depth=2, heads=2, dim_head=8,
                     stft_n_fft=64, stft_hop=16,
                     freqs_per_bands=(4,) * 4 + (8, 9), num_frames=1024,
                     infer_batch=2, compute_dtype="float32")
    params = init_bs_roformer(torch.Generator().manual_seed(0), cfg, "cpu")
    rsep = Separator(cfg, params, device="cpu")
    song = _song(3000 / 44100)
    rsep.separate(song, 44100)
    assert tracing.record() == {"spans": {}, "counters": {}}
    _, prof = _traced(lambda: rsep.separate(song, 44100))
    spans = tracing.record()["spans"]
    chunks = spans["separate.chunk"][0]
    assert chunks == 2  # 3 windows of 1,024: 2 + 1
    assert {k: spans[k][0] for k in ROFORMER} == {
        "roformer.stft": chunks, "roformer.band_split": chunks,
        "roformer.time_layer": 2 * chunks, "roformer.band_layer": 2 * chunks,
        "roformer.mask": chunks, "roformer.istft": chunks}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    outer = [e for e in events if e["name"] == "separate.chunk"]
    for e in events:
        if e["name"] in ROFORMER:
            assert any(o["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= o["ts"] + o["dur"] + 1e-3 for o in outer), e
    assert "attention" in launch_counts()


@pytest.mark.parametrize("fn", [resample, resample_device],
                         ids=["host", "device"])
def test_both_resamplers_record_resample(fn):
    kw = {"device": "cpu"} if fn is resample_device else {}
    out, _ = _traced(lambda: fn(_song(0.2), 44100, 22050, **kw))
    assert out.shape[0] == int(0.2 * 22050)
    n, total, own = tracing.record()["spans"]["resample"]
    assert n == 1 and total > 0 and own == total


def test_span_args_reach_record_function(sep, monkeypatch):
    seen = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    _traced(lambda: (sep.separate(_song(0.2), 44100),
                     sep.separate(_song(0.2), 44100)))
    requests = [args for name, args in seen if name == "separate"]
    assert len(requests) == 2
    first, second = (int(a.split("=")[1]) for a in requests)
    assert requests[0].startswith("request=") and second == first + 1


def test_reset_clears_the_record():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("x"):
            tracing.count("y", 3)
    rec = tracing.record()
    assert rec["spans"]["x"][0] == 1 and rec["counters"] == {"y": 3}
    tracing.reset()
    assert tracing.record() == {"spans": {}, "counters": {}}


def test_threads_lose_no_update():
    """More threads than cores, a short switch interval: every span and
    count of every thread lands in the record, each thread's nesting its
    own."""
    n_threads, n_iter = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_iter):
                with tracing.span("outer"):
                    with tracing.span("inner"):
                        tracing.count("n")

        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = tracing.record()
    assert rec["counters"] == {"n": n_threads * n_iter}
    (n_o, total_o, self_o), (n_i, total_i, _) = (rec["spans"]["outer"],
                                                 rec["spans"]["inner"])
    assert n_o == n_i == n_threads * n_iter
    assert self_o == pytest.approx(total_o - total_i, abs=1e-6)


# -- the benchmark's readers of the engine layer ------------------------------

READINGS = {  # reader: percent of a 2 s window, from the record below
    "engine_host_share.songs": 100 * (1.2 - 0.5) / 2.0,
    "engine_host_share.clips": 100 * (1.2 - 0.5) / 2.0,
    "engine_wait_share.songs": 100 * 0.5 / 2.0,
    "resample_share.songs": 100 * 0.25 / 2.0,
}
RECORD = {"spans": {"separate": (3, 1.2, 0.1), "separate.wait": (9, 0.5, 0.5),
                    "resample": (3, 0.25, 0.25)},
          "counters": {"separate.windows": 40}}


@pytest.fixture(scope="module")
def readers():
    from benchmark import catalog
    found = catalog.metric_readers()
    return {name: found[name] for name in READINGS}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_engine_readers(readers, monkeypatch, name):
    from benchmark import program_trace
    reader = readers[name]
    traced = SimpleNamespace(timeline=SimpleNamespace(window_s=2.0))
    assert reader.read(SimpleNamespace(timeline=None)) is None
    monkeypatch.setattr(program_trace, "record", lambda: RECORD)
    assert reader.read(traced) == pytest.approx(READINGS[name])
    # a program that keeps no record, or recorded no request
    monkeypatch.setattr(program_trace, "record", lambda: None)
    assert reader.read(traced) is None
    monkeypatch.setattr(program_trace, "record",
                        lambda: {"spans": {}, "counters": {}})
    assert reader.read(traced) is None


def test_program_trace_reads_the_programs_record():
    from benchmark import program_trace
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("separate"):
            pass
    assert program_trace.record() == tracing.record()
    assert program_trace.record()["spans"]["separate"][0] == 1
