"""Benchmark: separation throughput of full_44KHz on one CUDA card.

    python -m waveunet_tpu_torch.bench            # on the card
    BENCH_SMOKE=1 python -m waveunet_tpu_torch.bench   # CPU, tiny, schema only

The counterpart of the JAX package's ``bench.py``, with its metric names and
headline definition. Prints ONE JSON line.

HEADLINE (``value``): ``engine_device_resident_audio_s_per_s``, the whole
inference engine (``Separator.resident_sweep``: framing on the device, the
windows in the production chunk schedule, the int16 wire round trip, the
device stitch, the difference source), captured as one CUDA graph and timed
on a device-resident 60 s song: k replays back to back, then one
``torch.cuda.synchronize()``, best of the timed batches (median and spread
beside it). ``full_44KHz`` at ``infer_num_frames`` 65536, ``infer_batch``
16, random weights from a seed.

``vs_baseline``: the headline over the reference's serial batch-1 pattern,
timed the same way: the batch-1 forward at the reference's 16,384-frame
window on device-resident input (the reference also pays a host round trip
per window, which is left out, so the ratio is a floor).

Extras: ``compute_roof_audio_s_per_s`` (the bare 16-window forward), the
FLOP rate from the forward's conv shapes counted analytically and its share
of the H100 SXM's dense BF16 peak, full-width M6 (``full_multi_instrument``)
and U7 (``unet_spectrogram``) resident rows, and the ``e2e_*`` rows:
``Separator.separate`` on the host song (with its CUDA graphs captured by
``precompile``) against a serial per-window loop with a host round trip
each window, interleaved, median and spread over the reps.

``BENCH_SMOKE=1`` runs the same code on the CPU with tiny configurations and
marks the line ``"smoke": true``: its numbers mean nothing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

# NVIDIA H100 SXM5 data sheet: 989.4 TFLOP/s dense BF16 on the tensor cores
# (1,979 with 2:4 sparsity). The port computes in fp32 (3xTF32); the MFU row
# keeps the JAX bench's denominator kind, a chip's BF16 peak.
PEAK_BF16_TFLOPS = 989.4

METRIC = "engine_device_resident_audio_s_per_s"
UNIT = "audio-s/s/card (full_44KHz engine, device-resident, CUDA graph)"

REQUIRED_KEYS = (
    "metric", "value", "unit", "vs_baseline",
    "serial_resident_audio_s_per_s", "compute_roof_audio_s_per_s",
    "flagship_tflops_per_s", "flagship_mfu_vs_bf16_peak",
    "flagship_flops_source", "m6_resident_audio_s_per_s",
    "u7_resident_audio_s_per_s", "n_devices", "song_seconds",
    "infer_num_frames", "e2e_rtf", "e2e_vs_baseline",
    "e2e_vs_baseline_paired_median", "e2e_serial_baseline_rtf",
    "e2e_elapsed_s", "e2e_elapsed_median_s", "e2e_elapsed_spread",
    "e2e_serial_median_s", "e2e_serial_spread", "e2e_reps",
    "value_median", "value_spread", "flagship_gflop_per_audio_s",
    "device_name", "power_limit",
)


# -- the helpers of the JAX package's tools/benchutil.py --------------------
def make_bench_song(sr: int, seconds: float = 60.0) -> np.ndarray:
    """The bench song: 440 Hz sine + noise, stereo float32, seed 0."""
    n = int(seconds * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n) / sr
    mono = (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return np.stack([mono, mono], axis=1)


def sync(result=None) -> None:
    """Wait for the card's queued work (a CPU run is synchronous)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def pick_k(est_s: float, target_s: float = 0.3) -> int:
    """Calls per timed batch for an estimated ``est_s`` a call: cover about
    ``target_s`` a batch, clamped to [4, 32]."""
    return max(4, min(32, round(target_s / max(est_s, 1e-4))))


class Pipelined(NamedTuple):
    best: float          # seconds a call, best timed batch
    k: int               # calls a batch
    times: List[float]   # seconds a call, every scored batch


def best_pipelined(dispatch: Callable, k: Optional[int] = None,
                   reps: int = 3, wait: Callable = sync) -> Pipelined:
    """Seconds a call of ``dispatch`` (which enqueues one warmed device
    program) over batches of ``k`` calls, each followed by one ``wait``.

    ``k=None`` sizes the batch in two stages: a single waited call bounds
    the cost from above and gives a provisional k (``pick_k``); the first
    batch's per-call time re-sizes it before the scored batches (kept as a
    scored batch if k does not change)."""
    def one_batch(kk):
        t0 = time.perf_counter()
        for _ in range(kk):
            last = dispatch()
        wait(last)
        return (time.perf_counter() - t0) / kk

    times: List[float] = []
    if k is None:
        t0 = time.perf_counter()
        wait(dispatch())
        k = pick_k(time.perf_counter() - t0)
        first = one_batch(k)
        refined = pick_k(first)
        if refined == k:
            times.append(first)
            reps -= 1
        k = refined
    for _ in range(max(reps, 1)):
        times.append(one_batch(k))
    return Pipelined(min(times), k, times)


def resident_rtf(res_fn, params, song_dev, seconds: float,
                 reps: int = 3) -> Pipelined:
    """Warm (and capture) a ``resident_sweep`` program, then time it;
    ``best`` and ``times`` are in audio-seconds per second."""
    res_fn(params, song_dev)
    sync()
    p = best_pipelined(lambda: res_fn(params, song_dev)[1], reps=reps)
    return Pipelined(seconds / p.best, p.k, [seconds / t for t in p.times])


# -- FLOPs, counted from the forward's conv shapes ---------------------------
def waveunet_conv_flops(cfg, in_len: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of every conv of one window of the
    Wave-U-Net forward, walked from the input length as the model runs."""
    ctx, f0 = cfg.context, cfg.num_initial_filters
    L, cin, flops = in_len, cfg.num_channels, 0

    def conv(L, K, cin, cout):
        L_out = L - K + 1 if ctx else L
        return L_out, 2 * L_out * K * cin * cout

    skips = []
    for i in range(cfg.num_layers):
        cout = f0 + f0 * i
        L, fl = conv(L, cfg.filter_size, cin, cout)
        flops += fl
        skips.append((L, cout))
        L, cin = (L + 1) // 2, cout
    cout = f0 + f0 * cfg.num_layers
    L, fl = conv(L, cfg.filter_size, cin, cout)
    flops += fl
    cin = cout
    for i in range(cfg.num_layers):
        L = 2 * L - 1 if ctx else 2 * L
        skip_ch = skips[-i - 1][1]
        L, fl = conv(L, cfg.merge_filter_size, skip_ch + cin, skip_ch)
        flops += fl
        cin = skip_ch
    n_out = (cfg.num_sources if cfg.output_type == "direct"
             else cfg.num_sources - 1)
    _, fl = conv(L, cfg.output_filter_size, cin + cfg.num_channels,
                 cfg.num_channels)
    return flops + n_out * fl


# -- the run -----------------------------------------------------------------
def power_limit() -> Optional[str]:
    """nvidia-smi's "name, power.limit" line of the first card, if any."""
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def run(smoke: bool = False, reps: Optional[tuple] = None,
        budget_s: float = 240.0, phase: Optional[Dict] = None,
        partial: Optional[Dict] = None) -> Dict:
    """Every measurement of the bench; returns the JSON record. ``reps``
    (min, max) bounds the interleaved e2e pairs; ``phase`` and ``partial``
    are filled as the run goes (for a watchdog's report)."""
    from waveunet_tpu_torch.config import get_config
    from waveunet_tpu_torch.infer.engine import Separator
    from waveunet_tpu_torch.models.spectrogram_unet import (
        init_spectrogram_unet)
    from waveunet_tpu_torch.models.waveunet import (apply_waveunet,
                                                    init_waveunet)
    from waveunet_tpu_torch.ops import shapes

    phase = {} if phase is None else phase
    partial = {} if partial is None else partial
    dev = torch.device("cpu" if smoke else "cuda")
    if not smoke and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA card; BENCH_SMOKE=1 "
                           "runs its schema check on the CPU")
    reps_min, reps_max = reps or ((2, 2) if smoke else (14, 40))

    def seeded(cfg):
        return init_waveunet(torch.Generator().manual_seed(0), cfg, dev)

    phase["name"] = "model-init"
    tiny = (dict(num_layers=3, num_frames=1024, num_initial_filters=4)
            if smoke else {})
    frames, batch = (2048, 4) if smoke else (65536, 16)
    cfg = get_config("full_44KHz", infer_num_frames=frames,
                     infer_batch=batch, infer_wire_dtype="int16", **tiny)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    params = seeded(cfg)
    seconds = 4.0 if smoke else 60.0
    sr = cfg.expected_sr
    song = make_bench_song(sr, seconds)
    sep = Separator(cfg, params, device=dev)

    phase["name"] = "engine-warmup"
    sep.separate(song, sr)

    # The bare 16-window forward on device-resident windows.
    phase["name"] = "compute-roof"
    win_in, win_out = shapes.get_padding(cfg, cfg.infer_num_frames)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (cfg.infer_batch, win_in, 2)).astype(np.float32)).to(dev)

    def fwd(p, xx):
        return sum(v.sum() for v in apply_waveunet(p, cfg, xx).values())

    fwd(sep.params, x)
    roof_best = best_pipelined(lambda: fwd(sep.params, x)).best
    roof = cfg.infer_batch * win_out / sr / roof_best
    partial["compute_roof_audio_s_per_s"] = round(roof, 1)

    phase["name"] = "engine-resident-sweep"
    res_fn, _ = sep.resident_sweep(len(song))
    headline = resident_rtf(res_fn, sep.params, sep.stage_resident(song),
                            seconds, reps=5)
    engine_resident = headline.best
    partial[METRIC] = round(engine_resident, 1)

    # The reference's pattern: batch-1 forwards at the 16,384-frame window.
    phase["name"] = "serial-resident-baseline"
    x1 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, in_len, 2)).astype(np.float32)).to(dev)
    fwd(sep.params, x1)
    serial_resident = out_len / sr / best_pipelined(
        lambda: fwd(sep.params, x1)).best
    partial["serial_resident_audio_s_per_s"] = round(serial_resident, 1)

    phase["name"] = "family-m6-resident"
    m6_cfg = get_config("full_multi_instrument", infer_num_frames=frames,
                        infer_batch=batch, infer_wire_dtype="int16", **tiny)
    m6_sep = Separator(m6_cfg, seeded(m6_cfg), device=dev)
    m6_song = make_bench_song(m6_cfg.expected_sr, seconds)
    m6_fn, _ = m6_sep.resident_sweep(len(m6_song))
    m6_rtf = resident_rtf(m6_fn, m6_sep.params,
                          m6_sep.stage_resident(m6_song), seconds).best
    partial["m6_resident_audio_s_per_s"] = round(m6_rtf, 1)

    phase["name"] = "family-u7-resident"
    u7_tiny = (dict(num_layers=3, num_frames=768 * 15 + 1024,
                    num_initial_filters=4) if smoke else {})
    u7_cfg = get_config("unet_spectrogram", infer_batch=(2 if smoke else 8),
                        infer_wire_dtype="int16", **u7_tiny)
    u7_params, u7_state = init_spectrogram_unet(
        torch.Generator().manual_seed(0), u7_cfg, dev)
    u7_sep = Separator(u7_cfg, u7_params, model_state=u7_state, device=dev)
    # U7 is mono: stage the downmixed song, as separate() would
    u7_song = make_bench_song(u7_cfg.expected_sr, seconds)[:, :1]
    u7_fn, _ = u7_sep.resident_sweep(len(u7_song))
    u7_rtf = resident_rtf(u7_fn, u7_sep.params,
                          u7_sep.stage_resident(u7_song), seconds).best
    partial["u7_resident_audio_s_per_s"] = round(u7_rtf, 1)

    # e2e: separate() of the host song (graphs captured) against a serial
    # loop of batch-1 forwards with a host round trip per window, on a
    # 15 s excerpt, interleaved pairs.
    phase["name"] = "e2e-precompile"
    if dev.type == "cuda":
        sep.precompile(max_song_s=seconds)
    sep.separate(song, sr)
    pad = (in_len - out_len) // 2
    base_seconds = 2.0 if smoke else 15.0
    bn = int(base_seconds * sr)
    padded = np.pad(song[:bn], [(pad, pad), (0, 0)])
    positions = [min(p0, bn - out_len) for p0 in range(0, bn, out_len)]

    def timed_engine():
        t0 = time.perf_counter()
        sep.separate(song, sr)
        return time.perf_counter() - t0

    def timed_serial():
        t0 = time.perf_counter()
        for p0 in positions:
            win = torch.from_numpy(padded[p0:p0 + in_len][None]).to(dev)
            out = apply_waveunet(sep.params, cfg, win)
            {k: v.cpu() for k, v in out.items()}
        return time.perf_counter() - t0

    phase["name"] = "serial-baseline-warmup"
    timed_serial()
    phase["name"] = "interleaved-reps"
    engine_times, serial_times = [], []
    t_start = time.perf_counter()
    while len(engine_times) < reps_max and (
            len(engine_times) < reps_min
            or time.perf_counter() - t_start < budget_s):
        engine_times.append(timed_engine())
        serial_times.append(timed_serial())
    n_reps = len(engine_times)
    e_sorted, s_sorted = sorted(engine_times), sorted(serial_times)
    # best-of over the fixed REPS_MIN prefix, so a run that samples more
    # reps does not draw a systematically lower minimum
    elapsed = min(engine_times[:reps_min])
    e2e_rtf = seconds / elapsed
    e2e_serial_rtf = base_seconds / min(serial_times[:reps_min])
    pair_ratios = sorted((seconds / e) / (base_seconds / s)
                         for e, s in zip(engine_times, serial_times))

    phase["name"] = "flop-accounting"
    gflop_per_audio_s = (waveunet_conv_flops(cfg, win_in) / 1e9
                         / (win_out / sr))
    tflops = engine_resident * gflop_per_audio_s / 1e3
    h = sorted(headline.times)
    return {
        "metric": METRIC,
        "value": round(engine_resident, 1),
        "unit": UNIT,
        "vs_baseline": round(engine_resident / serial_resident, 2),
        "value_median": round(h[len(h) // 2], 1),
        "value_spread": round(h[-1] / h[0], 3),
        "serial_resident_audio_s_per_s": round(serial_resident, 1),
        "compute_roof_audio_s_per_s": round(roof, 1),
        "flagship_gflop_per_audio_s": round(gflop_per_audio_s, 3),
        "flagship_tflops_per_s": round(tflops, 1),
        "flagship_mfu_vs_bf16_peak": round(tflops / PEAK_BF16_TFLOPS, 4),
        "flagship_flops_source": "analytic-conv-shapes",
        "m6_resident_audio_s_per_s": round(m6_rtf, 1),
        "u7_resident_audio_s_per_s": round(u7_rtf, 1),
        "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "power_limit": power_limit() if dev.type == "cuda" else None,
        "song_seconds": seconds,
        "infer_num_frames": cfg.infer_num_frames,
        "e2e_rtf": round(e2e_rtf, 3),
        "e2e_vs_baseline": round(e2e_rtf / e2e_serial_rtf, 3),
        "e2e_vs_baseline_paired_median": round(
            pair_ratios[len(pair_ratios) // 2], 3),
        "e2e_serial_baseline_rtf": round(e2e_serial_rtf, 3),
        "e2e_elapsed_s": round(elapsed, 4),
        "e2e_elapsed_median_s": round(e_sorted[len(e_sorted) // 2], 4),
        "e2e_elapsed_spread": round(e_sorted[-1] / e_sorted[0], 2),
        "e2e_serial_median_s": round(s_sorted[len(s_sorted) // 2], 4),
        "e2e_serial_spread": round(s_sorted[-1] / s_sorted[0], 2),
        "e2e_reps": n_reps,
        **({"smoke": True} if smoke else {}),
    }


def main() -> int:
    smoke = os.environ.get("BENCH_SMOKE") == "1"
    budget_s = float(os.environ.get("BENCH_BUDGET_S", 240))
    deadline_s = float(os.environ.get("BENCH_DEADLINE_S",
                                      max(1200.0, budget_s + 900.0)))
    phase, partial = {"name": "start"}, {}
    done = threading.Event()

    # A hung card (or a kernel that never returns) must end in an honest
    # record, not in the caller's timeout.
    def watchdog():
        if done.wait(timeout=deadline_s):
            return
        print(json.dumps({"metric": METRIC, "value": partial.get(METRIC),
                          "unit": UNIT,
                          "error": f"bench stalled in phase "
                                   f"'{phase['name']}' past {deadline_s} s",
                          **partial}), flush=True)
        os._exit(5)

    threading.Thread(target=watchdog, daemon=True).start()
    try:
        rec = run(smoke=smoke, budget_s=budget_s, phase=phase,
                  partial=partial)
    except Exception as e:  # one line that says why, then a failing exit
        done.set()
        print(json.dumps({"metric": METRIC, "value": None, "unit": UNIT,
                          "error": f"{type(e).__name__} in phase "
                                   f"'{phase['name']}': {e}", **partial}),
              flush=True)
        return 1
    done.set()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
