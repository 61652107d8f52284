#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit and PyTorch; it needs no network, no JAX and no file outside the
checkout (audio and weights are made from a seed). Phases, each printing its
wall seconds, each under a watchdog:

  1. the card's name and power limit, as nvidia-smi gives them;
  2. build the CUDA kernels (one nvcc process a source, all at once, then
     one link; no PyTorch headers), printing ptxas's registers and spills;
  3. each kernel against its plain PyTorch version on the card, at the shapes
     the full_44KHz main path gives it (the channel-major im2col conv at the
     channel-major counterparts of the conv's shapes), and both convs also
     at the edges of their launch plans (Cin 1, 3 and 34, K 1 to 16, Cout
     1, 34 and 312, L_out 1 and 21 at B 16, B 1, a decimated view, with and
     without split-K; each split shape run twice and compared bit for bit;
     the im2col conv also at rows of 0 and 3 mod 4 floats), with each
     launch's plan and dynamic shared memory and each version's distance
     from an fp64 evaluation (the im2col kernel's at most twice the plain
     version's);
  4. each kernel timed with CUDA events beside its bound, its plain version
     and one PyTorch library call computing the same function (cuDNN
     conv1d + leaky_relu for the convs, a depthwise conv_transpose1d for the
     interpolation), each library call first held against the plain version;
  4a. im2col: the counterpart of tools/pallas_im2col_bench.py, the entry
     point of the channel-major im2col conv kernel: the 12 down-path conv
     shapes of full_44KHz at the training window (16,384 frames, input
     147,443) and batch 16, each held against the plain version (with its
     plan, its distance from fp64 and a bitwise repeat of split plans) and
     against the channel-last conv kernel, and timed beside its bound, the
     plain version, cuDNN and the channel-last kernel;
  5. serve full_44KHz at full width (12 layers, 24 filters, 65,536-frame
     window, batch 16, seeded random weights): three separate() requests of
     synthesised stereo 44.1 kHz clips (2 s, 10 s, 30 s), each served three
     times; the kernels' launch counts over those requests; one chunk's
     forward and the 2 s request held against the plain PyTorch path on the
     card; the im2col kernel is launched by none of them;
  6. where the time goes: each kernel launch of one 16-window forward timed
     by CUDA events, beside its bound, and its plain version and library
     call timed on the same inputs; the im2col kernel run and timed on a
     channel-major copy of each conv launch's input and held against the
     conv kernel's output; each request's forward chunks timed
     on the device beside its wall time; and a small
     configuration served on the card and on the CPU (the plain path the
     CPU tests hold against the JAX package), compared;
  7. presets: every Wave-U-Net preset, shrunk to 4 layers with its own
     filters and widths, serving a 1.5 s clip at infer_batch 4 on the card
     and on the CPU (the plain path), compared;
  8. sweep: the bench's resident sweep (full_44KHz, 65,536-frame window,
     batch 16, the 60 s bench song) on both wires, eager and as one CUDA
     graph (identical bit for bit), against separate() on the card, timed,
     its kernel launches counted from the graph's replays; and the int16
     wire's dequantisers on the card bit for bit against the CPU over all
     65,536 int16 values, with the network input of one staged song;
  9. graphs: precompile() on the served engine, then the three requests
     again through the CUDA graphs and pinned copies, identical bit for bit
     to the eager run; walls, device time and idle share beside the eager
     requests';
  10. spectro: U7 at full width separating 30 s on the card and on the CPU,
     compared, and through its CUDA graphs (bit for bit);
  11. stream: full_44KHz streamed in uneven pushes, against the offline
     output on the card, and batched drains against serial ones;
  12. bench: the port's bench (waveunet_tpu_torch/bench.py) at its
     REPS_MIN e2e pairs, its JSON line checked key by key;
  13. train: full_44KHz training at full width from a synthesised song
     cache (4 train, 2 valid, 1 test songs of 8 s, stereo 44.1 kHz, made
     with the port's own preprocess): the device banks (the sampler's
     batches on the card equal to the CPU's), one batch-2 step on the card
     against the CPU (the loss, every gradient against fp64 beside the CPU
     fp32 distance, every gradient non-zero, the Adam update; the same
     step with TF32 convs as the control the checks must reject), optimise()
     through both rounds (batch 16, then 32; epoch_it cut) with
     checkpoints, best.txt and a resume that goes on from the saved Adam
     slots, the fused epoch (CUDA graph replays) bit for bit against the
     eager loop, step times split into sampling, forward, backward and
     Adam, steps/s, trained audio-s/s, the idle share over a fused chunk,
     peak memory, and validation through the conv and interp kernels
     against the plain path (every eval batch's outputs and loss, and the
     mean), with its launch counts;
  14. eval: a synthesised MUSDB test set (2 songs of 20 s, stereo 44.1 kHz,
     noise stems, one song's vocals silent for 2 s and near-silent for 2 s)
     through evaluate_musdb with full_44KHz at full width, once per scorer
     (host fp64 in its spawned pool, tpu_bss=True, tpu_bss="f64"), each
     run's launches equal to its chunks x (25, 12); the same separations
     against the plain path; the fp32 scorer against the host on every
     window its gate left on the card (0.01 dB + rtol 1e-4) and equal to
     it on the flagged ones, the fp64 scorer against the host's exact
     assembly (1e-3 dB) and its SDR against the host's (1e-9 dB);
     windows/s and the separation and scoring walls per track;
  15. cli: predict and evaluate (random_init=1, max_tracks=1, tpu_bss=1)
     through cli.main, their WAVs and JSON equal byte for byte to the
     library calls'.

Each of the paths of phases 5, 8 to 15 and 13's optimise() is driven with
the kernels' launch counts set to 0 just before it and read just after (a
graph replay adds the launches its capture recorded).

The line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Without a card, or run outside a
checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 1234

# Per-phase watchdog limits in seconds; the whole run aims at under 10 min.
LIMITS = {"nvidia-smi": 30, "build": 400, "kernels": 120, "timing": 180,
          "im2col": 240, "serve": 420, "forward": 300, "presets": 240,
          "sweep": 240, "graphs": 240, "spectro": 300, "stream": 240,
          "m6": 120, "bench": 420, "train": 150, "eval": 420, "cli": 180}

# Peaks of one H100 SXM (NVIDIA data sheet) for the bounds: dense TF32 on
# the tensor cores (the conv kernel computes in 3xTF32: three TF32 products
# per fp32 product), fp32 on the CUDA cores (the interpolation, and the
# conv's earlier CUDA-core bound, kept beside the new one) and HBM3.
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

CONV_ATOL = 1e-4     # fp32 sums of up to 3,000 products in another order
INTERP_ATOL = 1e-6   # the same rounded operations; expf may differ by an ulp
INTERP_LIB_ATOL = 1e-5  # cuDNN may fuse the two products (one rounding less)
FORWARD_ATOL = 1e-4  # 25 conv layers of such sums, then tanh
SMALL_ATOL = 2e-5    # the CPU tests' forward tolerance, at a small width
REPEATS = 3          # each request is served this many times; median wall
SWEEP_ATOL = 2e-6    # sweep vs separate, conv sources (tests/test_infer.py)
SWEEP_DIFF_ATOL = 4e-5  # the int16 difference source: mix quantised or not
SPECTRO_ATOL = 5e-5  # U7 on the card vs the CPU path (tests/test_compat.py)
STREAM_ATOL = 1e-5   # stream vs offline (tests/test_streaming.py)
STREAM_BATCH_ATOL = 1e-6  # batched vs serial drains where conv plans differ
BENCH_REPS_MIN = 14  # the bench's REPS_MIN
WIRE_STEP = 1.0 / 32767  # one int16 step: two outputs within a tolerance
                         # of each other may round to neighbouring steps


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


@contextlib.contextmanager
def phase(name: str):
    """Time a phase and kill the run if it hangs. signal.alarm ends a phase
    stuck in Python; faulthandler's own thread ends one stuck inside a CUDA
    call that never returns to the interpreter."""
    def on_alarm(signum, frame):
        print(f"chip_smoke: FAIL: phase {name!r} exceeded {LIMITS[name]} s",
              file=sys.stderr, flush=True)
        os._exit(124)

    print(f"phase {name}: start", flush=True)
    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(LIMITS[name])
    faulthandler.dump_traceback_later(LIMITS[name] + 20, exit=True)
    t0 = time.perf_counter()
    yield
    signal.alarm(0)
    faulthandler.cancel_dump_traceback_later()
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def time_cuda(fn, torch, min_s: float = 0.2, max_iters: int = 50) -> float:
    """Mean milliseconds per call, by CUDA events around a run of calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = max(time.perf_counter() - t0, 1e-6)
    iters = int(min(max_iters, max(3, min_s / once)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    t_ops = flops / peak
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def conv_library_ncl(x, w_lib, b):
    """One cuDNN conv (TF32 off) and leaky_relu over channel-major x
    [B, Cin, L], with w_lib = w.permute(2, 1, 0) ([Cout, Cin, K]) prepared
    once; channel-major output. A yardstick only: the port never calls it."""
    import torch.nn.functional as F
    return F.leaky_relu(F.conv1d(x, w_lib, b), 0.2)


def conv_library(x, w_lib, b):
    """conv_library_ncl over channel-last x [B, L, Cin] (a transposed view);
    channel-major output."""
    return conv_library_ncl(x.transpose(1, 2), w_lib, b)


def channel_major(x):
    """A channel-major copy [B, C, L] of channel-last x [B, L, C]. A
    decimated view x = full[:, ::s, :] is copied undecimated and returned as
    the view [:, :, ::s] of the copy, as the model reads it."""
    B, L, C = x.shape
    s = x.stride(1) // C if L > 1 else 1
    if s > 1 and x.stride(1) == s * C and x.stride(2) == 1:
        full = x.as_strided((B, (L - 1) * s + 1, C),
                            (x.stride(0), C, 1))
        return full.transpose(1, 2).contiguous()[:, :, ::s]
    return x.transpose(1, 2).contiguous()


def conv_bound(x_numel, K, cin, cout, y_numel):
    """The least time of one conv launch at fp32 accuracy: the larger of its
    3xTF32 operations (3 x its FLOPs) over the dense TF32 peak and its bytes
    (each input read once, the output written once) over HBM's rate; with
    what bounds it, and the CUDA-core bound (FLOPs over the fp32 peak, or
    the bytes) that the earlier fp32 kernels were measured against."""
    flops = 2.0 * y_numel * K * cin
    nbytes = 4.0 * (x_numel + K * cin * cout + cout + y_numel)
    ms, by = bound_ms(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
    return ms, by, bound_ms(flops, nbytes)[0]


# The conv kernel at the edges of its launch plan: name, B, L_out, Cin,
# Cout, K, decimated view. Cin 1 and 3 and 34 stage rows 4 or 8 bytes at a
# time; Cin 2 and 6 with rows back to back take the flat reduction.
CONV_EDGES = [
    ("cin1_k15", 16, 300, 1, 24, 15, False),
    ("cin3_k5_cout34", 4, 500, 3, 34, 5, False),
    ("cin34_k1_cout34", 4, 400, 34, 34, 1, False),
    ("cin6_k16_flat", 3, 1000, 6, 48, 16, False),
    ("cout1_k16", 2, 333, 24, 1, 16, False),
    ("cout312_b1_view", 1, 777, 48, 312, 15, True),
    ("lout1_b16", 16, 1, 288, 312, 15, True),
    ("lout21_b16", 16, 21, 600, 288, 5, False),
]


def conv_edges(conv1d_fused, randn, conv_params, conv_shapes, B, torch):
    """The conv kernel against its plain version (CONV_ATOL) at CONV_EDGES
    and at the main-path shapes, each with its launch plan and both
    versions' distance from an fp64 evaluation of the same sum; every shape
    whose plan splits the reduction is launched twice and must give the
    same bits. At least one shape with and one without a split must be
    among them."""
    cases = list(CONV_EDGES) + [
        (name, B, L - K + 1, cin, cout, K, dec)
        for name, L, K, cin, cout, dec in conv_shapes]
    rows, split_seen = [], set()
    for name, Bx, L_out, cin, cout, K, dec in cases:
        L = L_out + K - 1
        full = randn(Bx, 2 * L - 1 if dec else L, cin)
        x = full[:, ::2, :] if dec else full
        w, b = conv_params(K, cin, cout)
        plan = conv1d_fused.plan_launch(Bx, L_out, cin, cout, K, x.stride(1))
        got = conv1d_fused.conv1d_lrelu_cuda(x, w, b)
        want = conv1d_fused.conv1d_lrelu_plain(x, w, b)
        again = (conv1d_fused.conv1d_lrelu_cuda(x, w, b)
                 if plan.splits > 1 else got)
        exact = conv1d_fused.conv1d_lrelu_plain(x.double(), w.double(),
                                                b.double())
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same = torch.equal(got, again)
        row = {"shape": name, "x": list(x.shape), "K": K, "cin": cin,
               "cout": cout, "decimated": dec, "max_abs_err": err,
               # both fp32 versions against the same sum in fp64
               "err_vs_fp64": (got - exact).abs().max().item(),
               "plain_err_vs_fp64": (want - exact).abs().max().item(),
               "tile_n": plan.tile_n, "tile_m": plan.tile_m,
               "flat": plan.flat, "splits": plan.splits, "grid": plan.grid,
               "smem_bytes": plan.smem_bytes, "bitwise_repeat": same}
        print(f"conv1d_lrelu edge {json.dumps(row)} (tol {CONV_ATOL})",
              flush=True)
        if not err <= CONV_ATOL:
            fail(f"conv1d_lrelu at {name} disagrees with its plain version")
        if not same:
            fail(f"conv1d_lrelu at {name} (split {plan.splits}) gave other "
                 f"bits on a second run")
        split_seen.add(plan.splits > 1)
        rows.append(row)
        del full, x, got, want, again, exact
    if split_seen != {True, False}:
        fail("the edge shapes did not cover both a split and an unsplit plan")
    return rows


# The im2col conv kernel at the edges of its launch plan: name, B, L_out,
# Cin, Cout, K, decimated view. Cin 1 and 3 take the flat reduction, 34 a
# ragged 8-channel chunk; input rows of length 1024 and 1023 (0 and 3 mod 4).
IM2COL_EDGES = [
    ("cin1_k15", 16, 300, 1, 24, 15, False),
    ("cin3_k5_cout34", 4, 500, 3, 34, 5, False),
    ("cin34_k1_cout34", 4, 400, 34, 34, 1, False),
    ("cout1_k16", 2, 333, 24, 1, 16, False),
    ("cout312_b1_view", 1, 777, 48, 312, 15, True),
    ("lout1_b16", 16, 1, 288, 312, 15, True),
    ("lout21_b16", 16, 21, 600, 288, 5, False),
    ("len1024_cout72", 2, 1010, 40, 72, 15, False),
    ("len1023_cout96", 2, 1009, 40, 96, 15, False),
]


def im2col_plan(plan):
    """The launch-plan fields chip_smoke.py prints for the im2col kernel."""
    return {"tile_m": plan.tile_m, "tile_n": plan.tile_n, "flat": plan.flat,
            "taps": plan.taps, "chunks": plan.chunks, "splits": plan.splits,
            "grid": plan.grid, "smem_bytes": plan.smem_bytes}


def im2col_check(conv1d_im2col, name, x, w, b, torch, got=None,
                 plain=None):
    """The im2col kernel against its plain version (CONV_ATOL) on one input,
    with both versions' distance from an fp64 evaluation of the same sum;
    the kernel's may be at most twice the plain version's. A plan that
    splits the reduction is launched twice and must give the same bits.
    Returns the row of numbers (got, plain: the kernel's and the plain
    version's outputs, when the caller has them)."""
    Bx, cin, L = x.shape
    K, _, cout = w.shape
    plan = conv1d_im2col.plan_launch(Bx, L - K + 1, cin, cout, K)
    if got is None:
        got = conv1d_im2col.conv1d_lrelu_im2col_cuda(x, w, b)
    want = (plain if plain is not None
            else conv1d_im2col.conv1d_lrelu_im2col_plain(x, w, b))
    again = (conv1d_im2col.conv1d_lrelu_im2col_cuda(x, w, b)
             if plan.splits > 1 else got)
    exact = conv1d_im2col.conv1d_lrelu_im2col_plain(x.double(), w.double(),
                                                    b.double())
    torch.cuda.synchronize()
    row = {"max_abs_err": (got - want).abs().max().item(),
           # both fp32 versions against the same sum in fp64
           "err_vs_fp64": (got - exact).abs().max().item(),
           "plain_err_vs_fp64": (want - exact).abs().max().item(),
           "bitwise_repeat": torch.equal(got, again),
           "plan": im2col_plan(plan)}
    del got, want, again, exact
    if not row["max_abs_err"] <= CONV_ATOL:
        fail(f"conv1d_lrelu_im2col at {name} disagrees with its plain "
             f"version: {row['max_abs_err']:.3e} (tol {CONV_ATOL})")
    if not row["bitwise_repeat"]:
        fail(f"conv1d_lrelu_im2col at {name} (split {plan.splits}) gave "
             f"other bits on a second run")
    if not row["err_vs_fp64"] <= 2 * row["plain_err_vs_fp64"]:
        fail(f"conv1d_lrelu_im2col at {name}: {row['err_vs_fp64']:.3e} from "
             f"fp64, more than twice the plain version's "
             f"{row['plain_err_vs_fp64']:.3e}")
    return row


def im2col_edges(conv1d_im2col, randn, conv_params, torch):
    """The im2col kernel at IM2COL_EDGES (im2col_check), each printed with
    its launch plan. At least one shape with and one without a split, and
    one flat plan, must be among them."""
    rows, seen = [], set()
    for name, Bx, L_out, cin, cout, K, dec in IM2COL_EDGES:
        L = L_out + K - 1
        full = randn(Bx, cin, 2 * L - 1 if dec else L)
        x = full[:, :, ::2] if dec else full
        w, b = conv_params(K, cin, cout)
        row = {"shape": name, "x": list(x.shape), "K": K, "cin": cin,
               "cout": cout, "decimated": dec,
               **im2col_check(conv1d_im2col, name, x, w, b, torch)}
        print(f"conv1d_lrelu_im2col edge {json.dumps(row)} (tol "
              f"{CONV_ATOL})", flush=True)
        seen |= {("split", row["plan"]["splits"] > 1),
                 ("flat", row["plan"]["flat"])}
        rows.append(row)
        del full, x
    if not {("split", True), ("split", False), ("flat", True)} <= seen:
        fail("the im2col edge shapes did not cover a split, an unsplit and "
             "a flat plan")
    return rows


def im2col_tool_shapes(cfg, in_len):
    """The down-path conv shapes of tools/pallas_im2col_bench.py: name, input
    length, K, Cin, Cout for each layer, from the input length in_len."""
    L, cin, rows = in_len, cfg.num_channels, []
    for i in range(cfg.num_layers):
        cout = cfg.num_initial_filters * (i + 1)
        rows.append((f"down_{i}", L, cfg.filter_size, cin, cout))
        L = (L - cfg.filter_size) // 2 + 1
        cin = cout
    return rows


def interp_library_weights(w):
    """Per-channel taps [C, 1, 3] = [1 - s, 1, s], s = sigmoid(w), of the
    depthwise transposed conv that computes the learned interpolation."""
    import torch
    s = 1.0 / (1.0 + torch.exp(-w))
    return torch.stack([1.0 - s, torch.ones_like(s), s], dim=1)[:, None, :]


def interp_library(x, wt, context):
    """The learned x2 interpolation as one PyTorch call: a depthwise
    conv_transpose1d of stride 2 and padding 1 over x [B, n, C] puts x[i] at
    2i and s*x[i] + (1-s)*x[i+1] at 2i+1, length 2n-1; output_padding=1
    adds the tail s*x[n-1] of the mode without context. Channel-major
    output. A yardstick only: the port never calls it."""
    import torch.nn.functional as F
    return F.conv_transpose1d(x.transpose(1, 2), wt, stride=2, padding=1,
                              output_padding=0 if context else 1,
                              groups=x.shape[2])


def main_path_shapes(cfg, in_len):
    """Input lengths and widths of the conv and interp layers that phase 3
    checks, walked through the network from the window's input length."""
    L = in_len
    lengths = []  # conv input length per down layer
    for i in range(cfg.num_layers):
        lengths.append(L)
        L = L - cfg.filter_size + 1
        L = (L - 1) // 2 + 1
    bott_in = L
    bott_out = L - cfg.filter_size + 1
    f = cfg.num_initial_filters
    last = cfg.num_layers - 1
    # interp_11 reads the output of up_10, which has 2 * num_initial_filters
    # channels; walk the up path to its length.
    n = bott_out
    up_lens = []
    for i in range(cfg.num_layers):
        n = 2 * n - 1
        up_lens.append(n)
        n = n - cfg.merge_filter_size + 1
    conv = [
        # name, L (conv input), K, Cin, Cout, decimated input view
        ("down_0", lengths[0], cfg.filter_size, cfg.num_channels, f, False),
        (f"down_{last}", lengths[last], cfg.filter_size, f * last,
         f * (last + 1), True),
        ("bottleneck", bott_in, cfg.filter_size, f * (last + 1),
         f * (last + 2), True),
        ("up_0", up_lens[0], cfg.merge_filter_size,
         f * (last + 1) + f * (last + 2), f * (last + 1), False),
    ]
    interp = [
        ("interp_0", bott_out, f * (last + 2)),
        (f"interp_{last}", up_lens[last - 1] - cfg.merge_filter_size + 1,
         2 * f),
    ]
    return conv, interp


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "waveunet_tpu_torch")):
        fail("waveunet_tpu_torch/ is not beside chip_smoke.py: run it from a "
             "checkout of the repository", 2)
    sys.path.insert(0, HERE)
    import numpy as np

    from waveunet_tpu_torch.config import get_config
    from waveunet_tpu_torch.infer.engine import Separator, window_positions
    from waveunet_tpu_torch.models import waveunet as model
    from waveunet_tpu_torch.ops import shapes
    from waveunet_tpu_torch.ops import kernels
    from waveunet_tpu_torch.ops.kernels import (build, conv1d_fused,
                                                conv1d_im2col, interp)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    with phase("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=LIMITS["nvidia-smi"], check=True).stdout.strip()
        print(smi, flush=True)

    with phase("build"):
        built = build.build()
        build.load()
        if built.seconds is not None:
            print(f"build: one nvcc process a source, all at once, and one "
                  f"link, over "
                  f"{[os.path.basename(s) for s in build.sources()]}: "
                  f"{built.seconds:.3f} s", flush=True)
            for line in built.log.splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    print(f"  ptxas: {line.strip()}")
        else:
            print("build: library already built (hash unchanged)")

    cfg = get_config("full_44KHz")
    sep = Separator(cfg, model.init_waveunet(gen, cfg, dev))
    conv_shapes, interp_shapes = main_path_shapes(cfg, sep.in_len)
    B = cfg.infer_batch

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def conv_params(K, cin, cout):
        """Glorot-uniform w [K, cin, cout] and a small bias, on the card."""
        lim = float(np.sqrt(6.0 / (K * (cin + cout))))
        w = (torch.rand(K, cin, cout, generator=gen) * 2 * lim - lim).to(dev)
        return w, 0.1 * randn(cout)

    conv_cases, interp_cases, im2col_cases = [], [], []
    launches_by_phase = {}
    with phase("kernels"):
        conv1d_im2col.launches = 0
        for name, L, K, cin, cout, decimated in conv_shapes:
            # a decimated layer reads the strided view of a 2x longer map
            full = randn(B, 2 * L - 1 if decimated else L, cin)
            x = full[:, ::2, :] if decimated else full
            w, b = conv_params(K, cin, cout)
            got = conv1d_fused.conv1d_lrelu_cuda(x, w, b)
            want = conv1d_fused.conv1d_lrelu_plain(x, w, b)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            print(f"conv1d_lrelu {name}: x {tuple(x.shape)} "
                  f"{'(strided view) ' if decimated else ''}K={K} "
                  f"{cin}->{cout}: max_abs_err {err:.3e} (tol {CONV_ATOL})",
                  flush=True)
            if not err <= CONV_ATOL:
                fail(f"conv1d_lrelu {name} disagrees with its plain version")
            w_lib = w.permute(2, 1, 0).contiguous()  # [Cout, Cin, K], once
            lib = conv_library(x, w_lib, b).transpose(1, 2)
            lib_err = (lib - want).abs().max().item()
            print(f"  library conv1d+leaky_relu {name} vs plain: max_abs_err "
                  f"{lib_err:.3e} (tol {CONV_ATOL})", flush=True)
            if not lib_err <= CONV_ATOL:
                fail(f"the library conv at {name} disagrees with the plain "
                     f"version")
            conv_cases.append((name, x, w, b, w_lib, err))
        edge_rows = conv_edges(conv1d_fused, randn, conv_params, conv_shapes,
                               B, torch)
        for name, L, K, cin, cout, decimated in conv_shapes:
            # channel-major; a decimated layer reads x[:, :, ::2] of a map
            full = randn(B, cin, 2 * L - 1 if decimated else L)
            x = full[:, :, ::2] if decimated else full
            w, b = conv_params(K, cin, cout)
            got = conv1d_im2col.conv1d_lrelu_im2col_cuda(x, w, b)
            want = conv1d_im2col.conv1d_lrelu_im2col_plain(x, w, b)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            print(f"conv1d_lrelu_im2col {name}: x {tuple(x.shape)} "
                  f"{'(strided view) ' if decimated else ''}K={K} "
                  f"{cin}->{cout}: max_abs_err {err:.3e} (tol {CONV_ATOL})",
                  flush=True)
            if not err <= CONV_ATOL:
                fail(f"conv1d_lrelu_im2col {name} disagrees with its plain "
                     f"version")
            w_lib = w.permute(2, 1, 0).contiguous()  # [Cout, Cin, K], once
            lib_err = (conv_library_ncl(x, w_lib, b) - want).abs().max().item()
            print(f"  library conv1d+leaky_relu (NCL) {name} vs plain: "
                  f"max_abs_err {lib_err:.3e} (tol {CONV_ATOL})", flush=True)
            if not lib_err <= CONV_ATOL:
                fail(f"the NCL library conv at {name} disagrees with the "
                     f"plain version")
            im2col_cases.append((name, x, w, b, w_lib, err))
            del got, want
        im2col_edge_rows = im2col_edges(conv1d_im2col, randn, conv_params,
                                        torch)
        for name, n, C in interp_shapes:
            x = randn(B, n, C)
            w = randn(C)
            got = interp.learned_interp_cuda(x, w, cfg.context)
            want = interp.learned_interp_plain(x, w, cfg.context)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            print(f"learned_interp {name}: x {tuple(x.shape)}: max_abs_err "
                  f"{err:.3e} (tol {INTERP_ATOL})", flush=True)
            if not err <= INTERP_ATOL:
                fail(f"learned_interp {name} disagrees with its plain version")
            wt = interp_library_weights(w)  # [C, 1, 3], once
            lib = interp_library(x, wt, cfg.context).transpose(1, 2)
            lib_err = (lib - want).abs().max().item()
            print(f"  library conv_transpose1d {name} vs plain: max_abs_err "
                  f"{lib_err:.3e} (tol {INTERP_LIB_ATOL})", flush=True)
            if not lib_err <= INTERP_LIB_ATOL:
                fail(f"the library interpolation at {name} disagrees with the "
                     f"plain version")
            interp_cases.append((name, x, w, wt, err))

    conv_rows, interp_rows, im2col_rows = [], [], []
    with phase("timing"):
        for name, x, w, b, w_lib, err in conv_cases:
            Bx, L, cin = x.shape
            K, _, cout = w.shape
            L_out = L - K + 1
            row = {
                "shape": name, "x": list(x.shape), "K": K, "cin": cin,
                "cout": cout, "max_abs_err": err,
                "ms": time_cuda(lambda: conv1d_fused.conv1d_lrelu_cuda(
                    x, w, b), torch),
                "plain_ms": time_cuda(lambda: conv1d_fused.conv1d_lrelu_plain(
                    x, w, b), torch),
                "library_ms": time_cuda(lambda: conv_library(x, w_lib, b),
                                        torch),
            }
            (row["bound_ms"], row["bound_by"],
             row["bound_fp32_cores_ms"]) = conv_bound(
                Bx * L * cin, K, cin, cout, Bx * L_out * cout)
            conv_rows.append(row)
            print(f"time conv1d_lrelu {name}: {json.dumps(row)}", flush=True)
        for name, x, w, b, w_lib, err in im2col_cases:
            Bx, cin, L = x.shape
            K, _, cout = w.shape
            row = {
                "shape": name, "x": list(x.shape), "K": K, "cin": cin,
                "cout": cout, "max_abs_err": err,
                "ms": time_cuda(lambda: conv1d_im2col.conv1d_lrelu_im2col_cuda(
                    x, w, b), torch),
                "plain_ms": time_cuda(
                    lambda: conv1d_im2col.conv1d_lrelu_im2col_plain(x, w, b),
                    torch),
                "library_ms": time_cuda(lambda: conv_library_ncl(x, w_lib, b),
                                        torch),
            }
            (row["bound_ms"], row["bound_by"],
             row["bound_fp32_cores_ms"]) = conv_bound(
                Bx * L * cin, K, cin, cout, Bx * (L - K + 1) * cout)
            im2col_rows.append(row)
            print(f"time conv1d_lrelu_im2col {name}: {json.dumps(row)}",
                  flush=True)
        for name, x, w, wt, err in interp_cases:
            Bx, n, C = x.shape
            n_out = 2 * n - 1 if cfg.context else 2 * n
            row = {
                "shape": name, "x": list(x.shape), "max_abs_err": err,
                "ms": time_cuda(lambda: interp.learned_interp_cuda(
                    x, w, cfg.context), torch),
                "plain_ms": time_cuda(lambda: interp.learned_interp_plain(
                    x, w, cfg.context), torch),
                "library_ms": time_cuda(lambda: interp_library(
                    x, wt, cfg.context), torch),
            }
            row["bound_ms"], row["bound_by"] = bound_ms(
                3.0 * Bx * (n - 1) * C, 4.0 * (Bx * n * C + C
                                               + Bx * n_out * C))
            interp_rows.append(row)
            print(f"time learned_interp {name}: {json.dumps(row)}", flush=True)

    launches_by_phase["kernels+timing"] = conv1d_im2col.launches

    tool_rows = []
    with phase("im2col"):
        # the count of this path's run: one launch per tool shape, read
        # around it; the checks' and timings' launches are left out
        conv1d_im2col.launches = driven = 0
        tool_in_len, _ = shapes.get_padding(cfg, cfg.num_frames)
        for name, L, K, cin, cout in im2col_tool_shapes(cfg, tool_in_len):
            x = randn(B, cin, L)
            w, b = conv_params(K, cin, cout)
            x_cl = x.transpose(1, 2).contiguous()  # the channel-last kernel's
            w_lib = w.permute(2, 1, 0).contiguous()
            before = conv1d_im2col.launches
            got = conv1d_im2col.conv1d_lrelu_im2col_cuda(x, w, b)
            driven += conv1d_im2col.launches - before
            want = conv1d_im2col.conv1d_lrelu_im2col_plain(x, w, b)
            cl = conv1d_fused.conv1d_lrelu_cuda(x_cl, w, b).transpose(1, 2)
            lib = conv_library_ncl(x, w_lib, b)
            torch.cuda.synchronize()
            row = {"layer": name, "x": [B, cin, L], "K": K, "cin": cin,
                   "cout": cout,
                   "channel_last_err": (got - cl).abs().max().item(),
                   "library_err": (lib - want).abs().max().item()}
            del cl, lib
            row.update(im2col_check(conv1d_im2col, name, x, w, b, torch,
                                    got=got, plain=want))
            del got, want
            for key, what in (("channel_last_err", "the channel-last kernel"),
                              ("library_err", "the plain version (library)")):
                if not row[key] <= CONV_ATOL:
                    fail(f"conv1d_lrelu_im2col at {name}: {key} "
                         f"{row[key]:.3e} against {what} (tol {CONV_ATOL})")
            row["ms"] = time_cuda(
                lambda: conv1d_im2col.conv1d_lrelu_im2col_cuda(x, w, b), torch)
            row["plain_ms"] = time_cuda(
                lambda: conv1d_im2col.conv1d_lrelu_im2col_plain(x, w, b),
                torch)
            row["library_ms"] = time_cuda(
                lambda: conv_library_ncl(x, w_lib, b), torch)
            row["conv1d_lrelu_ms"] = time_cuda(
                lambda: conv1d_fused.conv1d_lrelu_cuda(x_cl, w, b), torch)
            (row["bound_ms"], row["bound_by"],
             row["bound_fp32_cores_ms"]) = conv_bound(
                x.numel(), K, cin, cout, B * (L - K + 1) * cout)
            tool_rows.append(row)
            print(f"im2col {name}: {json.dumps(row)}", flush=True)
            del x, x_cl
            torch.cuda.empty_cache()
        if driven != len(tool_rows):
            fail(f"phase im2col launched the im2col kernel {driven} times "
                 f"over {len(tool_rows)} shapes")
        launches_by_phase["im2col"] = driven
        launches_by_phase["im2col_with_checks_and_timing"] = (
            conv1d_im2col.launches)
        tool_sum = {k: sum(r[k] for r in tool_rows)
                    for k in ("ms", "plain_ms", "library_ms",
                              "conv1d_lrelu_ms", "bound_ms")}
        print(f"im2col over the {len(tool_rows)} tool shapes: "
              f"{json.dumps(tool_sum)}", flush=True)

    with phase("serve"):
        sr = cfg.expected_sr

        def clip(seconds):
            t = np.arange(int(seconds * sr)) / sr
            tone = 0.3 * np.sin(2 * np.pi * 220.0 * t)[:, None]
            noise = 0.1 * rng.standard_normal((t.size, 2))
            return (tone + noise).astype(np.float32)

        requests = [clip(2.0), clip(10.0), clip(30.0)]
        sep.separate(requests[0], sr)  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()

        n_chunks = 0
        conv1d_fused.launches = interp.launches = conv1d_im2col.launches = 0
        served = []
        for audio in requests:
            n = audio.shape[0]
            n_win = len(window_positions(max(n, sep.in_len), sep.out_len))
            sizes = sep._chunk_sizes(n_win)
            walls = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                out = sep.separate(audio, sr)
                walls.append(time.perf_counter() - t0)
                n_chunks += len(sizes)
                for name in cfg.source_names:
                    v = out[name]
                    if v.shape != (n, cfg.num_channels):
                        fail(f"{name}: shape {v.shape}, expected "
                             f"{(n, cfg.num_channels)}")
                    if not np.isfinite(v).all():
                        fail(f"{name}: non-finite output")
            dt = float(np.median(walls))
            served.append({"seconds": n / sr, "windows": n_win,
                           "chunks": sizes, "wall_s": dt, "walls_s": walls,
                           "audio_s_per_s": n / sr / dt})
            print(f"serve {n / sr:.1f} s stereo: {n_win} windows in chunks "
                  f"{sizes}: median {dt:.4f} s wall of {REPEATS} "
                  f"({', '.join(f'{w:.4f}' for w in walls)}), "
                  f"{n / sr / dt:.1f} audio-s/s", flush=True)
        launches = {"conv1d_lrelu": conv1d_fused.launches,
                    "learned_interp": interp.launches,
                    "conv1d_lrelu_im2col": conv1d_im2col.launches}
        want = {"conv1d_lrelu": (2 * cfg.num_layers + 1) * n_chunks,
                "learned_interp": cfg.num_layers * n_chunks,
                "conv1d_lrelu_im2col": 0}
        print(f"launches over {n_chunks} forward chunks: {launches} "
              f"(expected {want})", flush=True)
        if launches != want:
            fail("the main path did not launch conv and interp once per "
                 "layer and the im2col conv never")
        total_audio = sum(r["seconds"] for r in served)
        total_wall = sum(r["wall_s"] for r in served)
        print(f"served {total_audio:.1f} audio-s in {total_wall:.4f} s "
              f"(median walls): {total_audio / total_wall:.1f} audio-s/s",
              flush=True)

        # One full chunk (16 windows of the 30 s clip) through the kernels
        # and through the plain versions, on the card.
        padded = np.pad(requests[2], [(sep.pad, sep.pad), (0, 0)])
        pos = window_positions(requests[2].shape[0], sep.out_len)[:B]
        song = torch.from_numpy(padded).to(dev)
        wins = torch.stack([song[p:p + sep.in_len] for p in pos.tolist()])
        fwd_kernel = model.apply_waveunet(sep.params, cfg, wins)
        with plain_path(model, conv1d_fused, interp):
            fwd_plain = model.apply_waveunet(sep.params, cfg, wins)
            plain_outs = [sep.separate(a, sr) for a in requests]
        err = max((fwd_kernel[k] - fwd_plain[k]).abs().max().item()
                  for k in fwd_kernel)
        print(f"forward of {len(pos)} windows, kernels vs plain: max_abs_err "
              f"{err:.3e} (tol {FORWARD_ATOL})", flush=True)
        if not err <= FORWARD_ATOL:
            fail("the kernel forward disagrees with the plain forward")
        # every chunk size the requests launch (and the graphs replay)
        tols = plain_tols(cfg)
        for audio, plain_out in zip(requests, plain_outs):
            kernel_out = sep.separate(audio, sr)
            err2 = {k: float(np.abs(kernel_out[k] - plain_out[k]).max())
                    for k in kernel_out}
            print(f"{audio.shape[0] / sr:.1f} s request, kernels vs plain: "
                  f"max_abs_err {json.dumps(err2)} (tol {json.dumps(tols)})",
                  flush=True)
            if any(not err2[k] <= tols[k] for k in err2):
                fail("the served separation disagrees with the plain path")

    with phase("forward"):
        conv1d_im2col.launches = 0
        forward_rows = forward_breakdown(model, conv1d_fused, interp,
                                         conv1d_im2col, sep, wins, torch)
        launches_by_phase["forward"] = conv1d_im2col.launches
        conv = [r for r in forward_rows if r["kernel"] == "conv1d_lrelu"]
        ip = [r for r in forward_rows if r["kernel"] == "learned_interp"]
        cm = [r for r in forward_rows if r["kernel"] == "conv1d_lrelu_im2col"]
        for r in forward_rows:
            print(f"  {r['layer']:>10} {r['kernel']:<19} x {r['x']}: "
                  f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), {r['flops'] / r['ms'] / 1e9:.2f} "
                  f"TFLOP/s; plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']:.4f} ms"
                  + (f"; alone {r['repeat_ms']:.4f} ms" if "repeat_ms" in r
                     else "")
                  + (f"; plan {json.dumps(r['plan'])}" if "plan" in r
                     else ""), flush=True)
        smem = {}
        for r in conv:
            tn = r["plan"]["tile_n"]
            smem[tn] = max(smem.get(tn, 0), r["plan"]["smem_bytes"])
        print(f"conv1d_lrelu dynamic shared memory by instantiation (tile_n: "
              f"most bytes over the forward's launches): {json.dumps(smem)}",
              flush=True)
        total = forward_rows[0]["forward_ms"]
        conv_ms = sum(r["ms"] for r in conv)
        ip_ms = sum(r["ms"] for r in ip)
        flops = sum(r["flops"] for r in conv)
        summary = {
            "windows": B, "forward_ms": total, "conv1d_lrelu_ms": conv_ms,
            "learned_interp_ms": ip_ms,
            "other_ms": total - conv_ms - ip_ms,
            "conv1d_lrelu_bound_ms": sum(r["bound_ms"] for r in conv),
            "conv1d_lrelu_bound_fp32_cores_ms": sum(r["bound_fp32_cores_ms"]
                                                    for r in conv),
            "conv1d_lrelu_plain_ms": sum(r["plain_ms"] for r in conv),
            "conv1d_lrelu_library_ms": sum(r["library_ms"] for r in conv),
            "learned_interp_plain_ms": sum(r["plain_ms"] for r in ip),
            "learned_interp_library_ms": sum(r["library_ms"] for r in ip),
            "learned_interp_bound_ms": sum(r["bound_ms"] for r in ip),
            # the same 25 convs, each alone on a warm cache (time_cuda)
            "conv1d_lrelu_repeat_ms": sum(r["repeat_ms"] for r in conv),
            "im2col_ms": sum(r["ms"] for r in cm),
            "im2col_plain_ms": sum(r["plain_ms"] for r in cm),
            "im2col_library_ms": sum(r["library_ms"] for r in cm),
            "conv1d_lrelu_gflop": flops / 1e9,
            "conv1d_lrelu_tflop_per_s": flops / conv_ms / 1e9,
            "audio_s_per_s": B * sep.out_len / sr / (total / 1e3),
        }
        print(f"forward breakdown: {json.dumps(summary)}", flush=True)
        for audio in requests:
            print(f"request breakdown: "
                  f"{json.dumps(request_breakdown(sep, audio, sr, torch))}",
                  flush=True)

        # A small configuration through the kernels on the card and through
        # the plain path on the CPU, with the same weights and audio.
        small = get_config("full_44KHz", num_layers=4, num_initial_filters=8,
                           infer_num_frames=1024, infer_batch=4)
        sp = model.init_waveunet(torch.Generator().manual_seed(SEED), small,
                                 "cpu")
        audio = clip(1.5)
        on_card = Separator(small, sp).separate(audio, sr)
        on_cpu = Separator(small, sp, device="cpu").separate(audio, sr)
        err3 = max(float(np.abs(on_card[k] - on_cpu[k]).max())
                   for k in on_cpu)
        print(f"small config (4 layers, 8 filters), card kernels vs CPU "
              f"plain path: max_abs_err {err3:.3e} (tol {SMALL_ATOL})",
              flush=True)
        if not err3 <= SMALL_ATOL:
            fail("the card disagrees with the CPU path at a small width")

    with phase("presets"):
        preset_rows = serve_presets(get_config, model, Separator,
                                    conv1d_fused, interp, np, torch)

    # The slice's other serving paths, each driven with the launch counts
    # set to 0 just before it and read just after.
    path_launches = {"serve": dict(launches)}

    with phase("sweep"):
        sweep_rows = sweep_check(get_config, model, Separator, conv1d_fused,
                                 interp, kernels, np, torch, dev)
        path_launches["sweep"] = sweep_rows[0]["launches"]

    with phase("graphs"):
        graph_rows = graphs_check(sep, requests, sr, kernels, np, torch)
        path_launches["graphs"] = graph_rows["launches"]

    with phase("spectro"):
        spectro_row = spectro_check(get_config, Separator, kernels, clip, np,
                                    torch)
        path_launches["spectro"] = spectro_row["launches"]

    with phase("stream"):
        stream_row = stream_check(get_config, model, Separator, conv1d_fused,
                                  interp, kernels, rng, np, torch, dev)
        path_launches["stream"] = stream_row["launches"]

    with phase("m6"):
        m6_row = m6_check(get_config, model, Separator, conv1d_fused, interp,
                          np, torch, dev)

    with phase("bench"):
        kernels.reset_launches()
        bench_rec = bench_check()
        path_launches["bench"] = kernels.launch_counts()

    with phase("train"):
        train_row = train_check(get_config, model, conv1d_fused, interp,
                                kernels, np, torch, dev)
        path_launches["train"] = train_row["launches"]

    with phase("eval"):
        eval_row = eval_check(get_config, model, conv1d_fused, interp,
                              kernels, np, torch)
        path_launches["eval"] = eval_row["launches"]

    with phase("cli"):
        cli_row = cli_check(get_config, kernels, eval_row, np, torch)
        path_launches["cli"] = cli_row["launches"]

    def entry(name, rows, source, replaces, n_launch, **extra):
        fwd = [r for r in forward_rows if r["kernel"] == name]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # sums over the main-path shapes of phase 3, listed in "shapes"
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": sum(r["library_ms"] for r in rows),
            **({"bound_fp32_cores_ms": sum(r["bound_fp32_cores_ms"]
                                           for r in rows)}
               if "bound_fp32_cores_ms" in rows[0] else {}),
            "shapes": rows,
            # every launch of one 16-window forward (phase "forward")
            "per_forward": {"launches": len(fwd),
                            "ms": sum(r["ms"] for r in fwd),
                            "bound_ms": sum(r["bound_ms"] for r in fwd),
                            **({"bound_fp32_cores_ms": sum(
                                r["bound_fp32_cores_ms"] for r in fwd)}
                               if fwd and "bound_fp32_cores_ms" in fwd[0]
                               else {}),
                            "plain_ms": sum(r["plain_ms"] for r in fwd),
                            "library_ms": sum(r["library_ms"] for r in fwd)},
            **extra,
        }

    kernels = [
        entry("conv1d_lrelu", conv_rows,
              "waveunet_tpu_torch/ops/kernels/csrc/conv1d_lrelu.cu",
              "waveunet_tpu/ops/pallas/conv1d_fused.py:49",
              launches["conv1d_lrelu"], edge_shapes=edge_rows,
              launches_by_path={p: c["conv1d_lrelu"]
                                for p, c in path_launches.items()}),
        entry("learned_interp", interp_rows,
              "waveunet_tpu_torch/ops/kernels/csrc/learned_interp.cu",
              "waveunet_tpu/ops/pallas/interp.py:41",
              launches["learned_interp"],
              launches_by_path={p: c["learned_interp"]
                                for p, c in path_launches.items()}),
        # its own path is phase "im2col" (the counterpart of
        # tools/pallas_im2col_bench.py); the served requests launch it never
        entry("conv1d_lrelu_im2col", im2col_rows,
              "waveunet_tpu_torch/ops/kernels/csrc/conv1d_lrelu_im2col.cu",
              "waveunet_tpu/ops/pallas/conv1d_im2col.py:44",
              launches_by_phase["im2col"],
              launches_by_phase=dict(launches_by_phase,
                                     serve=launches["conv1d_lrelu_im2col"]),
              launches_by_path={p: c["conv1d_lrelu_im2col"]
                                for p, c in path_launches.items()},
              edge_shapes=im2col_edge_rows, tool_shapes=tool_rows,
              tool_sums=tool_sum),
    ]
    print(f"chip_smoke total: {time.perf_counter() - t_start:.3f} s "
          f"(after interpreter start)", flush=True)
    print(f"served: {json.dumps(served)}", flush=True)
    print(f"presets: {json.dumps(preset_rows)}", flush=True)
    print(f"sweep: {json.dumps(sweep_rows)}", flush=True)
    print(f"graphs: {json.dumps(graph_rows)}", flush=True)
    print(f"spectro: {json.dumps(spectro_row)}", flush=True)
    print(f"stream: {json.dumps(stream_row)}", flush=True)
    print(f"m6: {json.dumps(m6_row)}", flush=True)
    print(f"bench: {json.dumps(bench_rec)}", flush=True)
    print(f"train: {json.dumps(train_row)}", flush=True)
    print(f"eval: {json.dumps(eval_row)}", flush=True)
    print(f"cli: {json.dumps(cli_row)}", flush=True)
    print(f"launches by path: {json.dumps(path_launches)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# Every Wave-U-Net preset of the repo (the spectrogram U-Nets are not
# ported), served shrunk to 4 layers with its own filters and widths.
WAVEUNET_PRESETS = ("baseline", "baseline_diff", "baseline_context",
                    "baseline_stereo", "full", "full_44KHz",
                    "baseline_context_smallfilter_deep",
                    "full_multi_instrument", "baseline_comparison")


def serve_presets(get_config, model, Separator, conv1d_fused, interp, np,
                  torch):
    """Each preset at 4 layers and infer_batch 4 serves a 1.5 s stereo clip
    at its own rate through the kernels on the card and through the plain
    path on the CPU, with the same seeded weights; the two must agree within
    SMALL_ATOL, and the card's run must have launched the conv kernel (and
    the interpolation kernel where the preset learns its upsampling). This
    runs mono input, same padding, even widths, K = 1 merge convs, bilinear
    upsampling, four sources and Cout 34 through the conv kernel."""
    rows = []
    for i, name in enumerate(WAVEUNET_PRESETS):
        cfg = get_config(name, num_layers=4, infer_batch=4)
        params = model.init_waveunet(torch.Generator().manual_seed(SEED + i),
                                     cfg, "cpu")
        sr = cfg.expected_sr
        t = np.arange(int(1.5 * sr)) / sr
        audio = (0.3 * np.sin(2 * np.pi * 220.0 * t)[:, None]
                 + 0.1 * np.random.default_rng(SEED + i).standard_normal(
                     (t.size, 2))).astype(np.float32)
        conv1d_fused.launches = interp.launches = 0
        on_card = Separator(cfg, params).separate(audio, sr)
        n_conv, n_interp = conv1d_fused.launches, interp.launches
        on_cpu = Separator(cfg, params, device="cpu").separate(audio, sr)
        err = max(float(np.abs(on_card[k] - on_cpu[k]).max())
                  for k in on_cpu)
        row = {"preset": name, "filters": cfg.num_initial_filters,
               "filter_size": cfg.filter_size,
               "merge_filter_size": cfg.merge_filter_size,
               "context": cfg.context, "upsampling": cfg.upsampling,
               "channels": cfg.num_channels, "sources": len(on_card),
               "conv_launches": n_conv, "interp_launches": n_interp,
               "max_abs_err": err}
        print(f"preset {json.dumps(row)} (tol {SMALL_ATOL})", flush=True)
        if not err <= SMALL_ATOL:
            fail(f"preset {name}: the card disagrees with the CPU path")
        learned = cfg.upsampling == "learned"
        if n_conv == 0 or (n_interp > 0) != learned:
            fail(f"preset {name}: the card run did not go through the "
                 f"kernels ({n_conv} conv, {n_interp} interp launches)")
        rows.append(row)
    return rows


def forward_breakdown(model, conv1d_fused, interp, conv1d_im2col, sep, wins,
                      torch):
    """Device time of each kernel launch in one forward of ``wins``, by CUDA
    events recorded around each call (no synchronise inside the forward),
    with each launch's FLOPs and bound, and the plain version and the
    library call timed afterwards on the same inputs; every row also carries
    the whole forward's time. Each conv launch is followed by a row of the
    channel-major im2col kernel on a copy of the same input (made outside
    the timing), held against the conv's output and timed with its plain
    version and the NCL library call; the conv row also carries the conv
    kernel timed the same way alone (``repeat_ms``)."""
    calls = []

    def timed(fn, kernel):
        def call(x, w, *rest):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = fn(x, w, *rest)
            end.record()
            calls.append((kernel, x, w, rest, y, start, end))
            return y
        return call

    saved = (model.conv1d_lrelu, model.learned_interp)
    model.conv1d_lrelu = timed(conv1d_fused.conv1d_lrelu, "conv1d_lrelu")
    model.learned_interp = timed(interp.learned_interp, "learned_interp")
    try:
        model.apply_waveunet(sep.params, sep.cfg, wins)  # warm
        torch.cuda.synchronize()
        calls.clear()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        model.apply_waveunet(sep.params, sep.cfg, wins)
        t1.record()
        torch.cuda.synchronize()
    finally:
        model.conv1d_lrelu, model.learned_interp = saved

    L = sep.cfg.num_layers
    names = ([f"down_{i}" for i in range(L)] + ["bottleneck"]
             + [n for i in range(L) for n in (f"interp_{i}", f"up_{i}")])
    forward_ms = t0.elapsed_time(t1)
    rows = []
    for name, (kernel, x, w, rest, y, start, end) in zip(names, calls):
        if kernel == "conv1d_lrelu":
            K, cin, cout = w.shape
            flops = 2.0 * y.numel() * K * cin
            b_ms, b_by, cores_ms = conv_bound(x.shape[0] * x.shape[1] * cin,
                                              K, cin, cout, y.numel())
            b = rest[0]
            w_lib = w.permute(2, 1, 0).contiguous()
            plain_ms = time_cuda(
                lambda: conv1d_fused.conv1d_lrelu_plain(x, w, b), torch, 0.1)
            library_ms = time_cuda(lambda: conv_library(x, w_lib, b), torch,
                                   0.1)
        else:
            flops = 3.0 * x.shape[0] * (x.shape[1] - 1) * x.shape[2]
            b_ms, b_by = bound_ms(flops, 4.0 * (x.numel() + w.numel()
                                                + y.numel()))
            context = rest[0]
            wt = interp_library_weights(w)
            plain_ms = time_cuda(
                lambda: interp.learned_interp_plain(x, w, context), torch, 0.1)
            library_ms = time_cuda(lambda: interp_library(x, wt, context),
                                   torch, 0.1)
        row = {"layer": name, "kernel": kernel, "x": list(x.shape),
               "ms": start.elapsed_time(end), "flops": flops,
               "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms,
               "library_ms": library_ms, "forward_ms": forward_ms}
        rows.append(row)
        if kernel == "conv1d_lrelu":
            row["bound_fp32_cores_ms"] = cores_ms
            plan = conv1d_fused.plan_launch(x.shape[0], y.shape[1], cin, cout,
                                            K, x.stride(1))
            row["plan"] = {"tile_n": plan.tile_n, "splits": plan.splits,
                           "grid": plan.grid, "smem_bytes": plan.smem_bytes}
            rows.append(im2col_row(conv1d_im2col, row, x, w, b, w_lib, y,
                                   torch))
            row["repeat_ms"] = time_cuda(
                lambda: conv1d_fused.conv1d_lrelu_cuda(x, w, b), torch, 0.1)
    return rows


def im2col_row(conv1d_im2col, conv_row, x, w, b, w_lib, y, torch):
    """The channel-major im2col kernel on a channel-major copy of one conv
    launch's input x [B, L, Cin]: held against that launch's output y and
    timed with its plain version and the NCL library call."""
    x_cm = channel_major(x)
    got = conv1d_im2col.conv1d_lrelu_im2col_cuda(x_cm, w, b)
    torch.cuda.synchronize()
    err = (got - y.transpose(1, 2)).abs().max().item()
    del got
    if not err <= CONV_ATOL:
        fail(f"conv1d_lrelu_im2col at {conv_row['layer']} of the forward "
             f"disagrees with conv1d_lrelu: {err:.3e} (tol {CONV_ATOL})")
    B, cin, L = x_cm.shape
    K, _, cout = w.shape
    row = dict(conv_row, kernel="conv1d_lrelu_im2col", x=list(x_cm.shape),
               max_abs_err=err, plan=im2col_plan(conv1d_im2col.plan_launch(
                   B, L - K + 1, cin, cout, K)))
    row["ms"] = time_cuda(
        lambda: conv1d_im2col.conv1d_lrelu_im2col_cuda(x_cm, w, b), torch,
        0.1)
    row["plain_ms"] = time_cuda(
        lambda: conv1d_im2col.conv1d_lrelu_im2col_plain(x_cm, w, b), torch,
        0.1)
    row["library_ms"] = time_cuda(lambda: conv_library_ncl(x_cm, w_lib, b),
                                  torch, 0.1)
    return row


def request_breakdown(sep, audio, sr, torch):
    """One separate() request: its wall time beside the device time of each
    chunk (CUDA events around each chunk's framing and forward, or its
    graph's replay with the copies into the graph's static buffers). The
    rest of the wall time is host work, copies and launch gaps."""
    chunks = []
    run_chunk = sep._run_chunk

    def timed(mode, inp, pos):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(mode, inp, pos)
        end.record()
        chunks.append((int(pos.shape[0]), start, end))
        return out

    sep._run_chunk = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sep.separate(audio, sr)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
    finally:
        del sep._run_chunk  # back to the class's method
    chunk_ms = [s.elapsed_time(e) for _, s, e in chunks]
    return {"seconds": audio.shape[0] / sr,
            "chunks": [k for k, _, _ in chunks], "chunk_ms": chunk_ms,
            "device_ms": sum(chunk_ms), "wall_ms": wall_ms,
            "device_idle_share": 1.0 - sum(chunk_ms) / wall_ms}


def sweep_check(get_config, model, Separator, conv1d_fused, interp, kernels,
                np, torch, dev):
    """The bench's resident sweep (full_44KHz, 65,536-frame window, batch
    16, the 60 s bench song) on both wires: eager and as one CUDA graph,
    which must agree bit for bit; against separate() on the card
    (SWEEP_ATOL, SWEEP_DIFF_ATOL for the int16 difference source) and
    against separate() through the plain path (plain_tols), which holds the
    kernels at every chunk size of the schedule (16, 8 and 1 windows); timed
    eager and graphed; the graph's replays counted into the launches."""
    from waveunet_tpu_torch.bench import make_bench_song

    rows = []
    for wire in ("int16", "float32"):
        cfg = get_config("full_44KHz", infer_num_frames=65536,
                         infer_batch=16, infer_wire_dtype=wire)
        sep = Separator(cfg, model.init_waveunet(
            torch.Generator().manual_seed(SEED), cfg, dev))
        sr = cfg.expected_sr
        song = make_bench_song(sr, 60.0)
        n = len(song)
        song_dev = sep.stage_resident(song)
        eager_fn, positions = sep.resident_sweep(n, graphed=False)
        graph_fn, _ = sep.resident_sweep(n)
        eager, eager_cs = eager_fn(sep.params, song_dev)
        graphed, graph_cs = graph_fn(sep.params, song_dev)
        torch.cuda.synchronize()
        names = list(cfg.source_names)
        same = all(torch.equal(eager[k], graphed[k]) for k in names)
        same = same and torch.equal(eager_cs, graph_cs)
        host = sep.separate(song, sr)
        with plain_path(model, conv1d_fused, interp):
            plain = sep.separate(song, sr)
        swept = {k: graphed[k].cpu().numpy() for k in names}
        wire_row = (wire_check(sep, song, np, torch) if wire == "int16"
                    else None)
        errs = {k: float(np.abs(swept[k] - host[k]).max()) for k in names}
        tols = {k: (SWEEP_DIFF_ATOL if wire == "int16" and k == names[-1]
                    else SWEEP_ATOL) for k in names}
        # separate() rebuilds the difference source from the unquantised mix
        plain_tol = plain_tols(cfg, mix_rounding=(
            SWEEP_DIFF_ATOL if wire == "int16" else 0.0))
        plain_errs = {k: float(np.abs(swept[k] - plain[k]).max())
                      for k in names}
        sizes = sep.resident_chunk_sizes(len(positions))
        graph = graph_fn.held["graph"]
        kernels.reset_launches()
        graph.replays = 0
        for _ in range(3):
            graph_fn(sep.params, song_dev)
        torch.cuda.synchronize()
        counted = kernels.launch_counts()
        want = {k: 3 * v for k, v in graph.launches.items()}
        per_chunk = {"conv1d_lrelu": 2 * cfg.num_layers + 1,
                     "learned_interp": cfg.num_layers,
                     "conv1d_lrelu_im2col": 0}
        per_graph = {k: v * len(sizes) for k, v in per_chunk.items()}
        eager_ms = time_cuda(lambda: eager_fn(sep.params, song_dev), torch)
        graph_ms = time_cuda(lambda: graph_fn(sep.params, song_dev), torch)
        row = {"wire": wire, "windows": len(positions), "chunks": sizes,
               "graph_identical_to_eager": same, "max_abs_err_vs_separate":
               errs, "tol": tols, "max_abs_err_vs_plain_separate":
               plain_errs, "plain_tol": plain_tol,
               "eager_ms": eager_ms, "graph_ms": graph_ms,
               "eager_audio_s_per_s": 60.0 / (eager_ms / 1e3),
               "graph_audio_s_per_s": 60.0 / (graph_ms / 1e3),
               "replays": graph.replays, "launches_per_replay":
               graph.launches, "launches": counted}
        if wire_row is not None:
            row["wire_dequantiser"] = wire_row
        print(f"sweep {json.dumps(row)}", flush=True)
        if not same:
            fail(f"the graphed sweep ({wire}) differs from the eager sweep")
        if not all(np.isfinite(host[k]).all() for k in names):
            fail("the sweep's song separated to non-finite audio")
        if any(not errs[k] <= tols[k] for k in names):
            fail(f"the sweep ({wire}) disagrees with separate()")
        if any(not plain_errs[k] <= plain_tol[k] for k in names):
            fail(f"the sweep ({wire}) disagrees with separate() through "
                 f"the plain path")
        if graph.launches != per_graph or counted != want:
            fail(f"the sweep's launches {counted} are not 3 replays of "
                 f"{per_graph}")
        rows.append(row)
    return rows


def wire_check(sep, song, np, torch):
    """The int16 wire's dequantisers on the card against the CPU, bit for
    bit: ``wire.from_wire`` and ``wire.dequantize`` (the engine's) over all
    65,536 int16 values, both also against numpy's float32 division (the
    JAX package's x / 32767.0), and the network input ``Separator._frame``
    builds from one staged song (``_chunk_fwd``'s float windows) on the
    card against the same on the CPU. Also counts how many int16 values the
    old expression, a division by the host scalar 32767.0, got wrong on the
    card (it multiplies by the reciprocal)."""
    from waveunet_tpu_torch.infer import wire
    from waveunet_tpu_torch.infer.engine import Separator, window_positions

    def differ(x, y):
        """Positions where x and y are not the same float32, bit for bit
        (NaN against NaN counts as the same)."""
        x, y = x.detach().cpu(), y.detach().cpu()
        same = (x.view(torch.int32) == y.view(torch.int32)) | (
            x.isnan() & y.isnan())
        return int((~same).sum())

    w = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    wd = w.to(sep.device)
    div = torch.from_numpy(w.numpy().astype(np.float32) / np.float32(32767.0))
    sentinel = torch.where(w == wire.INT16_NONFINITE,
                           torch.full_like(div, float("nan")), div)
    row = {}
    for name, fn, ref in (("from_wire", wire.from_wire, sentinel),
                          ("dequantize", wire.dequantize, div)):
        card, cpu = fn(wd), fn(w)
        row[name] = {"card_vs_cpu_differ": differ(card, cpu),
                     "cpu_vs_numpy_differ": differ(cpu, ref)}
    row["old_host_scalar_division_differ_on_card"] = differ(
        wd.to(torch.float32) / 32767.0, div)
    # the network input of one staged song, card against CPU
    cpu_sep = Separator(sep.cfg, {k: {n: t.cpu() for n, t in v.items()}
                                  for k, v in sep.params.items()},
                        device="cpu")
    staged = sep.stage_resident(song)
    pos = window_positions(len(song), sep.out_len)[:sep.batch]
    pos_t = torch.from_numpy(pos)
    card_in = sep._frame(staged, pos_t.to(sep.device))
    cpu_in = cpu_sep._frame(staged.cpu(), pos_t)
    row["chunk_input_windows"] = int(len(pos))
    row["chunk_input_differ"] = differ(card_in, cpu_in)
    print(f"wire dequantiser: {json.dumps(row)}", flush=True)
    if any(v["card_vs_cpu_differ"] or v["cpu_vs_numpy_differ"]
           for v in (row["from_wire"], row["dequantize"])) \
            or row["chunk_input_differ"]:
        fail("the int16 wire's dequantiser on the card differs from the CPU")
    return row


def graphs_check(sep, requests, sr, kernels, np, torch):
    """precompile() on the served full_44KHz engine, then the three
    requests again through its CUDA graphs and pinned copies: identical bit
    for bit to the eager run, each chunk a replay, the kernels' launches
    counted from the replays; walls, device time and idle share beside the
    eager requests'."""
    eager = [sep.separate(a, sr) for a in requests]
    eager_bd = [request_breakdown(sep, a, sr, torch) for a in requests]
    t0 = time.perf_counter()
    n_graphs = sep.precompile(max_song_s=60.0,
                              progress=lambda m: print(m, flush=True))
    capture_s = time.perf_counter() - t0
    graphs = sep._graphs
    for g in graphs.values():
        g.replays = 0
    kernels.reset_launches()
    graphed = [sep.separate(a, sr) for a in requests]
    torch.cuda.synchronize()
    counted = kernels.launch_counts()
    replays = {f"{m}/{k}": g.replays for (m, k), g in graphs.items()
               if g.replays}
    want = {name: sum(g.replays * g.launches[name] for g in graphs.values())
            for name in counted}
    n_chunks = sum(len(r["chunks"]) for r in eager_bd)
    same = all(np.array_equal(e[k], g[k]) for e, g in zip(eager, graphed)
               for k in e)
    walls = []
    for a in requests:
        w = []
        for _ in range(REPEATS):
            t1 = time.perf_counter()
            sep.separate(a, sr)
            w.append(time.perf_counter() - t1)
        walls.append(float(np.median(w)))
    graph_bd = [request_breakdown(sep, a, sr, torch) for a in requests]
    audio_s = sum(a.shape[0] / sr for a in requests)
    # The engine's host pipeline alone: the same requests with a forward
    # that returns zeros (no model), every source copied back.
    cfg = sep.cfg

    def zeros(p, x):
        z = torch.zeros((x.shape[0], sep.out_len, cfg.num_channels),
                        device=x.device)
        return {s: z for s in cfg.source_names}

    bare = type(sep)(cfg, sep.params, forward_fn=zeros)
    bare.separate(requests[0], sr)
    pipeline_ms = []
    for a in requests:
        w = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            bare.separate(a, sr)
            w.append(1e3 * (time.perf_counter() - t1))
        pipeline_ms.append(float(np.median(w)))
    print(f"engine without a model (zero forward), median walls: "
          f"{pipeline_ms} ms for {[a.shape[0] / sr for a in requests]} s",
          flush=True)
    row = {"graphs": n_graphs, "capture_s": capture_s,
           "zero_forward_walls_ms": pipeline_ms,
           "identical_to_eager": same, "replays": replays,
           "chunks": n_chunks, "launches": counted,
           "graphed_walls_s": walls,
           "graphed_audio_s_per_s": audio_s / sum(walls),
           "eager": eager_bd, "graphed": graph_bd}
    for e, g in zip(eager_bd, graph_bd):
        print(f"request {e['seconds']:.1f} s: eager wall {e['wall_ms']:.2f} "
              f"ms, device {e['device_ms']:.2f} ms, idle "
              f"{e['device_idle_share']:.3f}; graphed wall "
              f"{g['wall_ms']:.2f} ms, device {g['device_ms']:.2f} ms, idle "
              f"{g['device_idle_share']:.3f}", flush=True)
    print(f"graphed: {n_graphs} graphs captured in {capture_s:.3f} s; "
          f"{audio_s:.1f} audio-s in {sum(walls):.4f} s (median walls): "
          f"{audio_s / sum(walls):.1f} audio-s/s; replays {replays}; "
          f"launches {counted}", flush=True)
    if not same:
        fail("the graphed requests differ from the eager requests")
    if sum(replays.values()) != n_chunks or counted != want:
        fail(f"the graphed requests replayed {replays} for {n_chunks} "
             f"chunks and launched {counted}, not {want}")
    if counted["conv1d_lrelu"] == 0 or counted["learned_interp"] == 0:
        fail("the graphed requests launched no conv or interp kernel")
    return row


def spectro_check(get_config, Separator, kernels, clip, np, torch):
    """U7 at full width (6 layers, 16 to 512 channels, 8,192 Hz,
    infer_batch 8) separating a 30 s clip on the card and on the CPU
    (SPECTRO_ATOL), then through its CUDA graphs (bit for bit)."""
    from waveunet_tpu_torch.models.spectrogram_unet import (
        init_spectrogram_unet)

    cfg = get_config("unet_spectrogram", infer_batch=8)
    params, state = init_spectrogram_unet(
        torch.Generator().manual_seed(SEED), cfg, "cpu")
    sr = cfg.expected_sr
    rng = np.random.default_rng(SEED)
    t = np.arange(30 * sr) / sr
    audio = (0.3 * np.sin(2 * np.pi * 220.0 * t)[:, None]
             + 0.1 * rng.standard_normal((t.size, 2))).astype(np.float32)
    sep = Separator(cfg, params, model_state=state)
    first = sep.separate(audio, sr)  # also the warm-up: cuDNN, cuFFT plans
    kernels.reset_launches()
    t0 = time.perf_counter()
    on_card = sep.separate(audio, sr)
    wall = time.perf_counter() - t0
    counted = kernels.launch_counts()
    on_cpu = Separator(cfg, params, model_state=state,
                       device="cpu").separate(audio, sr)
    err = max(float(np.abs(on_card[k] - on_cpu[k]).max()) for k in on_cpu)
    n_graphs = sep.precompile(max_song_s=30.0)
    t0 = time.perf_counter()
    graphed = sep.separate(audio, sr)
    graph_wall = time.perf_counter() - t0
    same = all(np.array_equal(graphed[k], on_card[k]) for k in on_card)
    repeatable = all(np.array_equal(first[k], on_card[k]) for k in on_card)
    graph_err = max(float(np.abs(graphed[k] - on_card[k]).max())
                    for k in on_card)
    row = {"config": "unet_spectrogram", "layers": cfg.num_layers,
           "filters": cfg.num_initial_filters, "sr": sr,
           "window": [sep.in_len, sep.out_len], "seconds": 30.0,
           "max_abs_err_vs_cpu": err, "tol": SPECTRO_ATOL,
           "eager_wall_s": wall, "graphs": n_graphs,
           "graphed_wall_s": graph_wall, "graph_identical_to_eager": same,
           "graph_max_abs_err": graph_err,
           "eager_identical_run_to_run": repeatable, "launches": counted}
    print(f"spectro {json.dumps(row)}", flush=True)
    if not all(np.isfinite(on_card[k]).all()
               and on_card[k].shape == (audio.shape[0], 1) for k in on_card):
        fail("U7 on the card gave non-finite or misshapen audio")
    if not err <= SPECTRO_ATOL:
        fail("U7 on the card disagrees with the CPU path")
    if not repeatable:
        fail("two eager U7 separations of one clip differ")
    if not same:
        fail("U7 through its CUDA graphs differs from the eager run")
    return row


def conv_splits(model, conv1d_fused, params, cfg, wins):
    """The split-K count of each conv launch of one forward of ``wins``."""
    splits = []
    plan = conv1d_fused.plan_launch

    def recorded(*a, **k):
        p = plan(*a, **k)
        splits.append(p.splits)
        return p

    conv1d_fused.plan_launch = recorded
    try:
        model.apply_waveunet(params, cfg, wins)
    finally:
        conv1d_fused.plan_launch = plan
    return splits


def stream_check(get_config, model, Separator, conv1d_fused, interp,
                 kernels, rng, np, torch, dev):
    """full_44KHz streamed in uneven pushes on the card (training window,
    batch_windows 4): every fully-contexted sample within STREAM_ATOL of the
    card's offline output at the same window, and both streams (drains of
    1 to 4 windows, and of 1) within plain_tols of the offline output
    through the plain path; batched drains against serial (batch 1)
    drains, bit for bit where the conv's launch plans of the batch sizes
    agree, else within STREAM_BATCH_ATOL."""
    from waveunet_tpu_torch.infer.streaming import StreamingSeparator

    cfg = get_config("full_44KHz", infer_num_frames=None)
    params = model.init_waveunet(torch.Generator().manual_seed(SEED), cfg,
                                 dev)
    sr = cfg.expected_sr
    n = 10 * sr
    t = np.arange(n) / sr
    audio = (0.3 * np.sin(2 * np.pi * 330.0 * t)[:, None]
             + 0.1 * rng.standard_normal((n, 2))).astype(np.float32)
    pushes = []
    while sum(pushes) < n:
        pushes.append(int(rng.integers(1, 60000)))

    def stream(batch_windows):
        st = StreamingSeparator(cfg, params, batch_windows=batch_windows)
        got = {s: [] for s in cfg.source_names}
        off = 0
        for p in pushes:
            for s, v in st.push(audio[off:off + p]).items():
                got[s].append(v)
            off += p
        for s, v in st.flush().items():
            got[s].append(v)
        return st, {s: np.concatenate(v) for s, v in got.items()}

    kernels.reset_launches()
    t0 = time.perf_counter()
    st, batched = stream(4)
    wall = time.perf_counter() - t0
    counted = kernels.launch_counts()
    _, serial = stream(1)
    offline = Separator(cfg, params).separate(audio, sr)
    with plain_path(model, conv1d_fused, interp):
        plain = Separator(cfg, params).separate(audio, sr)
    n_cmp = n - st.out_len
    err = max(float(np.abs(batched[k][:n_cmp] - offline[k][:n_cmp]).max())
              for k in offline)
    tols = plain_tols(cfg)
    plain_errs = {f"{which}/{k}": float(np.abs(
        got[k][:n_cmp] - plain[k][:n_cmp]).max())
        for which, got in (("batched", batched), ("serial", serial))
        for k in plain}
    batch_err = max(float(np.abs(batched[k] - serial[k]).max())
                    for k in serial)
    bitwise = all(np.array_equal(batched[k], serial[k]) for k in serial)
    wins = torch.zeros((4, st.in_len, cfg.num_channels), device=dev)
    plans = {b: conv_splits(model, conv1d_fused, params, cfg, wins[:b])
             for b in (1, 2, 4)}
    plans_agree = plans[1] == plans[2] == plans[4]
    row = {"seconds": n / sr, "pushes": len(pushes),
           "window": [st.in_len, st.out_len], "batch_windows": 4,
           "wall_s": wall, "max_abs_err_vs_offline": err,
           "tol": STREAM_ATOL, "compared_samples": n_cmp,
           "max_abs_err_vs_plain_offline": plain_errs, "plain_tol": tols,
           "batched_vs_serial_bitwise": bitwise,
           "batched_vs_serial_max_abs_err": batch_err,
           "conv_splits_by_batch": plans, "conv_plans_agree": plans_agree,
           "launches": counted}
    print(f"stream {json.dumps(row)}", flush=True)
    if not all(batched[k].shape == (n, cfg.num_channels)
               and np.isfinite(batched[k]).all() for k in batched):
        fail("the stream gave non-finite or misshapen audio")
    if not err <= STREAM_ATOL:
        fail("the stream disagrees with the offline separation")
    if any(not e <= tols[k.split("/")[1]] for k, e in plain_errs.items()):
        fail("the stream disagrees with the offline separation through the "
             "plain path")
    if plans_agree and not bitwise:
        fail("batched drains differ from serial drains under equal plans")
    if not batch_err <= STREAM_BATCH_ATOL:
        fail("batched drains disagree with serial drains")
    if counted["conv1d_lrelu"] == 0 or counted["learned_interp"] == 0:
        fail("the stream launched no conv or interp kernel")
    return row


def m6_check(get_config, model, Separator, conv1d_fused, interp, np, torch,
             dev):
    """M6 (full_multi_instrument) at the bench's full width and schedule
    (65,536-frame window, batch 16, int16 wire, the 60 s bench song): the
    eager resident sweep through the kernels against the same sweep through
    the plain path (plain_tols), at every chunk size it launches."""
    from waveunet_tpu_torch.bench import make_bench_song

    cfg = get_config("full_multi_instrument", infer_num_frames=65536,
                     infer_batch=16, infer_wire_dtype="int16")
    sep = Separator(cfg, model.init_waveunet(
        torch.Generator().manual_seed(SEED), cfg, dev))
    song = make_bench_song(cfg.expected_sr, 60.0)
    song_dev = sep.stage_resident(song)
    fn, positions = sep.resident_sweep(len(song), graphed=False)
    got, _ = fn(sep.params, song_dev)
    with plain_path(model, conv1d_fused, interp):
        want, _ = fn(sep.params, song_dev)
    tols = plain_tols(cfg)
    errs = {k: (got[k] - want[k]).abs().max().item() for k in got}
    row = {"config": "full_multi_instrument", "layers": cfg.num_layers,
           "filters": cfg.num_initial_filters,
           "sources": list(cfg.source_names), "windows": len(positions),
           "chunks": sep.resident_chunk_sizes(len(positions)),
           "max_abs_err_vs_plain": errs, "tol": tols}
    print(f"m6 {json.dumps(row)}", flush=True)
    if not all(torch.isfinite(v).all().item() for v in got.values()):
        fail("M6's sweep gave non-finite audio")
    if any(not errs[k] <= tols[k] for k in errs):
        fail("M6's sweep through the kernels disagrees with the plain path")
    return row


def plain_tols(cfg, mix_rounding: float = 0.0):
    """Per source, how far a separation through the kernels may lie from
    one through the plain path: FORWARD_ATOL for a network output, one
    WIRE_STEP more on the int16 wire; the difference source, clip(mix -
    the others), carries the others' errors summed, and ``mix_rounding``
    where the two sides rebuild it from differently quantised mixes."""
    names = list(cfg.source_names)
    tol = FORWARD_ATOL + (WIRE_STEP if cfg.infer_wire_dtype == "int16"
                          else 0.0)
    tols = {k: tol for k in names}
    if cfg.output_type == "difference":
        tols[names[-1]] = (len(names) - 1) * tol + mix_rounding
    return tols


def bench_check():
    """The port's bench (waveunet_tpu_torch/bench.py) at its REPS_MIN
    interleaved e2e pairs: every key of its JSON line, with positive
    numbers."""
    from waveunet_tpu_torch import bench

    rec = bench.run(reps=(BENCH_REPS_MIN, BENCH_REPS_MIN))
    print(f"bench line: {json.dumps(rec)}", flush=True)
    missing = [k for k in bench.REQUIRED_KEYS if k not in rec]
    if missing:
        fail(f"the bench's JSON line lacks {missing}")
    for k in ("value", "vs_baseline", "compute_roof_audio_s_per_s",
              "m6_resident_audio_s_per_s", "u7_resident_audio_s_per_s",
              "e2e_rtf"):
        if not (isinstance(rec[k], (int, float)) and rec[k] > 0):
            fail(f"the bench's {k} is {rec[k]!r}")
    if rec.get("smoke"):
        fail("the bench ran in smoke mode on the card")
    return rec


# -- phase train -------------------------------------------------------------

TRAIN_SONGS = {"train": 4, "valid": 2, "test": 1}
TRAIN_SONG_S = 8.0
TRAIN_EPOCH_IT = 6      # epoch_it (2000 published) cut to fit the phase
TRAIN_TIMED_STEPS = 5   # eager steps timed per batch size, after a warm-up
TRAIN_FUSED_STEPS = 4   # steps of the fused-against-eager check
TRAIN_CHUNK = 8         # fused replays timed as one chunk
LOSS_RTOL = 1e-5        # one step's loss, card against the CPU
# Each parameter's gradient, scored as max|g - g_fp64| / max|g_fp64|: the
# card's distance from the CPU's fp64 gradient may be at most GRAD_FACTOR
# times the CPU fp32 one's, or GRAD_FLOOR where that is larger. A weight's
# gradient sums up to 3e5 products, and where they cancel 30- to 60-fold
# fp32 rounding reaches about 1e-3 of its largest value on either device
# (the CPU reached 7e-4 on random batches, the card 1e-3 on sine batches).
# The relative L2 distance of the whole gradient vector must stay within
# GRAD_L2_FACTOR times the CPU's or GRAD_L2_FLOOR (the card reached 6.1e-6,
# the CPU 7.7e-6). The same step with TF32 convs, run as a control, must
# fail each check: on the card it read 3.5e-5 on the loss, 0.10 on its
# worst tensor and 6.7e-4 relative L2.
GRAD_FACTOR = 4.0
GRAD_FLOOR = 2e-3
GRAD_L2_FACTOR = 4.0
GRAD_L2_FLOOR = 1e-4
ADAM_ATOL = 1e-7        # Adam on the card against Adam on the CPU, the same
                        # gradients: a few fp32 steps of values below 0.5
VALID_RTOL = 1e-4       # validation loss through the kernels vs plain path
BATCH_LOSS_RTOL = 1e-5  # one eval batch's loss, kernels vs plain path (the
                        # mean's gap was 2.8e-7 on the card)


def make_train_songs(cache, write_wav, cfg, root, np):
    """Sine-and-noise stems, stereo 44.1 kHz, TRAIN_SONG_S seconds each,
    written as float WAVs and cached with the port's own preprocess."""
    from waveunet_tpu_torch.ops import shapes

    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    rng = np.random.default_rng(SEED)
    n = int(TRAIN_SONG_S * cfg.expected_sr)
    t = np.arange(n) / cfg.expected_sr
    for part, n_songs in TRAIN_SONGS.items():
        samples = []
        for i in range(n_songs):
            tracks = {}
            for name in cfg.source_names:
                f = rng.uniform(80.0, 1200.0, 2)
                sig = (0.3 * np.sin(2 * np.pi * f[None, :] * t[:, None])
                       + 0.05 * rng.standard_normal((n, 2)))
                tracks[name] = sig.astype(np.float32)
            tracks["mix"] = sum(tracks.values())
            paths = {}
            for k, v in tracks.items():
                paths[k] = os.path.join(root, f"{part}_{i}_{k}.wav")
                write_wav(paths[k], v, cfg.expected_sr, subtype="FLOAT")
            samples.append(paths)
        cache.preprocess_partition(cfg, part, samples,
                                   pad_frames=(in_len - out_len) // 2)


def tree_err(got, want, ref, torch):
    """{layer/name: max|got - ref| / max|ref|}, and the same for want."""
    out = {}
    for layer in ref:
        for n, r in ref[layer].items():
            s = r.abs().max().item()
            out[f"{layer}/{n}"] = (
                (got[layer][n].double().cpu() - r).abs().max().item() / s,
                (want[layer][n].double().cpu() - r).abs().max().item() / s,
                s)
    return out


def step_parity(cfg, model, bank_cpu, step_mod, torch, dev):
    """One full-width training step (batch 2) on the card and on the CPU
    from the same params and batch: the loss, every gradient against fp64
    on the CPU beside the CPU fp32 distance, and the Adam update. The same
    step on the card with TF32 in cuDNN's convs is the control: each of the
    three checks (loss, per tensor, relative L2) must reject it."""
    gen = torch.Generator().manual_seed(SEED)
    p_cpu = model.init_waveunet(gen, cfg, "cpu")
    p_dev = {k: {n: t.to(dev) for n, t in v.items()} for k, v in p_cpu.items()}
    p_64 = {k: {n: t.double() for n, t in v.items()} for k, v in p_cpu.items()}
    bank_cpu.set_batch(2)
    batch = bank_cpu.sample(SEED, 0)
    batch_dev = {k: v.to(dev) for k, v in batch.items()}

    def grads(c, params, b):
        with step_mod._step_scope(c):
            return step_mod.value_and_grad(step_mod.make_loss_fn(c, True),
                                           params, {}, b)

    t0 = time.perf_counter()
    l_dev, _, g_dev = grads(cfg, p_dev, batch_dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    l_cpu, _, g_cpu = grads(cfg, p_cpu, batch)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    l_64, _, g_64 = grads(cfg, p_64, {k: v.double() for k, v in batch.items()})
    t_64 = time.perf_counter() - t0

    def rel_l2(g):
        num = sum(((g[k][n].double().cpu() - r) ** 2).sum().item()
                  for k, v in g_64.items() for n, r in v.items())
        den = sum((r ** 2).sum().item() for v in g_64.values()
                  for r in v.values())
        return (num / den) ** 0.5

    l2_cpu = rel_l2(g_cpu)

    def verdict(loss, g):
        """The checks' numbers for a card step, and why each check that
        rejects it does so."""
        errs = tree_err(g, g_cpu, g_64, torch)
        bad = [k for k, (e_dev, e_cpu, s) in errs.items()
               if not e_dev <= max(GRAD_FACTOR * e_cpu, GRAD_FLOOR)]
        l2 = rel_l2(g)
        loss_rel = abs(loss.item() - l_cpu.item()) / abs(l_cpu.item())
        why = {}
        if not loss_rel <= LOSS_RTOL:
            why["loss"] = (f"the loss is {loss_rel:.3e} from the CPU's (tol "
                           f"{LOSS_RTOL})")
        if bad:
            why["per_tensor"] = f"gradients off: { {k: errs[k] for k in bad} }"
        if not l2 <= max(GRAD_L2_FACTOR * l2_cpu, GRAD_L2_FLOOR):
            why["rel_l2"] = (f"the gradient is {l2:.3e} from fp64 (relative "
                             f"L2), the CPU's {l2_cpu:.3e}")
        nums = {"loss": loss.item(), "loss_rel_err": loss_rel,
                "grad_err_max": max(e[0] for e in errs.values()),
                "grad_rel_l2": l2, "grads_off": len(bad)}
        return nums, why, errs

    nums, why, errs = verdict(l_dev, g_dev)
    zero = [f"{k}/{n}" for k, v in g_dev.items() for n, g in v.items()
            if g is None or not torch.any(g != 0).item()]
    # the control: TF32 in every conv of the forward and the backward
    tf32 = cfg.replace(conv_precision="default")
    l_tf, _, g_tf = grads(tf32, p_dev, batch_dev)
    control, control_why, _ = verdict(l_tf, g_tf)
    del g_tf
    # Adam on the card, and Adam on the CPU on the card's gradients
    tx = step_mod.make_optimizer(cfg.init_sup_sep_lr)
    s_dev, s_cpu = tx.init(p_dev), tx.init(p_cpu)
    g_dev_cpu = {k: {n: g.cpu() for n, g in v.items()}
                 for k, v in g_dev.items()}
    tx.update_(p_dev, g_dev, s_dev)
    tx.update_(p_cpu, g_dev_cpu, s_cpu)
    adam_err = max(max((p_dev[k][n].cpu() - p_cpu[k][n]).abs().max().item(),
                       (s_dev["nu"][k][n].cpu() - s_cpu["nu"][k][n]).abs()
                       .max().item(),
                       (s_dev["mu"][k][n].cpu() - s_cpu["mu"][k][n]).abs()
                       .max().item())
                   for k in p_cpu for n in p_cpu[k])
    worst = max(errs.items(), key=lambda kv: kv[1][0] / max(kv[1][1], 1e-30))
    row = {"batch": 2, "loss_card": l_dev.item(), "loss_cpu": l_cpu.item(),
           "loss_fp64": l_64.item(), "loss_rel_err": nums["loss_rel_err"],
           "params": len(errs),
           "grad_err_card_max": nums["grad_err_max"],
           "grad_err_cpu_max": max(e[1] for e in errs.values()),
           "grad_worst_ratio": {worst[0]: worst[1]},
           "grad_rel_l2": {"card": nums["grad_rel_l2"], "cpu": l2_cpu},
           "grad_errs": {k: e[:2] for k, e in errs.items()},
           "adam_max_abs_err": adam_err,
           "tf32_control": dict(control, rejected_by=sorted(control_why)),
           "seconds": {"card": t_dev, "cpu_fp32": t_cpu, "cpu_fp64": t_64}}
    print(f"train step parity (full width, batch 2): {json.dumps(row)}",
          flush=True)
    if why:
        fail(f"the training step on the card: {'; '.join(why.values())}")
    if zero:
        fail(f"parameters without a gradient on the card: {zero}")
    # each check on its own must tell TF32 from fp32
    passed = {"loss", "per_tensor", "rel_l2"} - set(control_why)
    if passed:
        fail(f"the step-parity checks {sorted(passed)} pass TF32 convs too: "
             f"{control}")
    if not adam_err <= ADAM_ATOL:
        fail(f"Adam on the card is {adam_err:.3e} from Adam on the CPU")
    return row


def step_breakdown(cfg, bank, state, step_mod, torch, deterministic=True):
    """Eager steps at the bank's batch size, each split by CUDA events into
    sampling, forward (and loss), backward and Adam; medians over
    TRAIN_TIMED_STEPS steps after a warm-up, and the host wall per step.
    ``deterministic=False`` times the same step with cuDNN free to pick
    non-deterministic algorithms: the cost of the training step's
    deterministic setting, measured only."""
    import numpy as np

    scope = step_mod._step_scope
    if not deterministic:
        def scope(cfg):
            return step_mod.precision_scope(cfg.conv_precision)

    loss_fn = step_mod.make_loss_fn(cfg, True)
    tx = step_mod.make_optimizer(cfg.init_sup_sep_lr)
    params, opt = state.params, state.opt_state
    leaves = step_mod._leaves(params)
    parts = []
    torch.cuda.synchronize()
    t0 = None
    for i in range(TRAIN_TIMED_STEPS + 1):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        with scope(cfg):
            ev[0].record()
            batch = bank.sample(SEED, 10_000 + i)
            ev[1].record()
            with torch.enable_grad():
                for t in leaves:
                    t.requires_grad_(True)
                loss, _ = loss_fn(params, {}, batch)
                ev[2].record()
                flat = torch.autograd.grad(loss, leaves)
            ev[3].record()
            it = iter(flat)
            g = {k: {n: next(it) for n in v} for k, v in params.items()}
            tx.update_(params, g, opt)
            ev[4].record()
        if i:
            parts.append(ev)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
    names = ("sampler", "forward", "backward", "adam")
    ms = {n: float(np.median([e[j].elapsed_time(e[j + 1]) for e in parts]))
          for j, n in enumerate(names)}
    ms["device_total"] = float(np.median([e[0].elapsed_time(e[4])
                                          for e in parts]))
    ms["wall"] = wall_ms
    return ms


def fused_chunk(epoch_fn, state, key, torch):
    """Wall ms per step of TRAIN_CHUNK fused steps (graph replays; the graph
    exists already), and the device's idle share over them from a
    torch.profiler trace (busy = the sum of device kernel times)."""
    from torch.profiler import ProfilerActivity, profile

    epoch_fn(state.params, state.model_state, state.opt_state, key,
             state.step)  # the capture, if the graph is not there yet
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch_fn(state.params, state.model_state, state.opt_state, key,
             state.step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch_fn(state.params, state.model_state, state.opt_state, key,
                 state.step)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # kernel time as the profiler attributes it (graph kernels included)
    busy_us = sum(getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0)
                  for e in prof.key_averages())
    idle = (1.0 - busy_us / 1e6 / prof_wall) if busy_us > 0 else None
    return {"ms_per_step": 1e3 * wall / TRAIN_CHUNK,
            "profiled_ms_per_step": 1e3 * prof_wall / TRAIN_CHUNK,
            "device_busy_ms_per_step": busy_us / 1e3 / TRAIN_CHUNK,
            "device_idle_share": idle}


def fused_vs_eager(cfg, bank, loop, step_mod, torch, dev):
    """TRAIN_FUSED_STEPS steps from one initial state, eagerly and as the
    fused epoch (a warm-up step, a capture and replays): the parameters and
    Adam slots bit for bit."""
    from waveunet_tpu_torch.train.step import make_scanned_epoch

    lr = cfg.init_sup_sep_lr
    fcfg = cfg.replace(epoch_it=TRAIN_FUSED_STEPS)
    eager = loop.init_state(fcfg, device=dev)
    _, step_fn = step_mod.make_train_step(fcfg, lr, device=dev)
    eager, el = loop.train_one_epoch(fcfg, eager, step_fn,
                                     bank.batches(SEED, start=0))
    fused = loop.init_state(fcfg, device=dev)
    epoch_fn = make_scanned_epoch(fcfg, lr, TRAIN_FUSED_STEPS, bank.sample,
                                  chunk=2, device=dev)
    fused, fl = loop.train_one_epoch_scanned(fcfg, fused, epoch_fn, SEED)
    trees = [("params", fused.params, eager.params),
             ("mu", fused.opt_state["mu"], eager.opt_state["mu"]),
             ("nu", fused.opt_state["nu"], eager.opt_state["nu"])]
    differ = [f"{what} {k}/{n}" for what, a, b in trees for k in a
              for n in a[k] if not torch.equal(a[k][n], b[k][n])]
    row = {"steps": TRAIN_FUSED_STEPS, "batch": cfg.batch_size,
           "graph_captured": epoch_fn.graph_state.get("graph") is not None,
           "eager_mean_loss": el, "fused_mean_loss": fl,
           "identical": not differ}
    print(f"train fused vs eager: {json.dumps(row)}", flush=True)
    if not row["graph_captured"]:
        fail("the fused epoch captured no CUDA graph on the card")
    if differ or el != fl:
        fail(f"the fused epoch differs from the eager loop: {differ[:5]}")
    return row


def validation_check(cfg, ev, params, model, conv1d_fused, interp, kernels,
                     torch):
    """The EvalBank's sweep through the kernels (graph replays) against the
    same sweep through the plain path, with its launch counts: every eval
    batch's separated outputs (eager, kernels against plain) within
    FORWARD_ATOL, every batch's loss within BATCH_LOSS_RTOL and the mean
    within VALID_RTOL. Re-setting the same batch size and sweeping again
    (a new capture) gives the same losses bit for bit."""
    ev.evaluate(params, {})  # captures the sweep's graph
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = ev.evaluate(params, {})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = kernels.launch_counts()
    (g,) = ev._graphs.values()
    want = {k: ev.n_batches * g.launches[k] for k in counted}
    got_losses = ev.batch_losses(params, {})
    out_err = 0.0
    for i in range(ev.n_batches):
        mix = ev.batch_at(i)["mix"]
        est = model.apply_waveunet(params, cfg, mix, False)
        with plain_path(model, conv1d_fused, interp):
            ref = model.apply_waveunet(params, cfg, mix, False)
        out_err = max(out_err, *((est[k] - ref[k]).abs().max().item()
                                 for k in ref))
    with plain_path(model, conv1d_fused, interp):
        ev.evaluate(params, {}, graphed=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ev.evaluate(params, {}, graphed=False)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        plain_losses = ev.batch_losses(params, {}, graphed=False)
    ev.set_batch(ev.batch)
    again = ev.batch_losses(params, {})
    windows = ev.n_batches * ev.batch
    rel = abs(got - plain) / abs(plain)
    batch_rel = max(abs(float(a) - float(b)) / abs(float(b))
                    for a, b in zip(got_losses, plain_losses))
    row = {"batch": ev.batch, "batches": ev.n_batches, "windows": windows,
           "loss_kernels": got, "loss_plain": plain, "rel_err": rel,
           "batch_loss_rel_err_max": batch_rel,
           "output_max_abs_err": out_err,
           "resweep_after_set_batch_equal": bool((again == got_losses).all()),
           "launches": counted, "launches_per_batch": g.launches,
           "windows_per_s_kernels": windows / wall,
           "windows_per_s_plain": windows / plain_wall}
    print(f"train validation: {json.dumps(row)}", flush=True)
    if not out_err <= FORWARD_ATOL:
        fail(f"validation outputs through the kernels are {out_err:.3e} from "
             f"the plain path's (tol {FORWARD_ATOL})")
    if not batch_rel <= BATCH_LOSS_RTOL:
        fail(f"a validation batch's loss through the kernels is "
             f"{batch_rel:.3e} from the plain path's (tol {BATCH_LOSS_RTOL})")
    if not rel <= VALID_RTOL:
        fail(f"validation through the kernels is {rel:.3e} from the plain "
             f"path (tol {VALID_RTOL})")
    if not row["resweep_after_set_batch_equal"]:
        fail(f"the sweep after set_batch({ev.batch}) gave {again}, not "
             f"{got_losses}")
    if (g.launches.get("conv1d_lrelu") != 25
            or g.launches.get("learned_interp") != 12 or counted != want):
        fail(f"validation launched {counted}, not {ev.n_batches} batches x "
             f"(25 conv, 12 interp): graph {g.launches}")
    return row


def train_check(get_config, model, conv1d_fused, interp, kernels, np, torch,
                dev):
    """Phase train: full_44KHz training on the card from a synthesised
    song cache (the module docstring, phase 13)."""
    import tempfile

    from waveunet_tpu_torch.data import cache
    from waveunet_tpu_torch.data.audio_io import write_wav
    from waveunet_tpu_torch.data.device_cache import DeviceBank, EvalBank
    from waveunet_tpu_torch.ops import shapes
    from waveunet_tpu_torch.train import checkpoint as ckpt
    from waveunet_tpu_torch.train import loop
    from waveunet_tpu_torch.train import step as step_mod
    from waveunet_tpu_torch.bench import waveunet_conv_flops

    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        base = get_config("full_44KHz")
        cfg = base.replace(data_path=os.path.join(root, "cache"),
                           model_base_dir=os.path.join(root, "ckpt"),
                           log_dir=os.path.join(root, "logs"),
                           epoch_it=TRAIN_EPOCH_IT, worse_epochs=1)
        print(f"train: full_44KHz at full width ({cfg.num_layers} layers, "
              f"{cfg.num_initial_filters} filters, window {cfg.num_frames}, "
              f"batch {cfg.batch_size}, then {2 * cfg.batch_size}); "
              f"epoch_it {base.epoch_it} cut to {cfg.epoch_it}, "
              f"{TRAIN_SONGS} songs of {TRAIN_SONG_S} s", flush=True)
        t0 = time.perf_counter()
        make_train_songs(cache, write_wav, cfg, root, np)
        in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
        row = {"in_len": in_len, "out_len": out_len,
               "epoch_it": cfg.epoch_it,
               "data_s": time.perf_counter() - t0}

        bank = DeviceBank(cfg, "train", in_len, out_len, device=dev)
        bank_cpu = DeviceBank(cfg, "train", in_len, out_len, device="cpu")
        ev = EvalBank(cfg, "valid", in_len, out_len, device=dev)
        row["bank_bytes"] = bank.nbytes()
        row["eval_bank_bytes"] = ev.nbytes()
        print(f"train: DeviceBank {bank.n_songs} songs, {bank.nbytes()} "
              f"bytes; EvalBank {ev.n_windows} windows, {ev.nbytes()} bytes",
              flush=True)
        same = all(torch.equal(bank.sample(SEED, s)[k].cpu(),
                               bank_cpu.sample(SEED, s)[k])
                   for s in (0, 12345) for k in (*cfg.source_names, "mix"))
        row["sampler_card_equals_cpu"] = same
        if not same:
            fail("the device sampler draws other batches on the card")

        row["step_parity"] = step_parity(cfg, model, bank_cpu, step_mod,
                                         torch, dev)
        del bank_cpu

        # the training path, launch counts from 0 just before it
        kernels.reset_launches()
        t0 = time.perf_counter()
        best, test_loss = loop.optimise(cfg, experiment_id="chip",
                                        max_epochs_per_round=1, device=dev)
        torch.cuda.synchronize()
        row["optimise_s"] = time.perf_counter() - t0
        row["launches"] = kernels.launch_counts()
        recs = [json.loads(line) for line in open(
            os.path.join(cfg.log_dir, "chip", "metrics.jsonl"))]
        losses = {k: [r[k] for r in recs if k in r]
                  for k in ("sep_loss", "valid_loss", "test_loss")}
        row["losses"] = losses
        if not all(losses[k] and np.all(np.isfinite(losses[k]))
                   for k in losses):
            fail(f"training losses missing or not finite: {losses}")
        with open(os.path.join(cfg.model_base_dir, "chip", "best.txt")) as f:
            marked = f.read().strip()
        saved = ckpt.restore_checkpoint(marked)
        if marked != best or saved["step"] != int(saved["opt_state"]["count"]):
            fail(f"best.txt names {marked}, optimise returned {best}, step "
                 f"{saved['step']} count {saved['opt_state']['count']}")
        loop.optimise(cfg, experiment_id="chip_resume", resume_path=best,
                      max_epochs_per_round=1, device=dev)
        first = ckpt.restore_checkpoint(ckpt.step_path(
            cfg.model_base_dir, "chip_resume", saved["step"] + cfg.epoch_it))
        row["resume"] = {"from_step": saved["step"],
                         "first_step": first["step"],
                         "first_count": int(first["opt_state"]["count"])}
        if first["opt_state"]["count"] != saved["step"] + cfg.epoch_it:
            fail(f"the resumed run did not go on from the saved Adam slots: "
                 f"{row['resume']}")

        row["fused_vs_eager"] = fused_vs_eager(cfg, bank, loop, step_mod,
                                               torch, dev)

        # speed at both rounds' batches, from the trained state
        from waveunet_tpu_torch.train.step import make_scanned_epoch
        state = loop.init_state(cfg, device=dev)
        flops = waveunet_conv_flops(cfg, in_len)
        row["timing"] = {}
        for b in (cfg.batch_size, 2 * cfg.batch_size):
            bcfg = cfg.replace(batch_size=b)
            bank.set_batch(b)
            torch.cuda.reset_peak_memory_stats()
            eager_ms = step_breakdown(bcfg, bank, state, step_mod, torch)
            epoch_fn = make_scanned_epoch(bcfg, bcfg.init_sup_sep_lr,
                                          TRAIN_CHUNK, bank.sample,
                                          device=dev)
            fused = fused_chunk(epoch_fn, state, SEED, torch)
            torch.cuda.synchronize()
            steps_s = 1e3 / fused["ms_per_step"]
            t = {"eager_ms": eager_ms, "fused": fused,
                 "eager_ms_cudnn_nondeterministic": step_breakdown(
                     bcfg, bank, state, step_mod, torch,
                     deterministic=False),
                 "steps_per_s_fused": steps_s,
                 "steps_per_s_eager": 1e3 / eager_ms["wall"],
                 "trained_audio_s_per_s": steps_s * b * out_len
                 / cfg.expected_sr,
                 "conv_tflops_per_s": 3 * flops * b * steps_s / 1e12,
                 "max_memory_allocated": torch.cuda.max_memory_allocated()}
            row["timing"][b] = t
            del epoch_fn
            print(f"train timing batch {b}: {json.dumps(t)}", flush=True)
        row["validation"] = []
        for b in (cfg.batch_size, 2 * cfg.batch_size):
            ev.set_batch(b)
            row["validation"].append(validation_check(
                cfg, ev, state.params, model, conv1d_fused, interp, kernels,
                torch))
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    return row


# -- phases eval and cli --------------------------------------------------------

EVAL_SONGS = 2
EVAL_SONG_S = 20
EVAL_SILENT_S = (6, 8)   # song0's vocals: silent over these whole windows
EVAL_QUIET_S = (8, 10)   # and near-silent here, at EVAL_QUIET_GAIN: the
EVAL_QUIET_GAIN = 1e-3   # catastrophic class the fp32 scorer's gate reroutes
FP32_ATOL, FP32_RTOL = 0.01, 1e-4  # tests/test_bsseval_tpu.py:29-35
F64_ATOL = 1e-3          # against the host's exact assembly
F64_SDR_ATOL = 1e-9      # SDR against the host's FFT assembly (solve-free)
FLAGGED_ATOL = 1e-9      # windows the fp32 gate sent to the host fp64 scorer
HARNESS_ATOL = 1e-6      # the harness's JSON against the same scorer called
                         # directly on the same estimates
DB_CAP = 250.0           # tests/test_bsseval_tpu64.py: a denominator at the
                         # rounding floor (a silent source leaves no
                         # interference space) makes the dB value solver
                         # noise past this, "effectively infinite"


def make_eval_db(root, sr, write_wav, np):
    """A MUSDB test set in the decoded-WAV layout: EVAL_SONGS songs of
    EVAL_SONG_S s, stereo, vocals and accompaniment of seeded broadband
    noise (well-conditioned Grams), the mixture their clipped sum; song0's
    vocals silent over EVAL_SILENT_S (NaN rows) and near-silent over
    EVAL_QUIET_S (windows for the fp32 scorer's gate)."""
    rng = np.random.default_rng(SEED)
    n = EVAL_SONG_S * sr
    songs = []
    for i in range(EVAL_SONGS):
        d = os.path.join(root, "test", f"song{i}")
        os.makedirs(d)
        voc = 0.1 * rng.standard_normal((n, 2))
        acc = 0.1 * rng.standard_normal((n, 2))
        if i == 0:
            voc[EVAL_SILENT_S[0] * sr:EVAL_SILENT_S[1] * sr] = 0.0
            voc[EVAL_QUIET_S[0] * sr:EVAL_QUIET_S[1] * sr] *= EVAL_QUIET_GAIN
        write_wav(os.path.join(d, "vocals.wav"), voc, sr)
        write_wav(os.path.join(d, "accompaniment.wav"), acc, sr)
        write_wav(os.path.join(d, "mixture.wav"),
                  np.clip(voc + acc, -1.0, 1.0), sr)
        songs.append(f"song{i}")
    return songs


def timed_host_score(refs, ests, rate, assembly):
    """The host fp64 scorer on one track, and its wall seconds (runs in a
    spawned worker)."""
    from waveunet_tpu_torch.eval.bsseval import bss_eval_framewise

    t0 = time.perf_counter()
    res = bss_eval_framewise(refs, ests, rate, assembly=assembly)
    return res, time.perf_counter() - t0


def track_frames(path, np):
    """{metric: [S, frames]} of a per-track JSON, None as NaN."""
    with open(path) as f:
        targets = json.load(f)["targets"]
    return {k: np.array([[np.nan if fr["metrics"][k] is None
                          else fr["metrics"][k] for fr in t["frames"]]
                         for t in targets])
            for k in ("SDR", "ISR", "SIR", "SAR")}


def db_diff(a, b, np, cap=None):
    """Largest |a - b| in dB, NaN against NaN equal, NaN on one side only
    infinitely far; ``cap`` clips both first."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if cap is not None:
        a, b = np.minimum(a, cap), np.minimum(b, cap)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    d = np.abs(a - b)
    d[np.isnan(a)] = 0.0
    return float(d.max()) if d.size else 0.0


def eval_check(get_config, model, conv1d_fused, interp, kernels, np, torch):
    """Phase eval: evaluate_musdb with full_44KHz at full width and seeded
    weights on a synthesised test set, once per scorer (host fp64 in its
    spawned pool, the fp32 device scorer, the fp64 device scorer), each run
    with the launch counts set to 0 just before it; then the same songs
    separated and scored directly, timed, and held: the separation against
    the plain path, the fp32 scorer against the host on every window its
    gate left on the device and equal to it where the gate flagged, the
    fp64 scorer against the host's exact assembly, its SDR against the
    host's FFT assembly. Returns the phase's row; its temporary directory
    (``row["root"]``) is the cli phase's, which removes it."""
    import multiprocessing as mp
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from waveunet_tpu_torch.data.audio_io import write_wav
    from waveunet_tpu_torch.eval import harness
    from waveunet_tpu_torch.eval.bsseval_tpu import (bss_eval_framewise_tpu,
                                                     device_window_metrics)
    from waveunet_tpu_torch.eval.bsseval_tpu64 import (
        bss_eval_framewise_tpu64)
    from waveunet_tpu_torch.infer.engine import Separator, window_positions
    from waveunet_tpu_torch.train.loop import init_state

    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        cfg = get_config("full_44KHz", musdb_path=os.path.join(root, "db"))
        sr = cfg.expected_sr
        songs = make_eval_db(cfg.musdb_path, sr, write_wav, np)
        # cfg.seed's weights: those of the cli phase's random_init=1
        params = init_state(cfg).params
        sep = Separator(cfg, params)

        def chunks(n):
            n_win = len(window_positions(max(n, sep.in_len), sep.out_len))
            return len(sep._chunk_sizes(n_win))

        # the self-check's 2 s, then every song
        n_chunks = chunks(2 * sr) + EVAL_SONGS * chunks(EVAL_SONG_S * sr)
        want = {"conv1d_lrelu": (2 * cfg.num_layers + 1) * n_chunks,
                "learned_interp": cfg.num_layers * n_chunks,
                "conv1d_lrelu_im2col": 0}
        runs = {}
        for name, tpu_bss in (("host", False), ("fp32", True),
                              ("f64", "f64")):
            out = os.path.join(root, f"est_{name}")
            kernels.reset_launches()
            t0 = time.perf_counter()
            stats = harness.evaluate_musdb(cfg, params, output_path=out,
                                           tpu_bss=tpu_bss)
            wall = time.perf_counter() - t0
            counted = kernels.launch_counts()
            runs[name] = {
                "wall_s": wall, "launches": counted,
                "frames": {s: track_frames(os.path.join(out, "test",
                                                        f"{s}.json"), np)
                           for s in songs},
                "aggregate": [[float(v) for v in st] for st in stats]}
            print(f"eval evaluate_musdb tpu_bss={tpu_bss!r}: {wall:.3f} s, "
                  f"launches {counted} (expected {want}), aggregate "
                  f"{runs[name]['aggregate']}", flush=True)
            if counted != want:
                fail(f"evaluate_musdb ({name}) did not launch conv and "
                     f"interp once per layer of its {n_chunks} chunks")
            if len(stats) != 2 or not all(np.isfinite(st[0])
                                          and np.isfinite(st[2])
                                          for st in stats):
                fail(f"evaluate_musdb ({name}) aggregated to {stats}")

        # the same songs separated and scored directly, timed
        tols = plain_tols(cfg)
        pool = ProcessPoolExecutor(max_workers=2 * EVAL_SONGS,
                                   mp_context=mp.get_context("spawn"))
        per_track, host_futs = [], []
        try:
            for song, mix, rate, targets in harness.iter_tracks(
                    cfg.musdb_path, "test"):
                t0 = time.perf_counter()
                preds = harness.separate_track(sep, cfg, mix, rate)
                sep_wall = time.perf_counter() - t0
                with plain_path(model, conv1d_fused, interp):
                    plain = harness.separate_track(sep, cfg, mix, rate)
                err = {k: float(np.abs(preds[k] - plain[k]).max())
                       for k in preds}
                if any(not err[k] <= tols[k] for k in err):
                    fail(f"eval: {song}'s separation disagrees with the "
                         f"plain path: {err} (tol {tols})")
                _, refs, ests = harness.stack_sources(cfg, targets, preds,
                                                      mix.shape[0])
                host_futs.append([pool.submit(timed_host_score, refs, ests,
                                              rate, a)
                                  for a in ("fft", "exact")])
                row = {"song": song, "windows": refs.shape[1] // rate,
                       "separate_s": sep_wall, "max_abs_err_vs_plain": err,
                       "plain_tol": tols}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fp32 = bss_eval_framewise_tpu(refs, ests, rate)
                row["fp32_score_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                f64 = bss_eval_framewise_tpu64(refs, ests, rate)
                row["f64_score_s"] = time.perf_counter() - t0
                _, gates = device_window_metrics(refs, ests, rate)
                row["gates"] = gates.tolist()
                per_track.append((row, fp32, f64))
            host = [[f.result() for f in fs] for fs in host_futs]
        finally:
            pool.shutdown()

        rows = []
        for (row, fp32, f64), ((fft, fft_s), (exact, exact_s)) in zip(
                per_track, host):
            song = row["song"]
            row["host_score_s"], row["host_exact_score_s"] = fft_s, exact_s
            flagged = ~(np.asarray(row["gates"]) < 0.1)
            keep = ~flagged
            row["flagged_windows"] = np.nonzero(flagged)[0].tolist()
            h, d32, d64 = (runs[k]["frames"][song]
                           for k in ("host", "fp32", "f64"))
            # the harness's JSONs hold what the direct calls scored
            same = {k: max(db_diff(d32[k], fp32[k], np),
                           db_diff(d64[k], f64[k], np),
                           db_diff(h[k], fft[k], np)) for k in h}
            # A silent reference leaves the other sources no interference
            # space: their SIR denominator sits at the rounding floor, and
            # the JAX package's test of that case holds SDR, ISR and SAR
            # only (tests/test_bsseval_tpu.py:59-73); so does this one.
            silent = np.isnan(h["SDR"]).any(0)
            fp32_err, flagged_err, f64_err = {}, {}, {}
            for k in h:
                cols = keep & ~silent if k == "SIR" else keep
                a, b = d32[k][:, cols], h[k][:, cols]
                fp32_err[k] = db_diff(a, b, np)
                both = np.isnan(a) & np.isnan(b)
                over = np.abs(a - b) - (FP32_ATOL + FP32_RTOL * np.abs(b))
                if fp32_err[k] == float("inf") or (over[~both] > 0).any():
                    fail(f"eval: {song} {k}: the fp32 scorer is "
                         f"{fp32_err[k]} dB from the host on a window its "
                         f"gate did not flag")
                flagged_err[k] = db_diff(d32[k][:, flagged],
                                         h[k][:, flagged], np)
                f64_err[k] = db_diff(d64[k], exact[k], np, cap=DB_CAP)
            f64_sdr = db_diff(d64["SDR"], h["SDR"], np)
            row.update({"harness_vs_direct_db": same,
                        "fp32_vs_host_unflagged_db": fp32_err,
                        "fp32_vs_host_sir_silent_ref_windows_db": db_diff(
                            d32["SIR"][:, keep & silent],
                            h["SIR"][:, keep & silent], np),
                        "fp32_vs_host_flagged_db": flagged_err,
                        "f64_vs_host_exact_db": f64_err,
                        "f64_sdr_vs_host_fft_db": f64_sdr,
                        "nan_windows": int(silent.sum())})
            print(f"eval {json.dumps(row)}", flush=True)
            if any(not v <= HARNESS_ATOL for v in same.values()):
                fail(f"eval: {song}: the harness's JSON differs from the "
                     f"direct scores {same}")
            if any(not v <= FLAGGED_ATOL for v in flagged_err.values()):
                fail(f"eval: {song}: flagged windows differ from the host's")
            if any(not v <= F64_ATOL for v in f64_err.values()):
                fail(f"eval: {song}: the fp64 scorer is {f64_err} dB from "
                     f"the host's exact assembly")
            if not f64_sdr <= F64_SDR_ATOL:
                fail(f"eval: {song}: the fp64 scorer's SDR is {f64_sdr} dB "
                     f"from the host's")
            rows.append(row)
        if not any(r["nan_windows"] for r in rows) or not any(
                r["flagged_windows"] for r in rows):
            fail("eval: the silent stretches gave no NaN row or no window "
                 "flagged by the fp32 scorer's gate")
        windows = sum(r["windows"] for r in rows)
        summary = {name: {
            "evaluate_musdb_wall_s": runs[name]["wall_s"],
            "aggregate": runs[name]["aggregate"],
            "score_s_per_track": [r[key] for r in rows],
            "separate_s_per_track": [r["separate_s"] for r in rows],
            "windows_per_s": windows / sum(r[key] for r in rows)}
            for name, key in (("host", "host_score_s"),
                              ("fp32", "fp32_score_s"),
                              ("f64", "f64_score_s"))}
        summary["host"]["exact_score_s_per_track"] = [
            r["host_exact_score_s"] for r in rows]
        print(f"eval summary: {json.dumps(summary)}", flush=True)
        return {"tracks": rows, "scorers": summary, "windows": windows,
                "chunks_per_run": n_chunks,
                "launches": runs["host"]["launches"],
                "launches_by_scorer": {k: r["launches"]
                                       for k, r in runs.items()},
                "root": root, "params": params}
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise


def cli_check(get_config, kernels, eval_row, np, torch):
    """Phase cli: ``predict`` and ``evaluate`` (random_init=1, max_tracks=1,
    tpu_bss=1) through ``cli.main`` in this process, their WAVs equal byte
    for byte to ``separate_file``'s with the same seeded weights and their
    JSON to the eval phase's ``evaluate_musdb(tpu_bss=True)``; the launch
    counts of both commands."""
    import shutil

    from waveunet_tpu_torch import cli
    from waveunet_tpu_torch.infer.engine import separate_file

    root = eval_row.pop("root")
    params = eval_row.pop("params")
    try:
        db = os.path.join(root, "db")
        mix = os.path.join(db, "test", "song0", "mixture.wav")
        cfg = get_config("full_44KHz", musdb_path=db)
        kernels.reset_launches()
        t0 = time.perf_counter()
        cli.main(["predict", "full_44KHz", "random_init=1",
                  f"input_path={mix}",
                  f"output_path={os.path.join(root, 'cli_predict')}"])
        cli.main(["evaluate", "full_44KHz", f"musdb_path={db}",
                  "random_init=1", "max_tracks=1", "tpu_bss=1",
                  f"output_path={os.path.join(root, 'cli_eval')}"])
        wall = time.perf_counter() - t0
        counted = kernels.launch_counts()
        separate_file(cfg, params, mix,
                      output_path=os.path.join(root, "lib_predict"))
        same = {}
        for s in cfg.source_names:
            a, b = (open(os.path.join(root, d, f"mixture.wav_{s}.wav"),
                         "rb").read() for d in ("cli_predict", "lib_predict"))
            same[f"{s}.wav"] = a == b
        a, b = (open(os.path.join(root, d, "test", "song0.json"), "rb").read()
                for d in ("cli_eval", "est_fp32"))
        same["song0.json"] = a == b
        row = {"wall_s": wall, "outputs_equal_library": same,
               "launches": counted}
        print(f"cli {json.dumps(row)}", flush=True)
        if not all(same.values()):
            fail(f"cli: outputs differ from the library calls': {same}")
        if not (counted["conv1d_lrelu"] > 0 and counted["learned_interp"] > 0):
            fail("cli: the commands launched no conv or interp kernel")
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def plain_path(model, conv1d_fused, interp):
    """Route the model's conv and interp calls to the plain PyTorch versions
    (on the card) while the block runs; the kernels' yardstick only."""
    saved = (model.conv1d_lrelu, model.learned_interp)
    model.conv1d_lrelu = conv1d_fused.conv1d_lrelu_plain
    model.learned_interp = interp.learned_interp_plain
    try:
        yield
    finally:
        model.conv1d_lrelu, model.learned_interp = saved


if __name__ == "__main__":
    sys.exit(main())
