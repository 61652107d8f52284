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
     and on the CPU (the plain path), compared.

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

# Per-phase watchdog limits in seconds; the whole run aims at under 5 min.
LIMITS = {"nvidia-smi": 30, "build": 400, "kernels": 120, "timing": 180,
          "im2col": 240, "serve": 420, "forward": 300, "presets": 240}

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
            plain_out = sep.separate(requests[0], sr)
        err = max((fwd_kernel[k] - fwd_plain[k]).abs().max().item()
                  for k in fwd_kernel)
        print(f"forward of {len(pos)} windows, kernels vs plain: max_abs_err "
              f"{err:.3e} (tol {FORWARD_ATOL})", flush=True)
        if not err <= FORWARD_ATOL:
            fail("the kernel forward disagrees with the plain forward")
        kernel_out = sep.separate(requests[0], sr)
        err2 = max(float(np.abs(kernel_out[k] - plain_out[k]).max())
                   for k in kernel_out)
        print(f"2 s request, kernels vs plain: max_abs_err {err2:.3e} "
              f"(tol {FORWARD_ATOL})", flush=True)
        if not err2 <= FORWARD_ATOL:
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
              launches["conv1d_lrelu"], edge_shapes=edge_rows),
        entry("learned_interp", interp_rows,
              "waveunet_tpu_torch/ops/kernels/csrc/learned_interp.cu",
              "waveunet_tpu/ops/pallas/interp.py:41",
              launches["learned_interp"]),
        # its own path is phase "im2col" (the counterpart of
        # tools/pallas_im2col_bench.py); the served requests launch it never
        entry("conv1d_lrelu_im2col", im2col_rows,
              "waveunet_tpu_torch/ops/kernels/csrc/conv1d_lrelu_im2col.cu",
              "waveunet_tpu/ops/pallas/conv1d_im2col.py:44",
              launches_by_phase["im2col"],
              launches_by_phase=dict(launches_by_phase,
                                     serve=launches["conv1d_lrelu_im2col"]),
              edge_shapes=im2col_edge_rows, tool_shapes=tool_rows,
              tool_sums=tool_sum),
    ]
    print(f"chip_smoke total: {time.perf_counter() - t_start:.3f} s "
          f"(after interpreter start)", flush=True)
    print(f"served: {json.dumps(served)}", flush=True)
    print(f"presets: {json.dumps(preset_rows)}", flush=True)
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
    forward chunk (CUDA events around each chunk's framing and forward). The
    rest of the wall time is host work, copies and launch gaps."""
    chunks = []
    forward_chunk = sep._forward_chunk

    def timed(song, pos):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward_chunk(song, pos)
        end.record()
        chunks.append((len(pos), start, end))
        return out

    sep._forward_chunk = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sep.separate(audio, sr)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
    finally:
        del sep._forward_chunk  # back to the class's method
    chunk_ms = [s.elapsed_time(e) for _, s, e in chunks]
    return {"seconds": audio.shape[0] / sr,
            "chunks": [k for k, _, _ in chunks], "chunk_ms": chunk_ms,
            "device_ms": sum(chunk_ms), "wall_ms": wall_ms,
            "device_idle_share": 1.0 - sum(chunk_ms) / wall_ms}


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
