"""The model family is a plug-in: ``families/<network>.py``.

What the Wave-U-Net cells read is pinned as it was before the family was
taken out of the harness (the windows, the work, the weights, the
reference's stems), the family-free modules are kept free of it, and a
toy family, a configuration and a cell are added as files to a copy of
the benchmark and run there with no file edited.
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import catalog, families, harness, inputs, work
from benchmark.reference import engine

torch.set_num_threads(2)
CPU = torch.device("cpu")
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# -- pinned from the harness before the family was a plug-in -----------------

WORK = {  # config: (window, calls a window, {op: (calls, FLOPs, bytes)},
          #          work["flops"] a window, (calls, FLOPs) of 37 windows)
    "m5-highsr": ((196595, 65541), 38, {
        "conv": (25, 37480430880, 243536344),
        "interp": (12, 14164416, 56683584),
        "conv_out": (1, 6816264, 7340808)},
        37487247144, (114, 1387028144328)),
    "m6-multi": ((196595, 65541), 28, {
        "conv": (25, 37480430880, 243536344),
        "conv_out": (3, 20448792, 22022424)},
        37500879672, (84, 1387532547864)),
}
TRAIN = {"m5-highsr": ((147443, 16389), 68369964408),
         "m6-multi": ((147443, 16389), 68380191144)}
WEIGHTS_SEED = 2400001801
WEIGHTS = {  # config: (parameters, sha256 of the leaves in layout order)
    "m5-highsr": (10265550, "9f15b2982677cc7fefb2d39a35cb843dc6138121ec04d79"
                            "0284339c6a9bca89e"),
    "m6-multi": (10263498, "cde5edecd13418857abe7d7aa710ac59ea92ba71b51caaf9"
                           "92219c20161a46eb"),
}
# the reference's stems of a 0.8 s song at 44.1 kHz (seed 11), weights of
# seed 7, at the rehearsal's size: source: (frames, sum |x|, sum x^2,
# {frame: (left, right)})
STEMS = {
    "m5-highsr.songs": {
        "accompaniment": (35280, 6201.786677, 830.6219997, {
            28629: (0.07366414, 0.1148857), 3021: (-0.08655582, -0.08566067),
            6330: (-0.03588098, -0.1283), 8354: (0.2211982, 0.1792763)}),
        "vocals": (35280, 2319.423711, 114.3542153, {
            28629: (-0.008279793, 0.02857763), 3021: (0.0004244521,
                                                      -0.03068276),
            6330: (0.0319083, -0.0369318), 8354: (-0.02891833, 0.0535526)}),
    },
    "m6-multi.songs44k": {
        "bass": (17640, 3185.263947, 436.2605719, {
            14314: (0.03669086, -0.03425457), 1510: (-0.1635229, 0.1493604),
            3165: (-0.1645798, 0.07576677), 4177: (0.2148805, -0.1361748)}),
        "drums": (17640, 2284.289, 217.5357537, {
            14314: (0.02569181, -0.004215647), 1510: (0.03590938,
                                                      -0.09229484),
            3165: (0.08416549, -0.03990477), 4177: (0.1043394, -0.01289915)}),
        "other": (17640, 2421.248971, 271.9539305, {
            14314: (0.1173311, -0.06045572), 1510: (-0.07457315, 0.03982324),
            3165: (-0.0817843, 0.04292552), 4177: (0.2424148, -0.01901389)}),
        "vocals": (17640, 5334.659593, 1209.991729, {
            14314: (-0.1359118, 0.2020592), 1510: (0.099267, -0.2688462),
            3165: (0.1348636, -0.2449958), 4177: (-0.3649994, 0.4057131)}),
    },
}


@pytest.mark.parametrize("name", sorted(WORK))
def test_the_work_of_a_window_is_pinned(name):
    arch = catalog.load("configs", name)
    family = families.of(arch)
    window, n_calls, ops, flops, req = WORK[name]
    assert family.window(arch) == window
    calls = family.calls(arch, window[0], 1)
    assert len(calls) == n_calls
    for op, (n, op_flops, op_bytes) in ops.items():
        picked = [c for c in calls if c.op == op]
        assert (len(picked), sum(c.flops for c in picked),
                sum(c.bytes for c in picked)) == (n, op_flops, op_bytes)
    assert {c.op for c in calls} == set(ops)
    assert sum(c.flops for c in calls if c.op in family.FLOP_OPS) == flops
    r = list(work.request_calls(family.calls, arch, window[0], 37))
    assert (len(r), sum(c.flops for c in r if c.op in family.FLOP_OPS)) == req


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_the_training_window_and_flops_are_pinned(name):
    arch = catalog.load("configs", name)
    family = families.trainer(arch)
    window, flops = TRAIN[name]
    assert family.train_window(arch) == window
    assert family.train_flops(arch, window[0]) == flops


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_the_weights_are_pinned(name):
    arch = catalog.load("configs", name)
    params, state = families.of(arch).weights(arch, WEIGHTS_SEED, CPU)
    h = hashlib.sha256()
    n = 0
    for layer, leaves in params.items():
        for leaf, t in leaves.items():
            h.update(f"{layer}/{leaf}{tuple(t.shape)}".encode())
            h.update(t.contiguous().numpy().tobytes())
            n += t.numel()
    assert (n, h.hexdigest()) == WEIGHTS[name]
    assert state == {}


@pytest.mark.parametrize("cell", sorted(STEMS))
def test_the_reference_stems_are_pinned(cell):
    arch = harness.shrink(catalog.cell(cell))["arch"]
    family = families.of(arch)
    params, state = family.weights(arch, 7, CPU)
    song = inputs.songs([0.8], 44100, 11, CPU)[0]
    ref = engine.separate(
        lambda wins: family.forward(params, state, arch, wins, "fp32"),
        family.window(arch), arch, song, 44100, CPU,
        batch=arch["infer_batch"])
    assert set(ref) == set(STEMS[cell])
    for source, (frames, l1, l2, at) in STEMS[cell].items():
        x = ref[source].astype(np.float64)
        assert x.shape == (frames, 2)
        assert np.abs(x).sum() == pytest.approx(l1, rel=1e-5)
        assert (x ** 2).sum() == pytest.approx(l2, rel=1e-5)
        for i, lr in at.items():
            np.testing.assert_allclose(x[i], lr, atol=1e-5, rtol=0)


# -- the family-free modules --------------------------------------------------

GENERIC = ["inputs.py", "serving.py", "harness.py", "port.py", "work.py",
           "catalog.py", "run.py", "calibrate.py", "faults.py", "trace.py",
           "program_trace.py", "families/__init__.py", "reference/engine.py",
           "reference/sources.py", "reference/resample.py"]
# Wave-U-Net's leaves, ops, keys and name (the program's package names
# aside)
FAMILY_WORDS = re.compile(
    r"down_|interp|bottleneck|conv_out|filter_size|num_layers|"
    r"num_initial_filters|upsampling|waveunet|wave-u-net", re.I)


@pytest.mark.parametrize("path", GENERIC)
def test_the_generic_modules_name_no_family(path):
    with open(os.path.join(BENCH, path)) as f:
        text = re.sub(r"waveunet_tpu(_torch)?\b", "", f.read())
    assert not FAMILY_WORDS.findall(text), path


def test_an_unknown_network_is_refused_with_the_families():
    assert "unet" in families.names()
    with pytest.raises(families.FamilyError) as e:
        families.of({"network": "bs_roformer"})
    assert "'bs_roformer'" in str(e.value)
    assert "families: " + ", ".join(families.names()) in str(e.value)


# -- a family added as files --------------------------------------------------

TOY_FAMILY = '''"""A per-source learned gain: one [C, C * S] matmul a window."""
from benchmark import inputs
from benchmark.reference import gain
from benchmark.reference.sources import source_names
from benchmark.work import F32, Call

TINY = {"window": 256}
FLOP_OPS = ("matmul",)


def weights(arch, seed, device):
    S = len(source_names(arch))
    return inputs.uniform_leaves({"gain": {"matrix": (2, 2 * S)}},
                                 lambda leaf, shape: 0.5, seed, device), {}


def window(arch):
    return arch["window"], arch["window"]


def forward(params, state, arch, wins, precision):
    return gain.forward(params, arch, wins)


def calls(arch, in_len, b=1):
    S = len(source_names(arch))
    return [Call("matmul", 2.0 * b * in_len * 2 * 2 * S,
                 F32 * (b * in_len * 2 + 4 * S + b * in_len * 2 * S))]
'''
TOY_REFERENCE = '''"""The per-source gain's forward, plain PyTorch."""
from benchmark.reference.sources import source_names


def forward(params, arch, wins):
    y = wins @ params["gain"]["matrix"]
    return {n: y[..., 2 * i:2 * i + 2]
            for i, n in enumerate(source_names(arch))}
'''
TOY_CONFIG = {"name": "toy gain", "source": "https://example.org/toy",
              "network": "gain", "task": "voice", "expected_sr": 22050,
              "window": 4096, "infer_batch": 4, "output_type": "direct",
              "reduced": []}
TOY_READER = ('"""The window\'s work in FLOPs."""\n'
              'MOVES = "clip_latency_p95_ms"\nUNIT = "FLOP"\n'
              'LAYER = "forward"\n\n\ndef read(ctx):\n'
              '    return ctx.work["flops"]\n')
RUN = """import json
from benchmark import catalog, families, harness
out, _ = harness.run("toy.clips", 5, 0.0, rehearsal=True, control="fp32")
refused = []
for cell in ("toy.train-b16", "bad.clips"):
    try:
        harness.run(cell, 5, 0.0, rehearsal=True)
    except families.FamilyError as e:
        refused.append(str(e))
print(json.dumps([catalog.cells(), families.names(), out, refused]))
"""


def digest(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            if "__pycache__" not in base:
                p = os.path.join(base, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, d)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_a_family_is_added_as_files(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(copy)
    added = {
        "families/gain.py": TOY_FAMILY,
        "reference/gain.py": TOY_REFERENCE,
        "configs/toy.json": json.dumps(TOY_CONFIG),
        "configs/bad.json": json.dumps(dict(TOY_CONFIG, network="nope")),
        "workloads/toy.clips.json": json.dumps({
            "config": "toy", "traffic": "clips", "chips": 1,
            "limits": {"stem_gap": 1e-5}}),
        "workloads/toy.train-b16.json": json.dumps({
            "config": "toy", "traffic": "train-b16", "chips": 1,
            "limits": {"loss_gap": 1e-5}}),
        "workloads/bad.clips.json": json.dumps({
            "config": "bad", "traffic": "clips", "chips": 1,
            "limits": {"stem_gap": 1e-5}}),
        "metrics/toy_flops.clips.py": TOY_READER,
    }
    for rel, text in added.items():
        (copy / rel).write_text(text)
    p = subprocess.run([sys.executable, "-c", RUN], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    cells, names, out, refused = json.loads(p.stdout.splitlines()[-1])
    assert {"toy.clips", "toy.train-b16"} <= set(cells)
    assert names == ["gain", "unet"]
    # the reference in the program's place, at fp32: one request, exact
    assert out["correct"] is True and out["attempted"] == 1
    assert out["checks"]["stem_gap"]["value"] == 0.0
    # its work is the toy's own count: 2 x window x C x (C x S) a window
    # (stereo, two sources), over the windows the first request needed
    mix = harness.shrink(catalog.cell("m5-highsr.clips"))["mix"]
    lengths = inputs.lengths_s(mix["lengths_s"])
    n = int(round(lengths[inputs.order(len(lengths), 5)[0]] * 22050))
    windows = -(-max(n, 256) // 256)
    assert out["metrics"]["toy_flops.clips"]["value"] == (
        windows * 2.0 * 256 * 2 * 4)
    # a training cell of a family with no training hooks, and a network
    # with no family, are refused before anything is set up
    assert len(refused) == 2
    assert "'gain' has no training hooks" in refused[0]
    assert "no model family for network 'nope'; families: gain, unet" \
        in refused[1]
    after = digest(copy)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == sorted(added)
