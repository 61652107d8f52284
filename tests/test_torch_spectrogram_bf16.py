"""U7/U7a's opt-in bf16 compute (``compute_dtype="bfloat16"``) in the port
against the JAX package's, on the CPU.

At inference both packages round the operands of every 2-D conv to bf16
and sum them in fp32; in training both compute in fp32. The ops are held
tightly (1e-5 of the output's largest value, at 512 input channels); a
whole forward is held within the JAX package's own bf16 bound, 5e-3
(tests/test_spectrogram.py:145), since a bf16 forward is chaotic at its
rounding boundaries: an activation that differs in the 7th digit may round
to the neighbouring bf16 step and carry that into the next layer. Every
forward is also checked to differ from fp32 by more than 1e-5, so the bf16
path is really taken. Every entry point that reaches U7's inference is
driven: the forward, ``Separator`` on both wires and against the JAX
package's resident sweep, the stream, validation, and ``predict``,
``evaluate`` and ``train`` through the command line. Also
``conv2d_transpose(padding="VALID")`` and SAME with a kernel narrower than
its stride, as ``jax.lax.conv_transpose`` cuts them.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.config import get_config as jax_get_config
from waveunet_tpu.eval.harness import evaluate_musdb as jax_evaluate_musdb
from waveunet_tpu.infer.engine import Separator as JaxSeparator
from waveunet_tpu.infer.engine import separate_file as jax_separate_file
from waveunet_tpu.infer.streaming import StreamingSeparator as JaxStream
from waveunet_tpu.models.spectrogram_unet import (
    apply_spectrogram_unet as jax_apply, init_spectrogram_unet as jax_init)
from waveunet_tpu.ops import conv as jax_conv
from waveunet_tpu.train.step import make_eval_step as jax_make_eval_step

from waveunet_tpu_torch import cli
from waveunet_tpu_torch.compat.params import params_from_numpy
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.data.audio_io import load_wav, write_wav
from waveunet_tpu_torch.infer.engine import Separator
from waveunet_tpu_torch.infer.streaming import StreamingSeparator
from waveunet_tpu_torch.models import spectrogram_unet as su
from waveunet_tpu_torch.ops import conv as port_conv
from waveunet_tpu_torch.train import checkpoint as ckpt
from waveunet_tpu_torch.train.step import (make_eval_step, make_loss_fn,
                                           value_and_grad)
from test_torch_train_loop import make_cache
from torch_cpu import few_threads  # noqa: F401

SMALL = dict(num_layers=3, num_frames=768 * 15 + 1024, num_initial_filters=4,
             infer_batch=2, infer_num_frames=None)
OP_RTOL = 1e-5       # bf16 op vs the JAX op, of the output's largest value
ROUNDED_RTOL = 1e-4  # an unrounded fp32 op is further than this from it
BF16_ATOL = 5e-3     # a bf16 forward vs JAX's (tests/test_spectrogram.py)
DIFFERS = 1e-5       # bf16 vs fp32, at least (measured 2.5e-4 at SMALL)
WIRE_STEP = 1.0 / 32767


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tree(tree):
    return params_from_numpy(tree, "cpu")


def _leaves(p):
    return {k: _t(v) for k, v in p.items()}


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
               for k in b)


@pytest.fixture(scope="module")
def model():
    """JAX-initialised U7 params with perturbed biases and batch-norm
    statistics (numpy), and the bf16 and fp32 configs of both packages."""
    jcfg = jax_get_config("unet_spectrogram", **SMALL)
    p, st = jax_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * (
        rng.standard_normal(a.shape).astype(np.float32)), p)
    st = jax.tree_util.tree_map(lambda a: np.abs(np.asarray(a) + 0.1 * (
        rng.standard_normal(a.shape).astype(np.float32))), st)
    cfg = get_config("unet_spectrogram", **SMALL)
    return {"jcfg": jcfg.replace(compute_dtype="bfloat16"), "jcfg32": jcfg,
            "cfg": cfg.replace(compute_dtype="bfloat16"), "cfg32": cfg,
            "p": p, "st": st}


def _audio(n, channels=2, seed=5):
    return (0.2 * np.random.default_rng(seed).standard_normal(
        (n, channels))).astype(np.float32)


# -- the ops ------------------------------------------------------------------

@pytest.mark.parametrize("op", ["conv2d", "conv2d_transpose"])
def test_conv_ops_bf16_match_jax(op):
    """512 input channels, U7's widest: bf16 operands summed in fp32, the
    bias after; unrounded fp32 lies measurably further away."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 6, 512)).astype(np.float32)
    shape = (5, 5, 512, 24) if op == "conv2d" else (5, 5, 24, 512)
    p = {"kernel": (0.03 * rng.standard_normal(shape)).astype(np.float32),
         "bias": rng.standard_normal(24).astype(np.float32)}
    want = np.asarray(getattr(jax_conv, op)(
        jnp.asarray(x), _j(p), stride=(2, 2), compute_dtype=jnp.bfloat16))
    fn = getattr(port_conv, op)
    got = fn(_t(x), _leaves(p), stride=(2, 2), compute_dtype=torch.bfloat16)
    fp32 = fn(_t(x), _leaves(p), stride=(2, 2))
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= OP_RTOL * scale
    assert float((got - fp32).abs().max()) > ROUNDED_RTOL * scale


@pytest.mark.parametrize("k,s,padding", [
    ((5, 5), (2, 2), "VALID"), ((1, 1), (2, 2), "VALID"),
    ((2, 3), (3, 2), "VALID"), ((3, 3), (1, 1), "VALID"),
    # kernels narrower than their stride: the full output is zero-padded
    # at the end before the SAME crop
    ((1, 1), (2, 2), "SAME"), ((4, 1), (2, 3), "SAME")])
def test_conv2d_transpose_padding_matches_jax(k, s, padding):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    p = {"kernel": rng.standard_normal((*k, 4, 3)).astype(np.float32),
         "bias": rng.standard_normal(4).astype(np.float32)}
    want = np.asarray(jax_conv.conv2d_transpose(jnp.asarray(x), _j(p),
                                                stride=s, padding=padding))
    got = port_conv.conv2d_transpose(_t(x), _leaves(p), stride=s,
                                     padding=padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_conv2d_transpose_other_padding_raises():
    p = {"kernel": torch.zeros(5, 5, 2, 3), "bias": torch.zeros(2)}
    for padding in ("same", "FULL", [(1, 1), (1, 1)]):
        with pytest.raises(ValueError, match="padding"):
            port_conv.conv2d_transpose(torch.zeros(1, 4, 4, 3), p,
                                       padding=padding)


@pytest.mark.parametrize("conv_precision", [None, "default", "high",
                                            "highest"])
def test_round_operands_rounds_and_turns_tf32_off(conv_precision):
    """The one bf16 operand rule (the 2-D convs, conv1d's inference bf16 and
    Wave-U-Net's kernel path all take it): both operands rounded to bf16
    and back, their conv with TF32 off whatever ``conv_precision`` allows;
    without a compute dtype the operands and the ambient switches stay."""
    rng = np.random.default_rng(13)
    x = _t(rng.standard_normal((2, 7, 3)).astype(np.float32))
    k = _t(rng.standard_normal((3, 3, 4)).astype(np.float32))

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    with port_conv.precision_scope(conv_precision):
        ambient = flags()
        xr, kr, scope = port_conv.round_operands(x, k, torch.bfloat16)
        with scope:
            assert flags() == (False, False)
        assert flags() == ambient
        x0, k0, scope0 = port_conv.round_operands(x, k, None)
        with scope0:
            assert flags() == ambient
    assert x0 is x and k0 is k
    for got, t in ((xr, x), (kr, k)):
        assert got.dtype == torch.float32
        assert torch.equal(got, t.to(torch.bfloat16).float())
        assert not torch.equal(got, t)


# -- the forward --------------------------------------------------------------

@pytest.mark.parametrize("spectrogram", [False, True])
@pytest.mark.parametrize("preset", ["unet_spectrogram", "unet_spectrogram_l1"])
def test_forward_bf16_matches_jax(model, preset, spectrogram):
    jcfg = jax_get_config(preset, compute_dtype="bfloat16", **SMALL)
    cfg = get_config(preset, compute_dtype="bfloat16", **SMALL)
    mix = (0.3 * np.random.default_rng(4).standard_normal(
        (2, cfg.num_frames, 1))).astype(np.float32)
    want, _ = jax_apply(_j(model["p"]), jcfg, jnp.asarray(mix),
                        training=False, state=_j(model["st"]),
                        return_spectrogram=spectrogram)
    got, _ = su.apply_spectrogram_unet(_tree(model["p"]), cfg, _t(mix),
                                       state=_tree(model["st"]),
                                       return_spectrogram=spectrogram)
    fp32, _ = su.apply_spectrogram_unet(
        _tree(model["p"]), cfg.replace(compute_dtype="float32"), _t(mix),
        state=_tree(model["st"]), return_spectrogram=spectrogram)
    for s in cfg.source_names:
        assert got[s].shape == want[s].shape and got[s].dtype == torch.float32
    assert _max_diff(got, want) <= BF16_ATOL
    assert _max_diff(got, fp32) > DIFFERS


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_separator_bf16_matches_jax(model, wire):
    jcfg = model["jcfg"].replace(infer_wire_dtype=wire)
    cfg = model["cfg"].replace(infer_wire_dtype=wire)
    jsep = JaxSeparator(jcfg, _j(model["p"]), model_state=_j(model["st"]))
    sep = Separator(cfg, _tree(model["p"]), model_state=_tree(model["st"]),
                    device="cpu")
    sep32 = Separator(model["cfg32"].replace(infer_wire_dtype=wire),
                      _tree(model["p"]), model_state=_tree(model["st"]),
                      device="cpu")
    tol = BF16_ATOL + (WIRE_STEP if wire == "int16" else 0.0)
    for n in (sep.out_len * 2 + 917, sep.out_len // 3):  # 3 windows; short
        audio = _audio(n)
        got = sep.separate(audio, 8192)
        want = jsep.separate(audio, 8192)
        for s in cfg.source_names:
            assert got[s].shape == want[s].shape == (n, 1)
        assert _max_diff(got, want) <= tol
        assert _max_diff(got, sep32.separate(audio, 8192)) > DIFFERS


def test_separate_bf16_matches_jax_resident_sweep(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    sep = Separator(cfg, _tree(model["p"]), model_state=_tree(model["st"]),
                    device="cpu")
    jsep = JaxSeparator(jcfg, _j(model["p"]), model_state=_j(model["st"]))
    n = sep.out_len * 2 + 917
    audio = _audio(n, channels=1, seed=9)
    padded = np.pad(audio, [(sep.pad, sep.pad), (0, 0)])
    jout, _ = jsep.resident_sweep(n)[0](_j(model["p"]), jnp.asarray(padded))
    host = sep.separate(audio, cfg.expected_sr)
    assert all(np.isfinite(v).all() for v in host.values())
    assert _max_diff(host, jout) <= BF16_ATOL


def test_stream_bf16_matches_jax_stream(model):
    def stream(st, audio, sizes=(1111, 301, 2999)):
        got = {s: [] for s in st.cfg.source_names}
        off, i = 0, 0
        while off < audio.shape[0]:
            n = sizes[i % len(sizes)]
            for s, v in st.push(audio[off:off + n]).items():
                got[s].append(v)
            off, i = off + n, i + 1
        for s, v in st.flush().items():
            got[s].append(v)
        return {s: np.concatenate(v) for s, v in got.items()}

    port = StreamingSeparator(model["cfg"], _tree(model["p"]),
                              batch_windows=2, model_state=_tree(model["st"]),
                              device="cpu")
    audio = _audio(int(port.out_len * 2.6), channels=1, seed=7)
    got = stream(port, audio)
    want = stream(JaxStream(model["jcfg"], _j(model["p"]), batch_windows=2,
                            model_state=_j(model["st"])), audio)
    for s in model["cfg"].source_names:
        assert got[s].shape == want[s].shape == audio.shape
    assert _max_diff(got, want) <= BF16_ATOL


# -- training and validation --------------------------------------------------

def _batch(cfg, rows=2, seed=6):
    rng = np.random.default_rng(seed)
    batch = {s: (0.2 * rng.standard_normal((rows, cfg.num_frames, 1))
                 ).astype(np.float32) for s in cfg.source_names}
    batch["mix"] = sum(batch.values())
    return batch


def test_training_under_bf16_config_is_fp32(model):
    """A bf16 config trains exactly as the fp32 one: the same loss, moved
    statistics and gradients, bit for bit (the same dropout masks)."""
    batch = {k: _t(v) for k, v in _batch(model["cfg"]).items()}
    runs = []
    for cfg in (model["cfg"], model["cfg32"]):
        runs.append(value_and_grad(
            make_loss_fn(cfg, True), _tree(model["p"]), _tree(model["st"]),
            batch, torch.Generator().manual_seed(3)))
    (l16, st16, g16), (l32, st32, g32) = runs
    assert torch.equal(l16, l32)
    for a, b in ((st16, st32), (g16, g32)):
        assert list(a) == list(b)
        for k in b:
            for n in b[k]:
                assert torch.equal(a[k][n], b[k][n]), (k, n)


def test_validation_loss_bf16_matches_jax(model):
    """Validation (the eval step of train/loop.py) runs the bf16 inference
    forward: its loss is JAX's bf16 loss, and not the fp32 one."""
    batch = _batch(model["cfg"])
    losses = {}
    for name, cfg, jcfg in (("bf16", model["cfg"], model["jcfg"]),
                            ("fp32", model["cfg32"], model["jcfg32"])):
        got = float(make_eval_step(cfg, device="cpu")(
            _tree(model["p"]), _tree(model["st"]),
            {k: _t(v) for k, v in batch.items()}))
        want = float(jax_make_eval_step(jcfg)(
            _j(model["p"]), _j(model["st"]),
            {k: jnp.asarray(v) for k, v in batch.items()}))
        losses[name] = (got, want)
    got, want = losses["bf16"]
    # the loss is a mean of squares of outputs within BF16_ATOL of JAX's
    assert abs(got - want) <= 1e-3 * abs(want)
    assert got != losses["fp32"][0]
    assert abs(losses["fp32"][0] - losses["fp32"][1]) <= 1e-5 * abs(
        losses["fp32"][1])


# -- the command line ---------------------------------------------------------

@pytest.fixture(scope="module")
def cli_db(model, tmp_path_factory):
    """A port checkpoint of the shared params and statistics, one stereo
    test song of 3 s in the WAV layout, and its mixture file."""
    root = tmp_path_factory.mktemp("u7bf16")
    path = ckpt.save_checkpoint(str(root / "ckpts"), "jaxparams", 0, {
        "params": _tree(model["p"]), "model_state": _tree(model["st"])})
    rng = np.random.default_rng(2)
    d = root / "db" / "test" / "song"
    d.mkdir(parents=True)
    stems = {s: (0.2 * rng.standard_normal((3 * 8192, 2))).astype(np.float32)
             for s in ("vocals", "accompaniment")}
    for s, v in stems.items():
        write_wav(str(d / f"{s}.wav"), v, 8192)
    write_wav(str(d / "mixture.wav"), np.clip(sum(stems.values()), -1, 1),
              8192)
    return {"root": root, "ckpt": path, "db": str(root / "db"),
            "mix": str(d / "mixture.wav")}


_CLI_ARGS = ["unet_spectrogram", "compute_dtype=bfloat16", "num_layers=3",
             f"num_frames={SMALL['num_frames']}", "num_initial_filters=4",
             "infer_batch=2", "infer_num_frames=null", "platform=cpu"]


def test_cli_predict_bf16_matches_jax(model, cli_db, tmp_path):
    cli.main(["predict", *_CLI_ARGS, f"input_path={cli_db['mix']}",
              f"checkpoint={cli_db['ckpt']}",
              f"output_path={tmp_path / 'port'}"])
    jax_separate_file(model["jcfg"], _j(model["p"]), cli_db["mix"],
                      output_path=str(tmp_path / "jax"),
                      model_state=_j(model["st"]))
    for s in model["cfg"].source_names:
        name = f"mixture.wav_{s}.wav"
        got, sr = load_wav(str(tmp_path / "port" / name))
        want, jsr = load_wav(str(tmp_path / "jax" / name))
        assert sr == jsr == 8192 and got.shape == want.shape == (3 * 8192, 2)
        assert float(np.abs(got - want).max()) <= BF16_ATOL + WIRE_STEP


def test_cli_evaluate_bf16_matches_jax(model, cli_db, tmp_path):
    """``evaluate`` through the command line (the fp32 device scorer) on
    the shared checkpoint: the estimates within the bf16 bound of the JAX
    harness's, the same targets and frames, finite metrics."""
    cli.main(["evaluate", *_CLI_ARGS, f"musdb_path={cli_db['db']}",
              f"checkpoint={cli_db['ckpt']}", "subset=test", "tpu_bss=1",
              f"output_path={tmp_path / 'port'}"])
    jcfg = model["jcfg"].replace(musdb_path=cli_db["db"])
    jax_evaluate_musdb(jcfg, _j(model["p"]), model_state=_j(model["st"]),
                       output_path=str(tmp_path / "jax"), tpu_bss=True)
    for s in ("vocals", "accompaniment"):
        got = load_wav(str(tmp_path / "port" / "song" / f"{s}.wav"))[0]
        want = load_wav(str(tmp_path / "jax" / "song" / f"{s}.wav"))[0]
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= BF16_ATOL + WIRE_STEP
    docs = [json.loads((tmp_path / side / "test" / "song.json").read_text())
            for side in ("port", "jax")]
    frames = [{t["name"]: [(f["time"], f["duration"]) for f in t["frames"]]
               for t in d["targets"]} for d in docs]
    assert frames[0] == frames[1]
    assert all(np.isfinite(v) for t in docs[0]["targets"]
               for f in t["frames"] for v in f["metrics"].values())


def test_cli_train_bf16_trains_as_fp32(tmp_path):
    """``train`` on a bf16 U7 config: the same trained parameters and
    statistics as the fp32 config's, bit for bit; validation, in bf16,
    logs other losses."""
    args = ["num_layers=2", "num_initial_filters=4",
            f"num_frames={768 * 7 + 1024}", "batch_size=1", "epoch_it=2",
            "num_snippets_per_track=2", "cache_size=4", "worse_epochs=1",
            f"data_path={tmp_path / 'cache'}", "platform=cpu"]
    make_cache(tmp_path, get_config("unet_spectrogram", num_layers=2,
                                    num_frames=768 * 7 + 1024,
                                    data_path=str(tmp_path / "cache")),
               seconds=1.2)
    trained, logged = {}, {}
    for dtype in ("bfloat16", "float32"):
        cli.main(["train", "unet_spectrogram", *args,
                  f"compute_dtype={dtype}", f"experiment_id={dtype}",
                  f"model_base_dir={tmp_path / 'ckpts'}",
                  f"log_dir={tmp_path / 'logs'}", "max_epochs=1"])
        best = (tmp_path / "ckpts" / dtype / "best.txt").read_text().strip()
        trained[dtype] = ckpt.restore_checkpoint(best)
        with open(tmp_path / "logs" / dtype / "metrics.jsonl") as f:
            logged[dtype] = [json.loads(line) for line in f]
    a, b = trained["bfloat16"], trained["float32"]
    for tree in ("params", "model_state"):
        for k in b[tree]:
            for n in b[tree][k]:
                assert torch.equal(a[tree][k][n], b[tree][k][n]), (k, n)
    valid = {d: [r["valid_loss"] for r in rows if "valid_loss" in r]
             for d, rows in logged.items()}
    assert valid["float32"] and len(valid["bfloat16"]) == len(
        valid["float32"])
    assert valid["bfloat16"] != valid["float32"]
