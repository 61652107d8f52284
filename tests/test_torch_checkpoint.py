"""The port's TensorFlow-free checkpoint reader and converters, on the CPU.

``waveunet_tpu_torch.compat.tf_checkpoint.read_checkpoint`` parses Saver-V2
files with the standard library and numpy. Every checkpoint under
tests/golden/ is read by it and by TensorFlow (``tf.train.load_checkpoint``,
what the JAX package's ``read_tf_checkpoint`` runs in its subprocess; one
subprocess here reads them all) and compared byte for byte; one checkpoint
also goes through ``read_tf_checkpoint`` itself. Then every golden forward
runs through the port's own loader at the reference's tolerances: 2e-5 for
the Wave-U-Net (the 12-layer full_44KHz and the 14-layer checkpoints
included), 5e-5 for U7.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from waveunet_tpu.compat.tf_checkpoint import read_tf_checkpoint

from waveunet_tpu_torch.compat import tf_checkpoint as ck
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.models.spectrogram_unet import apply_spectrogram_unet
from waveunet_tpu_torch.models.waveunet import apply_waveunet
from test_compat import _CASES as TF_CASES
from test_compat_ref import _CASES as REF_CASES
from torch_cpu import few_threads  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PREFIXES = sorted(p[:-len(".index")] for p in glob.glob(
    os.path.join(GOLDEN, "**", "model.ckpt.index"), recursive=True))
SPECTRO = dict(num_layers=3, num_frames=768 * 15 + 1024, batch_size=1,
               num_initial_filters=8)

_TF_SCRIPT = r"""
import os, sys
os.environ["CUDA_VISIBLE_DEVICES"] = ""
import numpy as np
import tensorflow as tf
out = sys.argv[1]
for i, prefix in enumerate(sys.argv[2:]):
    reader = tf.train.load_checkpoint(prefix)
    arrays = {name.replace("/", "|"): reader.get_tensor(name)
              for name in reader.get_variable_to_shape_map()}
    np.savez(os.path.join(out, f"{i}.npz"), **arrays)
"""


def _name(prefix):
    return os.path.relpath(os.path.dirname(prefix), GOLDEN)


@pytest.fixture(scope="module")
def tf_arrays(tmp_path_factory):
    """{prefix: {name: array}} of every golden checkpoint, read by
    TensorFlow in one subprocess."""
    out = tmp_path_factory.mktemp("tf_read")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", _TF_SCRIPT, str(out),
                          *PREFIXES], capture_output=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    arrays = {}
    for i, prefix in enumerate(PREFIXES):
        with np.load(out / f"{i}.npz") as z:
            arrays[prefix] = {k.replace("|", "/"): z[k] for k in z.files}
    return arrays


def test_every_golden_checkpoint_is_found():
    assert len(PREFIXES) == 12
    assert {_name(p).split(os.sep)[0] for p in PREFIXES} == {
        "spectro_ref", "spectro_tf", "waveunet_ref", "waveunet_tf"}


@pytest.mark.parametrize("prefix", PREFIXES, ids=_name)
def test_reader_byte_equal_to_tensorflow(tf_arrays, prefix):
    got, want = ck.read_checkpoint(prefix), tf_arrays[prefix]
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert a.dtype == np.float32, name
        assert got[name].dtype == np.float32 and got[name].shape == a.shape
        assert got[name].tobytes() == a.tobytes(), name


def test_reader_byte_equal_to_read_tf_checkpoint():
    prefix = os.path.join(GOLDEN, "waveunet_ref",
                          "context_learned_diff_stereo", "model.ckpt")
    got, want = ck.read_checkpoint(prefix), read_tf_checkpoint(prefix)
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert got[name].tobytes() == np.asarray(a, np.float32).tobytes()


def _waveunet_cases():
    cases = [("waveunet_ref", c, kw) for c, kw in REF_CASES.items()]
    cases += [("waveunet_tf", c, kw) for c, kw in TF_CASES.items()]
    return sorted(cases, key=lambda c: (c[0], c[1]))


@pytest.mark.parametrize("family,case,kw", _waveunet_cases(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_waveunet_golden_through_the_port_loader(family, case, kw):
    kw = dict(kw)
    cfg = get_config(kw.pop("preset"), **kw)
    params = ck.load_tf_waveunet(os.path.join(GOLDEN, family, case,
                                              "model.ckpt"), cfg,
                                 device="cpu")
    z = np.load(os.path.join(GOLDEN, family, f"{case}.npz"))
    out = apply_waveunet(params, cfg, torch.from_numpy(z["mix"]))
    for name in cfg.source_names:
        want = z[f"out_{name}"]
        assert out[name].shape == want.shape, name
        np.testing.assert_allclose(out[name].numpy(), want, atol=2e-5,
                                   err_msg=f"{family}/{case}/{name}")


@pytest.mark.parametrize("family", ["spectro_ref", "spectro_tf"])
def test_spectrogram_golden_through_the_port_loader(family):
    cfg = get_config("unet_spectrogram", **SPECTRO)
    params, state = ck.load_tf_spectrogram(
        os.path.join(GOLDEN, family, "model.ckpt"), cfg, device="cpu")
    z = np.load(os.path.join(GOLDEN, family, "golden.npz"))
    mix = torch.from_numpy(z["mix"])
    out, _ = apply_spectrogram_unet(params, cfg, mix, state=state)
    for name in cfg.source_names:
        want = z[f"out_{name}"]
        assert out[name].shape == want.shape
        np.testing.assert_allclose(out[name].numpy(), want, atol=5e-5,
                                   err_msg=f"{family}/{name}")
    if family == "spectro_ref":  # U7a's magnitude head
        mags, _ = apply_spectrogram_unet(params, cfg, mix, state=state,
                                         return_spectrogram=True)
        for name in cfg.source_names:
            np.testing.assert_allclose(mags[name].numpy(), z[f"mag_{name}"],
                                       atol=5e-5, err_msg=f"mag {name}")


def test_name_mapping_matches_jax():
    from waveunet_tpu.compat import tf_checkpoint as jck
    from waveunet_tpu.config import get_config as jax_get_config

    for preset, kw in (("full", dict(num_layers=3)),
                       ("full_multi_instrument", dict(num_layers=4))):
        cfg, jcfg = get_config(preset, **kw), jax_get_config(preset, **kw)
        keys = (["bottleneck"] + [f"{p}_{i}" for p in ("down", "up", "interp")
                                  for i in range(cfg.num_layers)]
                + [f"out_{s}" for s in cfg.source_names])
        for key in keys:
            assert ck.tf_var_prefix(cfg, key) == jck.tf_var_prefix(jcfg, key)
    cfg = get_config("unet_spectrogram", **SPECTRO)
    jcfg = jax_get_config("unet_spectrogram", **SPECTRO)
    for s in cfg.source_names:
        for rest in ("down_0", "down_2_bn", "up_1", "up_0_bn", "mask"):
            key = f"{s}/{rest}"
            assert (ck.tf_spectro_var_prefix(cfg, key)
                    == jck.tf_spectro_var_prefix(jcfg, key))


def test_missing_variable_raises_key_error():
    cfg = get_config("full", num_layers=3, num_frames=512,
                     num_initial_filters=8)
    prefix = os.path.join(GOLDEN, "waveunet_ref",
                          "context_learned_diff_stereo", "model.ckpt")
    arrays = ck.read_checkpoint(prefix)
    del arrays["separator/interp_1"]
    with pytest.raises(KeyError, match="interp_1"):
        ck.load_tf_waveunet(prefix, cfg, arrays=arrays, device="cpu")
    with pytest.raises(KeyError, match="missing TF variable"):
        ck.load_tf_spectrogram(prefix, get_config("unet_spectrogram",
                                                  **SPECTRO),
                               arrays={}, device="cpu")


def test_wrong_shape_raises():
    cfg = get_config("full", num_layers=3, num_frames=512,
                     num_initial_filters=6)  # the checkpoint has 8
    prefix = os.path.join(GOLDEN, "waveunet_ref",
                          "context_learned_diff_stereo", "model.ckpt")
    with pytest.raises(ValueError, match="shape"):
        ck.load_tf_waveunet(prefix, cfg, device="cpu")


def _copy_checkpoint(prefix, tmp_path):
    dst = str(tmp_path / "model.ckpt")
    for src in glob.glob(prefix + ".*"):
        with open(src, "rb") as f:
            data = f.read()
        with open(dst + src[len(prefix):], "wb") as f:
            f.write(data)
    return dst


def test_compressed_block_raises(tmp_path):
    """A block whose trailer names a compression (Snappy = 1) is refused."""
    prefix = _copy_checkpoint(os.path.join(
        GOLDEN, "waveunet_ref", "same_linear_direct_mono", "model.ckpt"),
        tmp_path)
    with open(prefix + ".index", "rb") as f:
        data = bytearray(f.read())
    # the index block's handle sits at the start of the footer
    footer = bytes(data[-ck.FOOTER_LEN:])
    _, pos = ck._varint(footer, 0)
    _, pos = ck._varint(footer, pos)
    off, pos = ck._varint(footer, pos)
    size, _ = ck._varint(footer, pos)
    assert data[off + size] == 0
    data[off + size] = 1
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="compressed"):
        ck.read_checkpoint(prefix)


def test_bad_magic_raises(tmp_path):
    prefix = _copy_checkpoint(os.path.join(
        GOLDEN, "waveunet_ref", "same_linear_direct_mono", "model.ckpt"),
        tmp_path)
    with open(prefix + ".index", "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x00")
    with pytest.raises(ValueError, match="magic"):
        ck.read_checkpoint(prefix)


def _varint_bytes(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(number, value):
    """One protobuf field: a varint for an int, length-delimited bytes."""
    if isinstance(value, int):
        return _varint_bytes(number << 3) + _varint_bytes(value)
    return _varint_bytes(number << 3 | 2) + _varint_bytes(len(value)) + value


def _sstable_block(items):
    """An uncompressed SSTable block of unshared keys with one restart at
    0, followed by its trailer (compression 0, a CRC the reader skips)."""
    body = b"".join(_varint_bytes(0) + _varint_bytes(len(k))
                    + _varint_bytes(len(v)) + k + v for k, v in items)
    body += (0).to_bytes(4, "little") + (1).to_bytes(4, "little")
    return body, b"\x00" * ck.BLOCK_TRAILER_LEN


def _write_checkpoint(prefix, arrays, dtypes):
    """A one-shard Saver-V2 checkpoint written by hand: ``arrays`` as raw
    little-endian bytes, each entry with its TF dtype number ``dtypes``."""
    data, entries = bytearray(), {}
    for name in sorted(arrays):
        a = np.asarray(arrays[name])  # tobytes() is C order
        shape = b"".join(_field(2, _field(1, d)) for d in a.shape)
        entries[name.encode()] = (_field(1, dtypes[name]) + _field(2, shape)
                                  + _field(4, len(data))
                                  + _field(5, a.nbytes))
        data += a.tobytes()
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(bytes(data))
    items = [(b"", _field(1, 1))] + sorted(entries.items())
    index = bytearray()
    handles = []
    for block_items in (items, []):  # the data block, the metaindex block
        body, trailer = _sstable_block(block_items)
        handles.append(_varint_bytes(len(index)) + _varint_bytes(len(body)))
        index += body + trailer
    body, trailer = _sstable_block([(items[-1][0], handles[0])])
    index_handle = _varint_bytes(len(index)) + _varint_bytes(len(body))
    index += body + trailer
    footer = handles[1] + index_handle
    index += footer + b"\x00" * (40 - len(footer))
    index += ck.TABLE_MAGIC.to_bytes(8, "little")
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(index))


def _golden_with(tmp_path, **extra):
    """The context_learned_diff_stereo checkpoint rewritten by hand with
    ``extra`` variables ({name: (array, TF dtype)}) beside its own."""
    golden = os.path.join(GOLDEN, "waveunet_ref",
                          "context_learned_diff_stereo", "model.ckpt")
    arrays = ck.read_checkpoint(golden)
    dtypes = {name: ck.DT_FLOAT for name in arrays}
    for name, (a, dt) in extra.items():
        arrays[name], dtypes[name] = a, dt
    prefix = str(tmp_path / "model.ckpt")
    _write_checkpoint(prefix, arrays, dtypes)
    return golden, prefix


def test_int64_global_step_is_read_beside_the_floats(tmp_path):
    """Saver-V2 checkpoints of the reference also hold an int64
    ``global_step``: it is read as int64, and the converter, which never
    asks for it, loads the same params as from the float-only golden."""
    cfg = get_config("full", num_layers=3, num_frames=512,
                     num_initial_filters=8)
    golden, prefix = _golden_with(
        tmp_path, global_step=(np.array(123456789012, np.int64), 9))
    arrays = ck.read_checkpoint(prefix)
    assert arrays["global_step"].dtype == np.int64
    assert arrays["global_step"].shape == ()
    assert int(arrays["global_step"]) == 123456789012
    want = ck.read_checkpoint(golden)
    assert sorted(arrays) == sorted([*want, "global_step"])
    for name, a in want.items():
        assert arrays[name].dtype == np.float32
        assert arrays[name].tobytes() == a.tobytes(), name
    got = ck.load_tf_waveunet(prefix, cfg, device="cpu")
    ref = ck.load_tf_waveunet(golden, cfg, device="cpu")
    for layer, leaves in ref.items():
        for leaf, t in leaves.items():
            assert torch.equal(got[layer][leaf], t), (layer, leaf)


def test_non_float_variable_raises(tmp_path):
    """A variable the converter loads that is not DT_FLOAT is refused by
    the converter; the reader itself reads it as its own dtype."""
    cfg = get_config("full", num_layers=3, num_frames=512,
                     num_initial_filters=8)
    _, prefix = _golden_with(tmp_path)
    arrays = ck.read_checkpoint(prefix)
    name = "separator/interp_1"
    arrays[name] = arrays[name].astype(np.int32)
    _write_checkpoint(prefix, arrays, {
        n: (3 if n == name else ck.DT_FLOAT) for n in arrays})  # DT_INT32
    assert ck.read_checkpoint(prefix)[name].dtype == np.int32
    with pytest.raises(ValueError, match="only DT_FLOAT"):
        ck.load_tf_waveunet(prefix, cfg, device="cpu")
