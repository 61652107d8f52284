"""TF Saver-V2 checkpoints -> the port's parameters, without TensorFlow.

Counterpart of ``waveunet_tpu/compat/tf_checkpoint.py``. That module reads a
checkpoint by running TensorFlow in a subprocess; this one parses the files
with the standard library and numpy, so a machine without TensorFlow loads
the reference's pretrained zoo:

  * ``<prefix>.index`` is an SSTable (LevelDB's table format): data blocks of
    prefix-compressed keys with a restart array, a 5-byte trailer per block
    (compression byte, which must be 0 = uncompressed, and a CRC), an index
    block pointing at the data blocks, and a 48-byte footer ending in the
    magic ``0xdb4775248b80fb57``. The empty key holds a ``BundleHeaderProto``
    (shard count, endianness); every other key is a variable name whose
    value is a ``BundleEntryProto`` (dtype, shape, shard_id, offset, size);
  * ``<prefix>.data-<shard>-of-<count>`` hold the raw tensor bytes.

Numeric variables are read as their own dtype (the reference's checkpoints
also hold an int64 ``global_step``); others, such as strings, are left out.
The converters load ``DT_FLOAT`` variables only and raise on any other. The
name mapping (``tf_var_prefix``, ``tf_spectro_var_prefix``) and the converters
(``load_tf_waveunet``, ``load_tf_spectrogram``) follow the JAX package.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.device import DeviceLike, resolve_device

TABLE_MAGIC = 0xdb4775248b80fb57
FOOTER_LEN = 48
BLOCK_TRAILER_LEN = 5
DT_FLOAT = 1
# TF DataType -> the numpy dtype of its raw little-endian bytes in a shard
NUMPY_DTYPES = {1: "<f4", 2: "<f8", 3: "<i4", 4: "u1", 5: "<i2", 6: "i1",
                9: "<i8", 10: "?", 17: "<u2", 19: "<f2", 22: "<u4", 23: "<u8"}


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """A protobuf / LevelDB base-128 varint at ``pos``: (value, next pos)."""
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a serialised protobuf message:
    an int for varint and fixed fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            value = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _block(data: bytes, offset: int, size: int) -> bytes:
    """The contents of the block at (offset, size), its trailer checked."""
    if offset + size + BLOCK_TRAILER_LEN > len(data):
        raise ValueError("block handle points past the end of the index")
    compression = data[offset + size]
    if compression != 0:
        raise ValueError(f"compressed SSTable block (type {compression}) at "
                         f"offset {offset}: only uncompressed blocks are read")
    return data[offset:offset + size]


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) of every entry of one block, in order."""
    if len(block) < 4:
        raise ValueError("SSTable block too short")
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * n_restarts
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + n_value]
        pos += n_value


def read_index(prefix: str) -> Tuple[Dict, Dict[str, Dict]]:
    """(header, entries) of ``<prefix>.index``: the BundleHeaderProto's
    fields and, per variable, its BundleEntryProto's fields."""
    with open(prefix + ".index", "rb") as f:
        data = f.read()
    if len(data) < FOOTER_LEN:
        raise ValueError(f"{prefix}.index is too short for an SSTable")
    footer = data[-FOOTER_LEN:]
    if struct.unpack_from("<Q", footer, 40)[0] != TABLE_MAGIC:
        raise ValueError(f"{prefix}.index: bad SSTable magic")
    pos = 0
    _, pos = _varint(footer, pos)  # metaindex handle: unused
    _, pos = _varint(footer, pos)
    idx_off, pos = _varint(footer, pos)
    idx_size, pos = _varint(footer, pos)
    header: Dict = {"num_shards": 1, "endianness": 0}
    entries: Dict[str, Dict] = {}
    for _, handle in _block_entries(_block(data, idx_off, idx_size)):
        off, p = _varint(handle, 0)
        size, _ = _varint(handle, p)
        for key, value in _block_entries(_block(data, off, size)):
            if key == b"":
                for field, _, v in _proto_fields(value):
                    if field == 1:
                        header["num_shards"] = v
                    elif field == 2:
                        header["endianness"] = v
                continue
            entry = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0,
                     "size": 0}
            for field, _, v in _proto_fields(value):
                if field == 1:
                    entry["dtype"] = v
                elif field == 2:
                    entry["shape"] = _shape(v)
                elif field == 3:
                    entry["shard_id"] = v
                elif field == 4:
                    entry["offset"] = v
                elif field == 5:
                    entry["size"] = v
                elif field == 7:
                    raise ValueError(f"{key.decode()}: partitioned (sliced) "
                                     f"variables are not supported")
            entries[key.decode()] = entry
    return header, entries


def _shape(buf: bytes) -> List[int]:
    """The dims of a TensorShapeProto."""
    dims = []
    for field, _, dim in _proto_fields(buf):
        if field == 2:
            size = 0
            for f, _, v in _proto_fields(dim):
                if f == 1:
                    size = v
            dims.append(size)
        elif field == 3 and dim:
            raise ValueError("checkpoint tensor of unknown rank")
    return dims


def read_checkpoint(prefix: str) -> Dict[str, np.ndarray]:
    """Every numeric variable of a Saver-V2 checkpoint as a numpy array of
    its own dtype (float32 for ``DT_FLOAT``); variables of other types
    (strings, resources) are left out."""
    header, entries = read_index(prefix)
    if header["endianness"] != 0:
        raise ValueError(f"{prefix}: big-endian checkpoints are not read")
    n_shards = header["num_shards"]
    shards: Dict[int, bytes] = {}
    arrays = {}
    for name, e in entries.items():
        dtype = NUMPY_DTYPES.get(e["dtype"])
        if dtype is None:
            continue
        sid = e["shard_id"]
        if sid not in shards:
            path = f"{prefix}.data-{sid:05d}-of-{n_shards:05d}"
            with open(path, "rb") as f:
                shards[sid] = f.read()
        n = int(np.prod(e["shape"], dtype=np.int64))
        if e["size"] != np.dtype(dtype).itemsize * n:
            raise ValueError(f"{name}: {e['size']} bytes for shape "
                             f"{e['shape']}")
        raw = shards[sid][e["offset"]:e["offset"] + e["size"]]
        if len(raw) != e["size"]:
            raise ValueError(f"{name}: data shard {sid} is truncated")
        arrays[name] = np.frombuffer(raw, dtype).reshape(e["shape"]).copy()
    return arrays


def tf_var_prefix(cfg: Config, param_key: str) -> str:
    """A Wave-U-Net param key -> its TF variable prefix: ``tf.layers``
    auto-names the convs in creation order inside ``separator``
    (down_0..L-1, the bottleneck, up_0..L-1, the output convs; the first is
    unsuffixed), and each learned interpolation is ``interp_i``."""
    L = cfg.num_layers

    def conv(n: int) -> str:
        return "separator/conv1d" if n == 0 else f"separator/conv1d_{n}"

    if param_key.startswith("down_"):
        return conv(int(param_key.split("_")[1]))
    if param_key == "bottleneck":
        return conv(L)
    if param_key.startswith("interp_"):
        return f"separator/interp_{int(param_key.split('_')[1])}"
    if param_key.startswith("up_"):
        return conv(L + 1 + int(param_key.split("_")[1]))
    if param_key.startswith("out_"):
        j = list(cfg.source_names).index(param_key[len("out_"):])
        return conv(2 * L + 1 + j)
    raise KeyError(f"unknown param key {param_key!r}")


def tf_spectro_var_prefix(cfg: Config, key: str) -> str:
    """A spectrogram-net param/state key -> its TF variable prefix. Per
    source s (0-based) with L layers: down conv i -> conv2d_{s*L+i}, down
    BN i -> BatchNorm_{s*(2L-1)+i}, up transpose i ->
    conv2d_transpose_{s*L+i}, up BN i -> BatchNorm_{s*(2L-1)+L+i}, mask ->
    conv2d_transpose_{s*L+L-1} (index 0 unsuffixed)."""
    L = cfg.num_layers
    src, rest = key.split("/", 1)
    s = list(cfg.source_names).index(src)

    def nm(base: str, n: int) -> str:
        return f"separator/{base}" if n == 0 else f"separator/{base}_{n}"

    if rest.startswith("down_"):
        i = int(rest[len("down_"):].split("_")[0])
        if rest.endswith("_bn"):
            return nm("BatchNorm", s * (2 * L - 1) + i)
        return nm("conv2d", s * L + i)
    if rest.startswith("up_"):
        i = int(rest[len("up_"):].split("_")[0])
        if rest.endswith("_bn"):
            return nm("BatchNorm", s * (2 * L - 1) + L + i)
        return nm("conv2d_transpose", s * L + i)
    if rest == "mask":
        return nm("conv2d_transpose", s * L + L - 1)
    raise KeyError(f"unknown spectrogram param key {key!r}")


def _fetch(arrays: Dict[str, np.ndarray], names, like: torch.Tensor,
           dev: torch.device) -> torch.Tensor:
    """The first of ``names`` present in ``arrays``, dtype- and
    shape-checked."""
    for name in names:
        if name in arrays:
            a = arrays[name]
            if np.asarray(a).dtype != np.float32:
                raise ValueError(f"{name}: dtype {np.asarray(a).dtype}; "
                                 f"only DT_FLOAT variables are loaded")
            if tuple(a.shape) != tuple(like.shape):
                raise ValueError(f"{name}: shape {a.shape} != "
                                 f"{tuple(like.shape)}")
            return torch.tensor(np.asarray(a), device=dev)
    raise KeyError(f"missing TF variable {names[0]}")


def load_tf_waveunet(ckpt_path: str, cfg: Config,
                     arrays: Dict[str, np.ndarray] = None,
                     device: DeviceLike = None):
    """A reference Wave-U-Net checkpoint -> the port's params on ``device``
    (the card unless ``"cpu"``)."""
    from waveunet_tpu_torch.models.waveunet import init_waveunet

    if cfg.network != "unet":
        raise NotImplementedError(
            "use load_tf_spectrogram for unet_spectrogram configs")
    dev = resolve_device(device)
    if arrays is None:
        arrays = read_checkpoint(ckpt_path)
    template = init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")
    params = {}
    for key, leaf in template.items():
        prefix = tf_var_prefix(cfg, key)
        if key.startswith("interp_"):
            params[key] = {"weights": _fetch(arrays, [prefix],
                                             leaf["weights"], dev)}
        else:
            params[key] = {"kernel": _fetch(arrays, [prefix + "/kernel"],
                                            leaf["kernel"], dev),
                           "bias": _fetch(arrays, [prefix + "/bias"],
                                          leaf["bias"], dev)}
    return params


def load_tf_spectrogram(ckpt_path: str, cfg: Config,
                        arrays: Dict[str, np.ndarray] = None,
                        device: DeviceLike = None):
    """A spectrogram-U-Net (U7/U7a) checkpoint -> (params, state) on
    ``device`` (the card unless ``"cpu"``)."""
    from waveunet_tpu_torch.models.spectrogram_unet import (
        init_spectrogram_unet)

    dev = resolve_device(device)
    if arrays is None:
        arrays = read_checkpoint(ckpt_path)
    t_params, t_state = init_spectrogram_unet(
        torch.Generator().manual_seed(0), cfg, "cpu")
    params, state = {}, {}
    for key, leaf in t_params.items():
        p = tf_spectro_var_prefix(cfg, key)
        if key.endswith("_bn"):
            params[key] = {"beta": _fetch(arrays, [p + "/beta"],
                                          leaf["beta"], dev)}
        else:
            params[key] = {
                "kernel": _fetch(arrays, [p + "/kernel", p + "/weights"],
                                 leaf["kernel"], dev),
                "bias": _fetch(arrays, [p + "/bias", p + "/biases"],
                               leaf["bias"], dev)}
    for key, leaf in t_state.items():
        p = tf_spectro_var_prefix(cfg, key)
        state[key] = {"mean": _fetch(arrays, [p + "/moving_mean"],
                                     leaf["mean"], dev),
                      "var": _fetch(arrays, [p + "/moving_variance"],
                                    leaf["var"], dev)}
    return params, state

