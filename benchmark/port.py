"""The one place the harness reaches into the program under test.

The benchmark takes from ``waveunet_tpu_torch`` the system under test
(``Separator``, the fused training epoch over a ``DeviceBank``) and its
kernel launch counters. Everything else (inputs, reference, arithmetic,
trace reduction) is the benchmark's own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping


def config(arch: Mapping, **changes):
    """The port's ``Config`` for a configuration file's keys."""
    from waveunet_tpu_torch.config import Config, get_config
    fields = {f.name for f in dataclasses.fields(Config) if f.init}
    keys = {k: v for k, v in arch.items() if k in fields}
    keys.update(changes)
    return get_config(arch["preset"], **keys)


def launch_counts() -> Dict[str, int]:
    from waveunet_tpu_torch.ops.kernels import launch_counts as counts
    return counts()


def separator(arch: Mapping, params, state, device, max_song_s: float):
    """``Separator.separate`` of the model ``params`` with ``state``, its
    CUDA graphs captured for songs of up to ``max_song_s`` seconds."""
    from waveunet_tpu_torch.infer.engine import Separator
    sep = Separator(config(arch), params, model_state=state, device=device)
    if device.type == "cuda":
        sep.precompile(max_song_s=max_song_s)
    return sep.separate


def fused_epoch(arch: Mapping, data_path: str, batch: int, device):
    """(bank, epoch): the training partition under ``data_path`` as a
    ``DeviceBank``, and ``make_scanned_epoch`` over its sampler, one step a
    call."""
    from waveunet_tpu_torch.data.device_cache import DeviceBank
    from waveunet_tpu_torch.train.step import make_scanned_epoch
    cfg = config(arch, data_path=data_path, batch_size=batch)
    in_len, out_len = _io(cfg)
    bank = DeviceBank(cfg, "train", in_len, out_len, batch_size=batch,
                      device=device)
    epoch = make_scanned_epoch(cfg, cfg.init_sup_sep_lr, 1, bank.sample,
                               chunk=1, device=device)
    return bank, epoch


def adam_state(arch: Mapping, params):
    """Zero Adam state for ``params``, as the trainer starts it."""
    from waveunet_tpu_torch.train.step import make_optimizer
    return make_optimizer(arch["init_sup_sep_lr"]).init(params)


def song_dir(arch: Mapping, data_path: str) -> str:
    """Where the training partition's songs are written."""
    from waveunet_tpu_torch.data.cache import partition_dir
    return partition_dir(config(arch, data_path=data_path), "train")


def write_song(path: str, tracks) -> None:
    from waveunet_tpu_torch.data.cache import write_song as write
    write(path, tracks)


def _io(cfg):
    from waveunet_tpu_torch.ops.shapes import get_padding
    return get_padding(cfg, cfg.num_frames)
