"""Device-resident training and evaluation data: the banks live on the card.

Counterpart of ``waveunet_tpu/data/device_cache.py`` (``DeviceBank``,
``build_sampler``, ``_assemble_batch``, ``EvalBank``). The sources of every
song sit on the device as one int16 bank, quantised as the JAX package does
(``round(clip(x, -1, 1) * 32767)``), and a training step samples from it
with device ops only, so it needs no host bytes and fits in a CUDA graph:

  * a uniform song, and a uniform start in ``[0, max(valid, 1))`` of it;
  * each (snippet, source) scaled by U(0.7, 1.0) and the mix re-summed when
    augmenting; with augmentation off the stored mixture is a bank row and
    is served as it is (it may differ from a re-sum where it was clipped);
  * the sources centre-cropped to the output window.

The draws are a counter-based hash (splitmix64 on int64 tensors) of
``(key, absolute step, row, purpose)``, so the stream is a pure function of
the step, as ``fold_in(key, step)`` makes the JAX package's: a resumed,
chunked or graphed run draws what an uninterrupted eager one does. Song and
start are integers drawn by modulo from 62-bit draws (never a float
fraction times ``valid``, which quantises on long songs); the numbers are
not ``jax.random``'s.

``EvalBank`` holds every (song, start) window of a partition with hop =
output length, the remainder of the last batch dropped (the host
pipeline's eval batches), with the stored mixture as a row, and sweeps them
through the port's inference forward: the hand-written kernels on the card,
replaying one CUDA graph a batch size there.

Several processes: ``DeviceBank`` and ``EvalBank`` take ``(host_id,
num_hosts)`` and hold the round-robin song subset ``paths[host_id::
num_hosts]``; the ranks combine ``EvalBank.loss_sums`` with
``parallel.distributed.pod_weighted_mean``. ``ShardedBank`` is the
training partition sharded over a mesh: rank r holds ``paths[r::world]``
and samples its rows of the global batch with the rank folded into the
key, as the JAX package's ``shard_map`` sampler does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.data import cache, sampler
from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.ops.kernels import capture

_INT32_MAX = np.iinfo(np.int32).max
_MASK64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    c &= _MASK64
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch shifts arithmetically)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 tensors (products wrap mod 2^64)."""
    x = x + _GOLDEN
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def _mix_int(x: int) -> int:
    """``_mix`` of one Python int, as the int64 with the same bits."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return _i64(x ^ (x >> 31))


def fold_in(key: int, data: int) -> int:
    """A new stream key from ``key`` and ``data`` (a rank)."""
    return _mix_int(_mix_int(key) + data)


def draws(key: int, step, n_rows: int, n_purposes: int,
          device: torch.device) -> torch.Tensor:
    """[n_rows, n_purposes] non-negative 62-bit int64 draws, a pure function
    of (key, step, row, purpose). ``step`` is an int or an int64 0-d tensor
    on ``device`` (a graph's step counter, so that nothing crosses from the
    host while a graph is captured)."""
    step = torch.as_tensor(step, dtype=torch.int64, device=device)
    h = _mix(step + _mix_int(key))
    lane = torch.arange(n_rows * n_purposes, dtype=torch.int64,
                        device=device).view(n_rows, n_purposes)
    return _srl(_mix(h + lane), 2)


def uniform01(d: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the top 24 bits of 62-bit draws."""
    return _srl(d, 38).to(torch.float32) * (1.0 / (1 << 24))


def _assemble_batch(cfg: Config, wins: torch.Tensor,
                    scale: Optional[torch.Tensor], pad: int, output_len: int,
                    do_augment: bool, stored_mix: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """Windows ``[batch, S(+1), input_len, C]`` float32 (the stored mixture
    last iff ``stored_mix``) -> training batch: the sources scaled by
    ``scale`` ``[batch, S, 1, 1]`` and re-summed into the mix when
    augmenting, the stored mixture served otherwise, and the sources
    centre-cropped to the output window."""
    if stored_mix:
        if do_augment:
            raise ValueError("augmentation re-sums the mix; a stored mixture "
                             "row is for augmentation off")
        mix = wins[:, -1]
        wins = wins[:, :-1]
    else:
        if do_augment:
            wins = wins * scale
        mix = torch.sum(wins, dim=1)
    targets = wins[:, :, pad:pad + output_len, :] if pad > 0 else wins
    out = {name: targets[:, i] for i, name in enumerate(cfg.source_names)}
    out["mix"] = mix
    return out


def _bank_row_keys(cfg: Config) -> List[str]:
    """Bank rows: the sources, and the stored mixture when augmentation is
    off (it is then served, not re-synthesised)."""
    return list(cfg.source_names) + ([] if cfg.augmentation else ["mix"])


def _quantise(rows: np.ndarray) -> np.ndarray:
    return np.round(np.clip(rows, -1.0, 1.0) * 32767.0).astype(np.int16)


def _check_int32_addressable(offset: int, what: str) -> None:
    """Keep positions within int32, as the JAX package's banks must, so a
    bank built here is the bank the JAX package would build."""
    if offset > _INT32_MAX:
        raise ValueError(
            f"{what} spans {offset} samples, beyond int32 position "
            f"addressing (2^31-1); lower device_data_max_bytes so the host "
            f"pipeline takes over")


def _windows(bank: torch.Tensor, pos: torch.Tensor,
             input_len: int) -> torch.Tensor:
    """[batch, rows, input_len, C] windows of a [rows, total, C] bank at
    the starts ``pos`` (int64, on the bank's device)."""
    idx = pos[:, None] + torch.arange(input_len, device=bank.device)
    return bank[:, idx].permute(1, 0, 2, 3)


def positions(d: torch.Tensor, starts: torch.Tensor, valids: torch.Tensor):
    """(song, start in the bank) of each row of draws ``d``: the song
    uniform, the start uniform in ``[0, max(valid, 1))`` of that song."""
    song = d[:, 0] % starts.shape[0]
    return song, starts[song] + d[:, 1] % torch.clamp(valids[song], min=1)


def build_sampler(cfg: Config, input_len: int, output_len: int, batch: int,
                  augment: Optional[bool] = None, stored_mix: bool = False):
    """``sample(bank, starts, valids, key, step) -> batch dict``, device ops
    only. Draw lanes of each row: 0 the song, 1 the start, 2.. the sources'
    scales."""
    S = cfg.num_sources
    pad = (input_len - output_len) // 2
    do_augment = cfg.augmentation if augment is None else augment

    def sample(bank, starts, valids, key: int, step):
        d = draws(key, step, batch, 2 + S, bank.device)
        _, pos = positions(d, starts, valids)
        # a true division, as the JAX package's bank does: a CUDA kernel
        # multiplies by the reciprocal of a host scalar divisor instead
        full_scale = torch.full((), 32767.0, device=bank.device)
        wins = _windows(bank, pos, input_len).to(torch.float32) / full_scale
        scale = None
        if do_augment and not stored_mix:
            u = uniform01(d[:, 2:2 + S])
            scale = (u * (1.0 - 0.7) + 0.7).view(batch, S, 1, 1)
        return _assemble_batch(cfg, wins, scale, pad, output_len, do_augment,
                               stored_mix=stored_mix)

    return sample


def _load_rows(paths: List, keys: List[str], input_len: int,
               load_song: Callable = cache.load_song):
    """(rows of each usable song, lengths, corrupt count): songs shorter
    than the input window are left out, corrupt shards skipped."""
    rows, lengths, n_corrupt = [], [], 0
    for p in paths:
        try:
            tracks = load_song(p)
        except ValueError as e:  # a rotted shard: skip it as the pipeline does
            print(f"WARNING: {e}; skipping")
            n_corrupt += 1
            continue
        length = tracks["mix"].shape[0]
        if length < input_len:
            continue
        rows.append(np.stack([tracks[k] for k in keys]))  # [rows, n, C]
        lengths.append(length)
    return rows, lengths, n_corrupt


class DeviceBank:
    """The training partition as one int16 bank on the device, with its
    song table, and the sampler over it; with ``(host_id, num_hosts)``,
    only this host's round-robin song subset."""

    def __init__(self, cfg: Config, partition: str, input_len: int,
                 output_len: int, max_songs: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 max_bytes: Optional[int] = None, device: DeviceLike = None,
                 host_id: int = 0, num_hosts: int = 1):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.input_len = input_len
        self.output_len = output_len
        self.pad = (input_len - output_len) // 2
        paths = cache.list_songs(cfg, partition)
        if max_songs is not None:
            paths = paths[:max_songs]
        if not paths:
            raise FileNotFoundError(f"no cached songs for {partition!r}")
        paths = paths[host_id::num_hosts]
        if not paths:
            raise ValueError(
                f"host {host_id}/{num_hosts} got an empty song slice")
        row_keys = _bank_row_keys(cfg)
        self._stored_mix = row_keys[-1] == "mix"
        rows, lengths, n_corrupt = _load_rows(paths, row_keys, input_len)
        if not rows:
            raise ValueError("no song long enough for the input window")
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        _check_int32_addressable(int(offsets[-1]), "device bank")
        n_short = len(paths) - len(rows) - n_corrupt
        if n_short:
            print(f"WARNING: device bank dropped {n_short} of {len(paths)} "
                  f"songs shorter than the {input_len}-sample network input")
        bank = _quantise(np.concatenate(rows, axis=1))  # [rows, total, C]
        if max_bytes is not None and bank.nbytes > max_bytes:
            raise ValueError(
                f"device bank {bank.nbytes / 1e9:.1f} GB exceeds the "
                f"{max_bytes / 1e9:.1f} GB device budget")
        self.n_songs = len(rows)
        self._bank = torch.from_numpy(bank).to(self.device)
        self._starts = torch.as_tensor(offsets[:-1], dtype=torch.int64,
                                       device=self.device)
        self._valids = torch.as_tensor(np.asarray(lengths) - input_len,
                                       dtype=torch.int64, device=self.device)
        self.set_batch(batch_size or cfg.batch_size)

    def set_batch(self, batch: int) -> None:
        """Re-point the sampler at a new batch size; the bank stays where it
        is (the fine-tune round doubles the batch)."""
        self.batch = batch
        self._sampler = build_sampler(self.cfg, self.input_len,
                                      self.output_len, batch,
                                      stored_mix=self._stored_mix)

    def nbytes(self) -> int:
        return self._bank.numel() * self._bank.element_size()

    @property
    def arrays(self):
        """(bank, starts, valids): the sampler's inputs."""
        return self._bank, self._starts, self._valids

    def sample(self, key: int, step) -> Dict[str, torch.Tensor]:
        """The batch of absolute step ``step`` (int or int64 device 0-d
        tensor) of the stream ``key``."""
        return self._sampler(self._bank, self._starts, self._valids, key, step)

    def batches(self, key: Optional[int] = None, start: int = 0):
        """Endless batches from absolute step ``start``: the fused epoch's
        stream, step for step."""
        key = self.cfg.seed if key is None else key
        i = start
        while True:
            yield self.sample(key, i)
            i += 1


class ShardedBank(DeviceBank):
    """The training partition sharded over a mesh's ranks: rank r holds the
    round-robin song subset ``paths[r::world]`` on its own card and samples
    its ``batch // world`` rows of each global batch, with the rank folded
    into the stream key, so the global batch mixes the whole dataset every
    step. ``batches`` and a fused epoch over ``sample`` see the same stream.

    Construction is collective (call it on every rank): one ``all_reduce``
    agrees the largest shard (each rank's bank is zero-padded to it, as the
    JAX package's global array is; no position reaches the padding) and
    the smallest song count, so a rank without a usable song makes every
    rank raise the same ``ValueError``."""

    def __init__(self, cfg: Config, partition: str, input_len: int,
                 output_len: int, mesh, batch_size: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        paths = cache.list_songs(cfg, partition)
        if not paths:
            raise FileNotFoundError(f"no cached songs for {partition!r}")
        self._build(cfg, input_len, output_len, mesh, paths, cache.load_song,
                    partition, batch_size, max_bytes)

    @classmethod
    def from_tracks(cls, cfg: Config, input_len: int, output_len: int, mesh,
                    tracks_list, batch_size: Optional[int] = None):
        """From in-memory songs (source name -> [n, C] float array, one dict
        a song) instead of the disk cache, through the same shard layout."""
        self = cls.__new__(cls)
        self._build(cfg, input_len, output_len, mesh,
                    list(range(len(tracks_list))), lambda i: tracks_list[i],
                    "<in-memory>", batch_size, None)
        return self

    def _build(self, cfg, input_len, output_len, mesh, paths, load_song,
               partition, batch_size, max_bytes):
        from waveunet_tpu_torch.parallel.mesh import all_reduce_, check_mesh

        self.mesh = check_mesh(mesh)
        self.device = mesh.device
        self.cfg = cfg
        self.input_len = input_len
        self.output_len = output_len
        self.pad = (input_len - output_len) // 2
        row_keys = _bank_row_keys(cfg)
        self._stored_mix = row_keys[-1] == "mix"
        rows, lengths, _ = _load_rows(paths[mesh.rank::mesh.size], row_keys,
                                      input_len, load_song)
        # (max length, -min songs) in one MAX all-reduce; the song tables
        # need no padding, since each rank samples only its own
        agreed = torch.tensor([sum(lengths), -len(rows)], dtype=torch.int64,
                              device=mesh.collective_device)
        max_len, min_songs = all_reduce_(agreed, mesh, "max").tolist()
        min_songs = -min_songs
        if min_songs == 0:
            raise ValueError(
                f"sharded bank needs >= 1 usable song per device "
                f"({mesh.size} devices, {len(paths)} songs in {partition!r})")
        _check_int32_addressable(max_len, "sharded bank device shard")
        shard_bytes = len(row_keys) * max_len * cfg.num_channels * 2
        if max_bytes is not None and shard_bytes > max_bytes:
            raise ValueError(
                f"per-device bank shard {shard_bytes / 1e9:.1f} GB exceeds "
                f"the {max_bytes / 1e9:.1f} GB device budget")
        bank = _quantise(np.concatenate(rows, axis=1))
        bank = np.pad(bank, [(0, 0), (0, max_len - bank.shape[1]), (0, 0)])
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        self.n_songs = self.local_songs = len(rows)
        self.n_local_devices = 1
        self._bank = torch.from_numpy(bank).to(self.device)
        self._starts = torch.as_tensor(offsets[:-1], dtype=torch.int64,
                                       device=self.device)
        self._valids = torch.as_tensor(np.asarray(lengths) - input_len,
                                       dtype=torch.int64, device=self.device)
        self.set_batch(batch_size or cfg.batch_size)

    def set_batch(self, batch: int) -> None:
        """Re-point the sampler at a new GLOBAL batch size (the fine-tune
        round doubles it); the shard stays where it is."""
        if batch % self.mesh.size:
            raise ValueError(f"global batch {batch} not divisible by "
                             f"{self.mesh.size} mesh devices")
        self.batch = batch
        self._sampler = build_sampler(self.cfg, self.input_len,
                                      self.output_len,
                                      batch // self.mesh.size,
                                      stored_mix=self._stored_mix)

    def sample(self, key: int, step) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch of absolute step ``step``
        of the stream ``key``."""
        return self._sampler(self._bank, self._starts, self._valids,
                             fold_in(key, self.mesh.rank), step)


class EvalBank:
    """A partition's deterministic evaluation windows on the device.

    ``dtype`` "int16" quantises like the training bank; "float32" keeps the
    cache's values. ``set_batch`` re-chunks the window list (drop remainder)
    without uploading again. With ``(host_id, num_hosts)`` it holds this
    host's round-robin song subset, which may be empty when there are
    several hosts (a shard of weight 0 in ``loss_sums``)."""

    def __init__(self, cfg: Config, partition: str, input_len: int,
                 output_len: int, batch_size: Optional[int] = None,
                 max_bytes: Optional[int] = None, dtype: str = "int16",
                 device: DeviceLike = None, host_id: int = 0,
                 num_hosts: int = 1):
        if dtype not in ("int16", "float32"):
            raise ValueError(f"dtype {dtype!r}: use 'int16' or 'float32'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.input_len = input_len
        self.output_len = output_len
        self.pad = (input_len - output_len) // 2
        self._dtype = dtype
        paths = cache.list_songs(cfg, partition)
        if not paths:
            raise FileNotFoundError(f"no cached songs for {partition!r}")
        keys = list(cfg.source_names) + ["mix"]
        self._graphs: Dict = {}
        rows, lengths, _ = _load_rows(paths[host_id::num_hosts], keys,
                                      input_len)
        if not rows and num_hosts > 1:
            self._bank = None
            self._positions = np.zeros((0,), np.int64)
            self.n_windows = 0
            self.set_batch(batch_size or cfg.batch_size)
            return
        if not rows:
            raise ValueError("no song long enough for the input window")
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        _check_int32_addressable(int(offsets[-1]), "eval bank")
        bank = np.concatenate(rows, axis=1)
        bank = _quantise(bank) if dtype == "int16" else bank.astype(np.float32)
        if max_bytes is not None and bank.nbytes > max_bytes:
            raise ValueError(
                f"eval bank {bank.nbytes / 1e9:.1f} GB exceeds the "
                f"{max_bytes / 1e9:.1f} GB device budget")
        self._bank = torch.from_numpy(bank).to(self.device)
        self._positions = np.concatenate([
            sampler.sequential_snippet_positions(n, input_len, output_len) + o
            for n, o in zip(lengths, offsets)]).astype(np.int64)
        self.n_windows = int(self._positions.shape[0])
        self.set_batch(batch_size or cfg.batch_size)

    def set_batch(self, batch: int) -> None:
        # a captured sweep gathers through the old index buffer
        self._graphs.clear()
        self.batch = batch
        self.n_batches = self.n_windows // batch
        self._pos_dev = torch.as_tensor(
            self._positions[:self.n_batches * batch], device=self.device)

    def nbytes(self) -> int:
        if self._bank is None:
            return 0
        return self._bank.numel() * self._bank.element_size()

    @property
    def positions(self) -> np.ndarray:
        """The window starts in bank coordinates, in sweep order."""
        return self._positions

    def batch_at(self, i) -> Dict[str, torch.Tensor]:
        """Eval batch ``i`` (int or int64 device 0-d tensor): the sources
        cropped to the output window and the stored mixture."""
        i = torch.as_tensor(i, dtype=torch.int64, device=self.device)
        pos = self._pos_dev[i * self.batch
                            + torch.arange(self.batch, device=self.device)]
        wins = _windows(self._bank, pos, self.input_len)
        if self._dtype == "int16":
            wins = wins.to(torch.float32) * (1.0 / 32767.0)
        names = self.cfg.source_names
        pad, out_len = self.pad, self.output_len
        b = {name: (wins[:, j, pad:pad + out_len] if pad > 0 else wins[:, j])
             for j, name in enumerate(names)}
        b["mix"] = wins[:, len(names)]
        return b

    def batch_losses(self, params, model_state,
                     graphed: Optional[bool] = None) -> np.ndarray:
        """The loss of every batch, fetched once. ``graphed`` (default: on a
        CUDA device) captures one batch's gather, forward and loss as a CUDA
        graph per (batch size, parameter tensors) and replays it; a replay
        adds the kernel launches its capture recorded."""
        from waveunet_tpu_torch.train.step import make_eval_step

        if self.n_batches == 0:
            return np.zeros((0,), np.float32)
        eval_step = make_eval_step(self.cfg, device=self.device)
        if graphed is None:
            graphed = self.device.type == "cuda"
        if not graphed:
            return torch.stack([eval_step(params, model_state,
                                          self.batch_at(i))
                                for i in range(self.n_batches)]).cpu().numpy()
        g = self._graph(eval_step, params, model_state)
        g.inputs[0].zero_()
        for _ in range(self.n_batches):
            g.replay()
        return g.outputs[:self.n_batches].cpu().numpy()

    def _graph(self, eval_step, params, model_state):
        tensors = [t for tree in (params, model_state)
                   for leaves in tree.values() for t in leaves.values()]
        key = (self.batch, tuple(t.data_ptr() for t in tensors))
        if key not in self._graphs:
            self._graphs.clear()  # one graph at a time: each holds a pool
            idx = torch.zeros((), dtype=torch.int64, device=self.device)
            losses = torch.zeros((max(self.n_batches, 1),),
                                 device=self.device)

            def body(i, out):
                loss = eval_step(params, model_state, self.batch_at(i))
                out.index_copy_(0, i.view(1), loss.view(1))
                i.add_(1)
                return out

            self._graphs[key] = capture(body, (idx, losses))
        return self._graphs[key]

    def evaluate(self, params, model_state,
                 graphed: Optional[bool] = None) -> float:
        """Running mean of the batch losses, accumulated as the JAX
        package's ``evaluate`` does; inf when no full batch exists."""
        if self.n_batches == 0:
            print("WARNING: evaluation produced no batches; returning inf")
            return float("inf")
        total, n = 0.0, 0
        for loss in self.batch_losses(params, model_state, graphed):
            n += 1
            total += (float(loss) - total) / n
        return total

    def loss_sums(self, params, model_state,
                  graphed: Optional[bool] = None):
        """(sum of the batch losses in float64, batch count): this shard's
        share of a validation mean over several hosts, combined with
        ``parallel.distributed.pod_weighted_mean``; (0.0, 0) for a shard
        without a full batch."""
        if self.n_batches == 0:
            return 0.0, 0
        losses = self.batch_losses(params, model_state, graphed)
        return float(np.sum(losses, dtype=np.float64)), int(losses.shape[0])
