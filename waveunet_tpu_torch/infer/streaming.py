"""Streaming separation: push audio chunks, pull separated stems.

Counterpart of ``waveunet_tpu/infer/streaming.py``. The same context-padded
windowed inference as the offline engine, run incrementally:

  * the analysis context lives in a device ring buffer: each pushed sample
    crosses to the device once, in pieces bucketed to powers of two;
  * whenever full windows are available, up to ``batch_windows`` of them
    (a power of two) are framed at static offsets of the ring and swept
    through one batched forward, and the ring rolls forward by as many
    output hops;
  * outputs cross back as int16 when ``cfg.infer_wire_dtype == "int16"``,
    with the offline engine's non-finite sentinel;
  * every drain of a push is enqueued, each with its copy back into pinned
    host memory, before any result is read;
  * ``flush()`` zero-pads the tail to emit the rest (the only place the
    stream can differ from offline separation, which right-aligns its last
    window into real signal).

Both families stream: the Wave-U-Net and the spectrogram U-Net, whose
windows tile with zero context pad. Algorithmic latency = out_len + pad.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.infer.engine import model_forward, tree_to
from waveunet_tpu_torch.infer.wire import from_wire_np, to_wire
from waveunet_tpu_torch.ops import shapes
from waveunet_tpu_torch.ops.shapes import pow2_ceil


class StreamingSeparator:
    def __init__(self, cfg: Config, params, batch_windows: int = 1,
                 model_state=None, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        frames = cfg.infer_num_frames or cfg.num_frames
        if frames == -1:
            # The offline engine's auto window tunes for throughput; a
            # stream's contract is latency, which grows with in_len: keep
            # the training window unless infer_num_frames is set.
            frames = cfg.num_frames
        self.in_len, self.out_len = shapes.get_padding(cfg, frames)
        self.pad = (self.in_len - self.out_len) // 2
        self.batch = max(1, batch_windows)
        self.params = tree_to(params, self.device)
        self._wire16 = cfg.infer_wire_dtype == "int16"
        self._forward = model_forward(cfg, tree_to(model_state or {},
                                                   self.device), self.out_len)
        # After a full drain fewer than in_len rows are valid; one appended
        # bucket (<= 2 x the largest piece) plus flush slack must fit.
        self._max_piece = self.batch * self.out_len
        self._cap = (self.in_len + 2 * pow2_ceil(self._max_piece)
                     + 2 * self.out_len)
        self.reset()

    def reset(self):
        # leading context zeros, as the offline engine's left pad
        self._buf = torch.zeros((self._cap, self.cfg.num_channels),
                                dtype=torch.float32, device=self.device)
        self._valid = self.pad   # rows of the ring that hold real signal
        self._emitted = 0        # output samples produced so far
        self._pushed = 0         # input samples received so far

    @property
    def latency_samples(self) -> int:
        """A sample is emitted once the window covering it and its right
        context have arrived."""
        return self.out_len + self.pad

    def _append(self, piece: np.ndarray, n_real: int) -> None:
        """Write a bucket of rows at the ring's end; ``n_real`` of them
        are signal, the rest zeros that later appends overwrite."""
        chunk = torch.from_numpy(np.ascontiguousarray(piece, np.float32))
        self._buf[self._valid:self._valid + chunk.shape[0]].copy_(
            chunk.to(self.device, non_blocking=True))
        self._valid += n_real

    def _drain_k(self, k: int) -> Dict[str, torch.Tensor]:
        """Frame k windows at the ring's static offsets, run them, and roll
        the ring forward by k output hops."""
        wins = torch.stack([self._buf[i * self.out_len:
                                      i * self.out_len + self.in_len]
                            for i in range(k)])
        out = self._forward(self.params, wins)
        if self._wire16:
            out = {s: to_wire(v) for s, v in out.items()}
        # the rows past ``valid`` are dead until an append overwrites them
        self._buf = torch.roll(self._buf, -k * self.out_len, dims=0)
        self._valid -= k * self.out_len
        return out

    def push(self, chunk: np.ndarray) -> Dict[str, np.ndarray]:
        """Feed (n, ch) samples at the model rate; returns the newly
        separated audio per source ((0, ch) arrays when none is ready)."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim == 1:
            chunk = chunk[:, None]
        if chunk.shape[1] != self.cfg.num_channels:
            raise ValueError(f"expected {self.cfg.num_channels} channels, "
                             f"got {chunk.shape[1]}")
        self._pushed += chunk.shape[0]
        outs: Dict[str, List[np.ndarray]] = {s: []
                                             for s in self.cfg.source_names}
        off = 0
        while off < chunk.shape[0]:
            piece = chunk[off:off + self._max_piece]
            off += piece.shape[0]
            n_real = piece.shape[0]
            bucket = pow2_ceil(n_real)
            if n_real < bucket:
                piece = np.pad(piece, [(0, bucket - n_real), (0, 0)])
            if self._valid + bucket > self._cap:
                self._drain_into(outs, target=None)
            if self._valid + bucket > self._cap:
                raise RuntimeError("streaming ring overflow")
            self._append(piece, n_real)
            self._drain_into(outs, target=None)
        return self._collect(outs)

    def flush(self) -> Dict[str, np.ndarray]:
        """Zero-pad the tail and emit everything up to the stream's end."""
        remaining = self._pushed - self._emitted
        if remaining <= 0:
            return self._empty()
        n_win = -(-remaining // self.out_len)
        need = (n_win - 1) * self.out_len + self.in_len - self._valid
        outs: Dict[str, List[np.ndarray]] = {s: []
                                             for s in self.cfg.source_names}
        while need > 0:
            z = min(need, self._max_piece)
            bucket = pow2_ceil(z)
            if self._valid + bucket > self._cap:
                self._drain_into(outs, target=self._pushed)
            self._append(np.zeros((bucket, self.cfg.num_channels),
                                  np.float32), z)
            need -= z
        self._drain_into(outs, target=self._pushed)
        return self._collect(outs)

    def _drain_into(self, outs, target) -> None:
        """Enqueue every drain that the ring (or ``target``) allows, each
        with its copy back, then read them in order."""
        planned = self._emitted
        pending: List[Tuple[int, Dict[str, torch.Tensor], object]] = []
        cuda = self.device.type == "cuda"
        while target is None or planned < target:
            avail = 0
            if self._valid >= self.in_len:
                avail = (self._valid - self.in_len) // self.out_len + 1
            if target is not None:
                avail = min(avail, -(-(target - planned) // self.out_len))
            if avail <= 0:
                break
            k = min(avail, self.batch)
            k = 1 << (k.bit_length() - 1)  # pow2 bucket <= k available
            res = self._drain_k(k)
            planned += k * self.out_len
            host = {}
            for s, v in res.items():
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=cuda)
                host[s] = h.copy_(v, non_blocking=True)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            pending.append((k, host, event))
        for k, host, event in pending:
            if event is not None:
                event.synchronize()
            for i in range(k):
                take = self.out_len
                if target is not None:
                    take = min(take, target - self._emitted)
                if take <= 0:
                    break
                for s in self.cfg.source_names:
                    v = host[s][i, :take].numpy()
                    outs[s].append(from_wire_np(v) if self._wire16
                                   else v.copy())
                self._emitted += take

    def _empty(self) -> Dict[str, np.ndarray]:
        return {s: np.zeros((0, self.cfg.num_channels), np.float32)
                for s in self.cfg.source_names}

    def _collect(self, outs) -> Dict[str, np.ndarray]:
        if not outs[self.cfg.source_names[0]]:
            return self._empty()
        return {s: np.concatenate(v) for s, v in outs.items()}
