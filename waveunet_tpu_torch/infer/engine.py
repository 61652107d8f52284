"""Batched sliding-window separation engine, in PyTorch.

Counterpart of ``waveunet_tpu/infer/engine.py`` with the same semantics step
by step: mono downmix or channel tiling, resampling to the model rate, zero
padding of songs shorter than one network input, context padding, windows at
hop = output length with the last one right-aligned, stitching in window
order (later writes win), and reconstruction of the difference source.

The host pipeline of ``separate``:

  * the context-padded song is written once into a pinned host staging
    buffer (quantised there on the int16 wire, bit for bit as the JAX
    package's native host op) and crosses to the device with non-blocking
    copies: whole ("song" mode) or one slab per chunk on a side copy stream
    ("slabs" mode, so a chunk's copy overlaps the previous chunk's forward);
  * windows are framed on the device by one gather from a device tensor of
    window starts, so a chunk's program has no host-side values in it;
  * windows sweep through the forward in chunks of ``infer_batch`` with a
    power-of-two split tail; each chunk's outputs are copied back to pinned
    host buffers on the compute stream right after its forward, and the host
    stitches a chunk once its event has completed, while the device runs
    the next ones;
  * ``precompile`` captures the chunk forward of every power-of-two chunk
    size in both modes as CUDA graphs (static input and position buffers,
    one shared memory pool); ``separate`` replays a graph wherever one fits
    and runs eagerly otherwise.

``resident_sweep`` runs the whole engine on a device-resident song (framing,
every chunk, the wire round trip, a device stitch, the difference source)
and returns a scalar checksum: the bench's headline path, captured as one
CUDA graph per song length on the card.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.infer.wire import (INT16_NONFINITE, dequantize,
                                           from_wire, from_wire_np,
                                           full_scale, quantize_int16,
                                           to_wire)
from waveunet_tpu_torch.ops import shapes
from waveunet_tpu_torch.ops.kernels import Graph, capture
from waveunet_tpu_torch.ops.resample import resample

__all__ = ["INT16_NONFINITE", "Separator", "separate_file",
           "window_positions"]

Tensors = Dict[str, torch.Tensor]
Forward = Callable[[Mapping, torch.Tensor], Tensors]


def window_positions(n_total: int, out_len: int) -> np.ndarray:
    """Window starts: hop = out_len, the last window right-aligned."""
    pos = np.arange(0, n_total, out_len, dtype=np.int64)
    return np.minimum(pos, n_total - out_len)


def tree_to(tree: Mapping, device: torch.device) -> Dict:
    """A {layer: {leaf: tensor}} dict as contiguous float32 on ``device``."""
    return {layer: {n: t.to(device, torch.float32).contiguous()
                    for n, t in leaves.items()}
            for layer, leaves in tree.items()}


def model_forward(cfg: Config, model_state: Mapping, out_len: int,
                  drop: Optional[str] = None) -> Forward:
    """The default ``forward_fn`` of ``cfg``'s family: the Wave-U-Net at
    inference (without the ``drop`` source), or the spectrogram U-Net with
    its batch-norm statistics ``model_state``, whose iSTFT must give exactly
    ``out_len`` samples a window."""
    if cfg.network == "unet":
        from waveunet_tpu_torch.models.waveunet import apply_waveunet

        def forward(p, x):
            out = apply_waveunet(p, cfg, x, training=False)
            out.pop(drop, None)
            return out
        return forward

    from waveunet_tpu_torch.models.spectrogram_unet import (
        apply_spectrogram_unet)

    def forward(p, x):
        out, _ = apply_spectrogram_unet(p, cfg, x, training=False,
                                        state=model_state)
        # get_padding checks the window carries no framing slack, so the
        # iSTFT's hop*(F-1)+frame_len samples must be the stitch hop
        # exactly (zeros here would stitch silence into the song)
        short = out_len - out[cfg.source_names[0]].shape[1]
        if short != 0:
            raise ValueError(
                f"spectrogram window/iSTFT length mismatch ({short} samples "
                f"of framing slack escaped get_padding validation)")
        return out
    return forward


class Separator:
    """Separation engine for one (config, params) pair on one device.

    ``forward_fn(params, mix_batch) -> {source: batch}`` defaults to the
    Wave-U-Net forward at inference, or to the spectrogram U-Net's with
    ``model_state`` (its batch-norm statistics) for ``unet_spectrogram``.
    ``h2d_mode`` is "song", "slabs" or None (slabs when a song takes two or
    more chunks and the slabs' context overlap adds at most a third)."""

    def __init__(self, cfg: Config, params, model_state=None,
                 forward_fn: Optional[Forward] = None,
                 h2d_mode: Optional[str] = None, device: DeviceLike = None):
        if h2d_mode not in (None, "song", "slabs"):
            raise ValueError(f"h2d_mode {h2d_mode!r}: use 'song', 'slabs' "
                             f"or None")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.model_state = tree_to(model_state or {}, self.device)
        frames = cfg.infer_num_frames or cfg.num_frames
        if frames == -1:  # auto: smallest pow2 window with <= 3x overlap
            frames = shapes.auto_infer_frames(cfg)
        self.in_len, self.out_len = shapes.get_padding(cfg, frames)
        self.pad = (self.in_len - self.out_len) // 2
        self.batch = max(1, cfg.infer_batch)
        self._h2d_mode = h2d_mode
        self._wire16 = cfg.infer_wire_dtype == "int16"
        self._wire_dtype = torch.int16 if self._wire16 else torch.float32
        # The difference source is clip(mix - sum(others)), rebuilt from the
        # stitched sources instead of computed and copied back; only for
        # the default Wave-U-Net forward.
        self._host_reconstruct_last = (
            forward_fn is None and cfg.network == "unet"
            and cfg.output_type == "difference")
        self._forward_fn = forward_fn or model_forward(
            cfg, self.model_state, self.out_len,
            drop=cfg.source_names[-1] if self._host_reconstruct_last
            else None)
        self._arange_in = torch.arange(self.in_len, device=self.device)
        full_scale(self._arange_in.device)  # before any capture divides by it
        self._graphs: Dict[Tuple[str, int], Graph] = {}
        self._static_song: Optional[torch.Tensor] = None
        self._host_bufs: Dict[str, torch.Tensor] = {}
        self._copy_stream = None

    # -- the chunk program ---------------------------------------------------
    def _frame(self, song: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The float32 network input: ``len(pos)`` windows of the device
        song (or slab) at the device positions ``pos``."""
        wins = song[pos[:, None] + self._arange_in]  # [k, in_len, C]
        return dequantize(wins) if wins.dtype == torch.int16 else wins

    def _chunk_fwd(self, params, song: torch.Tensor,
                   pos: torch.Tensor) -> Tensors:
        """Frame ``len(pos)`` windows from the device song (or slab) at the
        device positions ``pos``, run them, and quantise for the wire."""
        out = self._forward_fn(params, self._frame(song, pos))
        if self._wire16:
            out = {k: to_wire(v) for k, v in out.items()}
        return out

    def _run_chunk(self, mode: str, inp: torch.Tensor,
                   pos: torch.Tensor) -> Tensors:
        """One chunk: its graph's replay where ``precompile`` captured one
        that fits, the eager program otherwise. A graph's outputs are
        static: copy them out before the next replay."""
        g = self._graphs.get((mode, int(pos.shape[0])))
        if g is None or (mode == "song" and inp is not self._static_song):
            return self._chunk_fwd(self.params, inp, pos)
        static_in, static_pos = g.inputs
        if static_in is not inp:
            static_in.copy_(inp)
        static_pos.copy_(pos)
        return g.replay()

    def _chunk_sizes(self, n_win: int) -> List[int]:
        """Full batches, then a power-of-two tail: one chunk, or two when
        that pads fewer slots (11 windows at batch 16 -> 8 + 4, not 16)."""
        bs = self.batch
        sizes = [bs] * (n_win // bs)
        rem = n_win % bs
        if rem:
            single = min(shapes.pow2_ceil(rem), bs)
            lo = 1 << (rem.bit_length() - 1)  # largest pow2 <= rem
            if rem > lo and lo + shapes.pow2_ceil(rem - lo) < single:
                sizes += [lo, shapes.pow2_ceil(rem - lo)]
            else:
                sizes.append(single)
        return sizes

    def _pow2_sizes(self) -> List[int]:
        """Every chunk size ``_chunk_sizes`` can give, largest first."""
        ks, k = [self.batch], 1
        while k < self.batch:
            ks.append(k)
            k *= 2
        return sorted(set(ks), reverse=True)

    # -- CUDA graphs -----------------------------------------------------------
    def precompile(self, max_song_s: float = 6 * 60.0,
                   progress: Optional[Callable[[str], None]] = None) -> int:
        """Capture the chunk forward of every power-of-two chunk size up to
        ``infer_batch``, in both H2D modes, as CUDA graphs; returns how many.

        Song-mode graphs read one static song buffer that holds songs of up
        to ``max_song_s`` seconds (longer songs run eagerly); slab-mode
        graphs each read a static slab of their size. All share one memory
        pool, the largest captured first. ``progress`` receives one line
        per graph."""
        if self.device.type != "cuda":
            raise RuntimeError("precompile captures CUDA graphs; this "
                               "Separator runs on the CPU")
        C = self.cfg.num_channels
        cap = max(int(max_song_s * self.cfg.expected_sr) + 2 * self.pad,
                  self.in_len)
        self._graphs = {}
        self._static_song = torch.zeros((cap, C), dtype=self._wire_dtype,
                                        device=self.device)
        pool = torch.cuda.graph_pool_handle()
        ks = self._pow2_sizes()
        total = 2 * len(ks)
        for k in ks:
            for mode in ("song", "slabs"):
                t0 = time.perf_counter()
                inp = (self._static_song if mode == "song" else torch.zeros(
                    ((k - 1) * self.out_len + self.in_len, C),
                    dtype=self._wire_dtype, device=self.device))
                pos = torch.zeros((k,), dtype=torch.int64, device=self.device)
                self._graphs[(mode, k)] = capture(
                    lambda s, p: self._chunk_fwd(self.params, s, p),
                    (inp, pos), pool)
                if progress is not None:
                    progress(f"  [{len(self._graphs)}/{total}] {mode} k={k}: "
                             f"{time.perf_counter() - t0:.1f}s")
        return len(self._graphs)

    # -- the device-resident sweep --------------------------------------------
    def resident_chunk_sizes(self, n_win: int) -> List[int]:
        """The chunk schedule ``resident_sweep`` runs: one exact chunk for a
        song below one batch, the pow2 split tail otherwise."""
        if n_win < self.batch:
            return [n_win]
        return self._chunk_sizes(n_win)

    def resident_sweep(self, n_total: int,
                       chunk_sizes: Optional[Sequence[int]] = None,
                       graphed: Optional[bool] = None):
        """The whole engine on a device-resident padded song of
        ``n_total + 2 * pad`` frames (wire dtype): framing on the device,
        every chunk through the forward, the wire round trip (the int16
        sentinel back to NaN), a device stitch in window order (later
        writes win), and the difference source rebuilt from the device mix.

        Returns ``(fn, positions)``; ``fn(params, song) -> (sources,
        checksum)`` with ``sources`` stitched ``[n_total, C]`` float32
        tensors on the device and ``checksum`` a scalar tensor, so a caller
        syncs on one scalar and no bulk data leaves the device.

        ``graphed`` (default: on a CUDA device) captures ``fn`` as one CUDA
        graph on its first call, for its song length and the params of that
        call; each call then replays it, and its outputs are overwritten by
        the next call."""
        if n_total < self.out_len:
            raise ValueError(f"song shorter than one output window "
                             f"({n_total} < {self.out_len}); pad first")
        positions = window_positions(n_total, self.out_len)
        n_win = int(positions.shape[0])
        if chunk_sizes is not None:
            sizes = [int(k) for k in chunk_sizes]
            if sum(sizes) < n_win:
                raise ValueError(f"chunk_sizes {sizes} cover {sum(sizes)} "
                                 f"< {n_win} windows")
        else:
            sizes = self.resident_chunk_sizes(n_win)
        pos_pad = np.full((sum(sizes),), positions[-1], np.int64)
        pos_pad[:n_win] = positions
        pos_dev = torch.from_numpy(pos_pad).to(self.device)
        starts = positions.tolist()
        out_len, pad = self.out_len, self.pad
        names = list(self.cfg.source_names)
        reconstruct_last = self._host_reconstruct_last

        def sweep(params, song):
            parts, off = [], 0
            for k in sizes:
                parts.append(self._chunk_fwd(params, song,
                                             pos_dev[off:off + k]))
                off += k
            out = {}
            for name in parts[0]:
                w = torch.cat([p[name] for p in parts])[:n_win]
                if w.dtype == torch.int16:
                    w = from_wire(w)
                buf = torch.zeros((n_total, w.shape[2]), dtype=torch.float32,
                                  device=song.device)
                for i, p in enumerate(starts):  # later writes win
                    buf[p:p + out_len] = w[i]
                out[name] = buf
            if reconstruct_last:
                mix = song[pad:pad + n_total]
                if mix.dtype == torch.int16:
                    mix = dequantize(mix)
                out[names[-1]] = torch.clamp(
                    mix - sum(out[s] for s in names[:-1]), -1.0, 1.0)
            checksum = sum(v.sum() for v in out.values())
            return out, checksum

        if graphed is None:
            graphed = self.device.type == "cuda"
        if not graphed:
            return sweep, positions
        if self.device.type != "cuda":
            raise RuntimeError("a graphed resident sweep needs a CUDA device")
        held = {}

        def fn(params, song):
            g = held.get("graph")
            if g is None:
                static = song.clone()
                g = capture(lambda s: sweep(params, s), (static,))
                held.update(graph=g, params=params)
            elif params is not held["params"]:
                raise ValueError("this graphed sweep was captured with other "
                                 "params; call resident_sweep again")
            static = g.inputs[0]
            if song.shape != static.shape or song.dtype != static.dtype:
                raise ValueError(f"song {tuple(song.shape)} {song.dtype} does "
                                 f"not fit the captured sweep "
                                 f"{tuple(static.shape)} {static.dtype}")
            if song.data_ptr() != static.data_ptr():
                static.copy_(song)
            return g.replay()

        fn.held = held  # the captured Graph, once fn has run
        return fn, positions

    # -- full-song separation -------------------------------------------------
    def separate(self, mix_audio: np.ndarray,
                 mix_sr: int) -> Dict[str, np.ndarray]:
        """Separate (n_frames, n_channels) audio; returns sources at the
        model's ``expected_sr`` and channel count."""
        cfg = self.cfg
        if mix_audio.ndim != 2:
            raise ValueError(f"expected (frames, channels) audio, got shape "
                             f"{mix_audio.shape}")
        if cfg.mono_downmix:
            mix_audio = np.mean(mix_audio, axis=1, keepdims=True)
        elif mix_audio.shape[1] == 1:
            mix_audio = np.tile(mix_audio, [1, 2])
        mix_audio = resample(mix_audio, mix_sr, cfg.expected_sr)

        # Zero-pad short songs up to one full network input.
        extra_pad = max(0, self.in_len - mix_audio.shape[0])
        if extra_pad:
            mix_audio = np.pad(mix_audio, [(0, extra_pad), (0, 0)])
        n_total = mix_audio.shape[0]
        positions = window_positions(n_total, self.out_len)
        preds = self._run_batched(mix_audio, positions, n_total)
        if extra_pad:
            preds = {k: v[:-extra_pad] for k, v in preds.items()}
            mix_audio = mix_audio[:-extra_pad]

        if self._host_reconstruct_last:
            acc = sum(preds[s] for s in cfg.source_names[:-1])
            preds[cfg.source_names[-1]] = np.clip(
                mix_audio - acc, -1.0, 1.0).astype(np.float32)
        return preds

    def _host_buffer(self, key: str, numel: int,
                     dtype: torch.dtype) -> torch.Tensor:
        """A flat host tensor of ``numel`` elements, pinned on a CUDA
        device, kept and grown across requests."""
        buf = self._host_bufs.get(key)
        if buf is None or buf.numel() < numel or buf.dtype != dtype:
            buf = torch.empty(numel, dtype=dtype,
                              pin_memory=self.device.type == "cuda")
            self._host_bufs[key] = buf
        return buf[:numel]

    def _stage(self, mix: np.ndarray, length: int) -> torch.Tensor:
        """The context-padded song in the wire dtype, written once into the
        host staging buffer: [pad zeros | mix | zeros up to ``length``]."""
        C = self.cfg.num_channels
        song = self._host_buffer("song", length * C, self._wire_dtype)
        song = song.view(length, C)
        host = song.numpy()
        n = mix.shape[0]
        host[:self.pad] = 0
        host[self.pad:self.pad + n] = (quantize_int16(mix) if self._wire16
                                       else mix)
        host[self.pad + n:] = 0
        return song

    def stage_resident(self, mix: np.ndarray) -> torch.Tensor:
        """The song ``resident_sweep``'s ``fn`` takes: ``mix`` (frames x
        channels, at the model's rate and channel count) padded and
        quantised as ``separate`` stages it, copied to the device."""
        staged = self._stage(mix, mix.shape[0] + 2 * self.pad)
        return staged.to(self.device, copy=True)  # the buffer is reused

    def _run_batched(self, mix: np.ndarray, positions: np.ndarray,
                     n_total: int) -> Dict[str, np.ndarray]:
        """Sweep every window through the forward and stitch on the host."""
        dev, cuda = self.device, self.device.type == "cuda"
        n_win = positions.shape[0]
        sizes = self._chunk_sizes(n_win)
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        # Padded slots repeat the last window; their results are dropped.
        pos_pad = np.full((int(offsets[-1]),), positions[-1], np.int64)
        pos_pad[:n_win] = positions
        t = n_total + 2 * self.pad
        use_slabs = self._h2d_mode == "slabs" or (
            self._h2d_mode is None and len(sizes) >= 2
            and 3 * (self.in_len - self.out_len) <= self.batch * self.out_len)
        # room for the last slab of a chunk, past the song's end, as zeros
        song = self._stage(mix, t + (self.batch - 1) * self.out_len
                           if use_slabs else t)
        starts = pos_pad[offsets[:-1]]
        if use_slabs:  # positions relative to their chunk's slab
            pos_pad = pos_pad - np.repeat(starts, sizes)
        pos_host = self._host_buffer("pos", pos_pad.size, torch.int64)
        pos_host.numpy()[:] = pos_pad
        pos_dev = pos_host.to(dev, non_blocking=True)
        stream = torch.cuda.current_stream(dev) if cuda else None

        if not use_slabs:
            static = self._static_song
            if static is not None and t <= static.shape[0]:
                static[:t].copy_(song[:t], non_blocking=True)
                song_dev = static  # the song-mode graphs read it
            else:
                song_dev = song[:t].to(dev, non_blocking=True)
        elif cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)

        results = []  # per chunk: ({name: host [k, out_len, C]}, event)
        for ci, k in enumerate(sizes):
            pos = pos_dev[offsets[ci]:offsets[ci + 1]]
            if use_slabs:
                slab_host = song[int(starts[ci]):int(starts[ci])
                                 + (k - 1) * self.out_len + self.in_len]
                if cuda:  # the copy of chunk i+1 overlaps chunk i's forward
                    with torch.cuda.stream(self._copy_stream):
                        inp = slab_host.to(dev, non_blocking=True)
                    stream.wait_stream(self._copy_stream)
                    inp.record_stream(stream)
                else:
                    inp = slab_host
                res = self._run_chunk("slabs", inp, pos)
            else:
                res = self._run_chunk("song", song_dev, pos)
            host = {}
            for name, v in res.items():
                off = int(offsets[ci]) * self.out_len * v.shape[2]
                h = self._host_buffer(f"out/{name}", int(offsets[-1])
                                      * self.out_len * v.shape[2], v.dtype)
                h = h[off:off + v.numel()].view(v.shape)
                h.copy_(v, non_blocking=True)  # stream-ordered, before the
                host[name] = h                 # next replay overwrites v
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(stream)
            results.append((host, event))

        out = {name: np.empty((n_total, self.cfg.num_channels),
                              np.int16 if self._wire16 else np.float32)
               for name in results[0][0]}
        wi = 0
        for host, event in results:  # stitch each chunk once it is back
            if event is not None:
                event.synchronize()
            wins = {name: h.numpy() for name, h in host.items()}
            for b in range(min(len(next(iter(wins.values()))), n_win - wi)):
                p = int(positions[wi])
                for name, w in wins.items():
                    out[name][p:p + self.out_len] = w[b]  # later writes win
                wi += 1
        if self._wire16:
            return {name: from_wire_np(buf) for name, buf in out.items()}
        return out


def separate_file(cfg: Config, params, input_path: str,
                  output_path: Optional[str] = None,
                  device: DeviceLike = None,
                  model_state=None) -> Dict[str, str]:
    """Separate a PCM WAV file into one 16-bit WAV per source, written next
    to the input or into ``output_path``; ``model_state`` carries the
    spectrogram model's batch-norm statistics. Returns {source: path}."""
    from waveunet_tpu_torch.data.audio_io import load_wav, write_wav

    audio, sr = load_wav(input_path)
    sep = Separator(cfg, params, model_state=model_state, device=device)
    preds = sep.separate(audio, sr)
    folder, fname = os.path.split(input_path)
    out_dir = output_path or folder or "."
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for name, est in preds.items():
        # back to the input's rate and length
        est = resample(est, cfg.expected_sr, sr)[:audio.shape[0]]
        if cfg.mono_downmix and audio.shape[1] > 1:
            est = np.tile(est, [1, audio.shape[1]])
        path = os.path.join(out_dir, f"{fname}_{name}.wav")
        write_wav(path, est, sr)
        written[name] = path
    return written
