"""Batched sliding-window separation engine, in PyTorch.

Counterpart of ``waveunet_tpu/infer/engine.py`` with the same semantics step
by step: mono downmix or channel tiling, resampling to the model rate, zero
padding of songs shorter than one network input, context padding, windows at
hop = output length with the last one right-aligned, stitching in window
order (later writes win), and the difference source.

``Separator.separate`` is the engine's one serving path: ``separate_file``,
the command line, the evaluation harness and the benchmark all reach it.
Its host pipeline:

  * a song at another rate than the model's is resampled on the card
    when the Separator's device is CUDA: copied into a pinned host buffer
    (float64 for a float64 song, else fp32), sent with one non-blocking
    copy, resampled by the hand-written polyphase kernel
    (``ops/kernels/resample_poly.py``; float64 products and sums, rounded
    to fp32 once, as the host path computes them) and brought back with
    one non-blocking copy into a second pinned buffer, waited for on an
    event. The rest of ``separate`` stages that host copy (the int16
    wire's host difference source reads it too). On any other device the
    host resamples it (``ops/resample.py::resample``), and a song at the
    model's rate is not resampled at all;
  * the context-padded song is written once into a pinned host staging
    buffer (quantised there on the int16 wire, bit for bit as the JAX
    package's native host op) and crosses to the device with non-blocking
    copies: whole ("song" mode) or one slab per chunk on a side copy stream
    ("slabs" mode, so a chunk's copy overlaps the previous chunk's forward);
  * windows are framed on the device by one gather from a device tensor of
    window starts, so a chunk's program has no host-side values in it;
  * windows sweep through the forward in chunks of ``infer_batch`` with a
    power-of-two split tail; right after each chunk's forward, copies on
    the compute stream place its windows straight into the answer: window
    j sits at ``j * out_len``, so a chunk's real windows below the song's
    last are one block, one copy a source, and the last window, right-
    aligned, is a second copy after it (later writes win; padded slots are
    not copied). The answer is one ``(n_total, C)`` host tensor a source in
    the wire dtype, drawn for each request: page-locked on a CUDA device,
    from PyTorch's pinned-memory cache (a block an earlier answer gave
    back, already faulted in). The host waits once, on an event after the
    last chunk, and copies no audio on the float32 wire;
  * the difference source, ``clip(mix - sum(others), -1, 1)`` of a
    difference-output Wave-U-Net or BS-RoFormer: on the float32 wire the
    chunk program computes it for each window from the centre of the
    window's own input (the Wave-U-Net's forward gives it, the BS-RoFormer
    forward adds it, ``model_forward``), and it is placed in the answer
    like every other source, so the host builds nothing (counted
    by ``separate.device_difference``). Every stitched sample of every
    source comes from the same window, where the mix is the staged song,
    so this is the host's rebuild bit for bit for a float32 song. On the
    int16 wire, whose contract quantises each other source before the
    subtraction, the chunk program leaves it out and the host rebuilds it
    from the stitched sources and the float mix (``separate.difference``);
  * ``precompile`` captures the chunk forward of every power-of-two chunk
    size in both modes as CUDA graphs (static input and position buffers,
    one shared memory pool); ``separate`` replays a graph wherever one fits
    and runs eagerly otherwise.

Window parallelism (``mesh``, ``parallel/mesh.py``; every rank calls
``separate`` with the same song): a chunk holds ``infer_batch`` windows a
rank, rank r runs rows ``[r*infer_batch, (r+1)*infer_batch)`` of each
chunk, and the chunk's outputs are gathered exactly onto every rank, so
every rank returns the same stems, and a world of one is the single-device
engine bit for bit. Each rank stages the song itself and slabs are off;
on several ranks the tail chunk stays at the full batch, as in the JAX
package. ``precompile`` captures the per-rank forward; the gather stays
outside the graphs.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from waveunet_tpu_torch import tracing
from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.infer.wire import (INT16_NONFINITE, dequantize,
                                           from_wire_np, full_scale,
                                           quantize_int16, to_wire)
from waveunet_tpu_torch.ops import shapes
from waveunet_tpu_torch.ops.kernels import Graph, capture
from waveunet_tpu_torch.ops.kernels.resample_poly import resample_poly_cuda
from waveunet_tpu_torch.ops.primitives import crop
from waveunet_tpu_torch.ops.resample import resample
from waveunet_tpu_torch.parallel.mesh import (barrier, check_mesh,
                                              gather_rows, put_replicated)

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


def model_params(cfg: Config, params: Mapping) -> Mapping:
    """The parameters the default ``forward_fn`` of ``cfg``'s family
    reads: BS-RoFormer's prepared once (cast and stacked,
    ``models/bs_roformer.py::prepare_params``), outside any graph; the
    others' as they are."""
    if cfg.network == "bs_roformer":
        from waveunet_tpu_torch.models.bs_roformer import prepare_params
        return prepare_params(params, cfg)
    return params


def model_forward(cfg: Config, model_state: Mapping, out_len: int,
                  difference: bool = True) -> Forward:
    """The default ``forward_fn`` of ``cfg``'s family: the Wave-U-Net at
    inference, BS-RoFormer on ``model_params``' parameters, or the
    spectrogram U-Net with its batch-norm statistics ``model_state``, whose
    iSTFT must give exactly ``out_len`` samples a window.

    With the difference output, ``difference`` says whether the forward
    gives the last source, ``clip(mix - sum(others), -1, 1)`` of each
    window's centre ``out_len`` samples with the others summed in source
    order: the Wave-U-Net's own (``models/waveunet.py::_output``), and
    for BS-RoFormer, which masks only the others, the same operations
    here; False leaves it out of both."""
    names = cfg.source_names
    last = names[-1] if cfg.output_type == "difference" else None
    if cfg.network == "bs_roformer":
        from waveunet_tpu_torch.models.bs_roformer import forward as roformer

        def forward(p, x):
            out = roformer(p, cfg, x)
            if difference and last is not None:
                acc = out[names[0]]
                for name in names[1:-1]:
                    acc = acc + out[name]
                out[last] = torch.clamp(crop(x, out_len) - acc, -1.0, 1.0)
            return out
        return forward
    if cfg.network == "unet":
        from waveunet_tpu_torch.models.waveunet import apply_waveunet

        def forward(p, x):
            out = apply_waveunet(p, cfg, x, training=False)
            if not difference:
                out.pop(last, None)
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
    Wave-U-Net forward at inference, to BS-RoFormer's for ``bs_roformer``
    (its parameters prepared once here, ``model_params``), or to the
    spectrogram U-Net's with ``model_state`` (its batch-norm statistics)
    for ``unet_spectrogram``.
    ``h2d_mode`` is "song", "slabs" or None (slabs when a song takes two or
    more chunks and the slabs' context overlap adds at most a third).
    ``mesh`` shards each chunk's windows over its ranks, on ``mesh.device``
    with rank 0's parameters (the module docstring)."""

    def __init__(self, cfg: Config, params, model_state=None,
                 forward_fn: Optional[Forward] = None,
                 h2d_mode: Optional[str] = None, device: DeviceLike = None,
                 mesh=None):
        if h2d_mode not in (None, "song", "slabs"):
            raise ValueError(f"h2d_mode {h2d_mode!r}: use 'song', 'slabs' "
                             f"or None")
        self.cfg = cfg
        self.mesh = check_mesh(mesh)
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.params = tree_to(params, self.device)
        self.model_state = tree_to(model_state or {}, self.device)
        if self.mesh is not None:
            self.params = put_replicated(self.params, self.mesh)
            self.model_state = put_replicated(self.model_state, self.mesh)
        frames = cfg.infer_num_frames or cfg.num_frames
        if frames == -1:  # auto: smallest pow2 window with <= 3x overlap
            frames = shapes.auto_infer_frames(cfg)
        self.in_len, self.out_len = shapes.get_padding(cfg, frames)
        self.pad = (self.in_len - self.out_len) // 2
        # windows a chunk: each rank runs local_batch of them
        self.local_batch = max(1, cfg.infer_batch)
        self.batch = self.local_batch * (self.mesh.size if self.mesh else 1)
        # several ranks need equal rows in every chunk; one rank keeps the
        # single-device schedule (the conv kernel's launch plan, and so its
        # rounding, follows the chunk's size)
        self._full_tail = self.mesh is not None and self.mesh.size > 1
        self._h2d_mode = h2d_mode
        self._wire16 = cfg.infer_wire_dtype == "int16"
        self._wire_dtype = torch.int16 if self._wire16 else torch.float32
        # The difference source clip(mix - sum(others)) of the default
        # Wave-U-Net and BS-RoFormer forwards. On the fp32 wire the chunk
        # program computes it a window and it goes home like the others;
        # on the int16 wire, whose contract quantises each other source
        # before the subtraction, the host rebuilds it from the stitched
        # sources and the float mix.
        difference = (forward_fn is None
                      and cfg.network in ("unet", "bs_roformer")
                      and cfg.output_type == "difference")
        self._device_difference = difference and not self._wire16
        self._host_reconstruct_last = difference and self._wire16
        self._forward_fn = forward_fn or model_forward(
            cfg, self.model_state, self.out_len,
            difference=not self._host_reconstruct_last)
        if forward_fn is None:
            self.params = model_params(cfg, self.params)
        self._arange_in = torch.arange(self.in_len, device=self.device)
        full_scale(self._arange_in.device)  # before any capture divides by it
        self._graphs: Dict[Tuple[str, int], Graph] = {}
        self._static_song: Optional[torch.Tensor] = None
        self._host_bufs: Dict[str, torch.Tensor] = {}
        self._copy_stream = None
        self._requests = 0  # the sequence number of the last separate()

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
            tracing.count("separate.eager_chunks")
            return self._chunk_fwd(self.params, inp, pos)
        static_in, static_pos = g.inputs
        if static_in is not inp:
            static_in.copy_(inp)
        static_pos.copy_(pos)
        return g.replay()

    def _chunk_sizes(self, n_win: int) -> List[int]:
        """Full batches, then a power-of-two tail: one chunk, or two when
        that pads fewer slots (11 windows at batch 16 -> 8 + 4, not 16). On
        a mesh of several ranks the tail is a full batch, which they
        share."""
        bs = self.batch
        sizes = [bs] * (n_win // bs)
        rem = n_win % bs
        if rem and self._full_tail:
            sizes.append(bs)
        elif rem:
            single = min(shapes.pow2_ceil(rem), bs)
            lo = 1 << (rem.bit_length() - 1)  # largest pow2 <= rem
            if rem > lo and lo + shapes.pow2_ceil(rem - lo) < single:
                sizes += [lo, shapes.pow2_ceil(rem - lo)]
            else:
                sizes.append(single)
        return sizes

    def _pow2_sizes(self) -> List[int]:
        """Every chunk size ``_chunk_sizes`` can give, largest first (a
        rank's share of it on a mesh of several ranks)."""
        if self._full_tail:
            return [self.local_batch]
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
        per graph. On a mesh: song mode only, and on several ranks only
        the rank's full-batch forward, the one program it runs."""
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
        modes = ("song",) if self.mesh is not None else ("song", "slabs")
        total = len(modes) * len(ks)
        for k in ks:
            for mode in modes:
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

    # -- full-song separation -------------------------------------------------
    def separate(self, mix_audio: np.ndarray,
                 mix_sr: int) -> Dict[str, np.ndarray]:
        """Separate (n_frames, n_channels) audio; returns sources at the
        model's ``expected_sr`` and channel count. A song at another rate
        is resampled on a CUDA device's card (``_card_resample``), on the
        host otherwise.

        Each request's sources are its own memory. On a CUDA device the
        float32 wire's are page-locked: views of blocks drawn from PyTorch's
        pinned-memory cache, which go back to it when the caller drops
        them, so a caller that keeps many answers keeps that memory
        locked."""
        self._requests += 1
        with tracing.span("separate", request=self._requests):
            cfg = self.cfg
            if mix_audio.ndim != 2:
                raise ValueError(f"expected (frames, channels) audio, got "
                                 f"shape {mix_audio.shape}")
            if cfg.mono_downmix:
                mix_audio = np.mean(mix_audio, axis=1, keepdims=True)
            elif mix_audio.shape[1] == 1:
                mix_audio = np.tile(mix_audio, [1, 2])
            if self._resamples_on_card(mix_sr):
                mix_audio = self._card_resample(mix_audio, mix_sr)
            else:
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

            if self._device_difference:
                tracing.count("separate.device_difference")
            elif self._host_reconstruct_last:
                with tracing.span("separate.difference"):
                    acc = sum(preds[s] for s in cfg.source_names[:-1])
                    preds[cfg.source_names[-1]] = np.clip(
                        mix_audio - acc, -1.0, 1.0).astype(np.float32)
            return preds

    def _resamples_on_card(self, mix_sr: int) -> bool:
        """Whether ``separate`` resamples a song on the card: the device
        is CUDA, and the song comes at another rate than the model's."""
        return (self.device.type == "cuda"
                and mix_sr != self.cfg.expected_sr)

    def _card_resample(self, mix: np.ndarray, mix_sr: int) -> np.ndarray:
        """``mix`` at the model's rate through the kernel: a pinned copy
        (float64 for a float64 mix, which the kernel reads as it is; fp32
        otherwise), one H2D, the launch, one D2H into a second pinned
        buffer and the wait on its event, all inside the ``resample`` span.
        Returns a float32 view of that buffer, which the next request
        overwrites."""
        with tracing.span("resample"):
            tracing.count("separate.device_resample")
            n, C = mix.shape
            dtype = (torch.float64 if mix.dtype == np.float64
                     else torch.float32)
            src = self._host_buffer("resample/in", n * C, dtype).view(n, C)
            src.numpy()[:] = mix
            y = resample_poly_cuda(src.to(self.device, non_blocking=True),
                                   mix_sr, self.cfg.expected_sr)
            out = self._host_buffer("resample/out", y.numel(),
                                    torch.float32).view(y.shape)
            out.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
            return out.numpy()

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

    def _run_batched(self, mix: np.ndarray, positions: np.ndarray,
                     n_total: int) -> Dict[str, np.ndarray]:
        """Sweep every window through the forward, its outputs copied
        straight into the answer (the module docstring); one wait."""
        dev, cuda = self.device, self.device.type == "cuda"
        n_win = positions.shape[0]
        sizes = self._chunk_sizes(n_win)
        tracing.count("separate.windows", n_win)
        tracing.count("separate.window_slots", sum(sizes))
        tracing.count("separate.chunks", len(sizes))
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        # Padded slots repeat the last window; their results are dropped.
        pos_pad = np.full((int(offsets[-1]),), positions[-1], np.int64)
        pos_pad[:n_win] = positions
        t = n_total + 2 * self.pad
        use_slabs = self.mesh is None and (self._h2d_mode == "slabs" or (
            self._h2d_mode is None and len(sizes) >= 2
            and 3 * (self.in_len - self.out_len) <= self.batch * self.out_len))
        # room for the last slab of a chunk, past the song's end, as zeros
        with tracing.span("separate.stage"):
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

        C, L = self.cfg.num_channels, self.out_len
        answer: Dict[str, torch.Tensor] = {}
        for ci, k in enumerate(sizes):
            with tracing.span("separate.chunk"):
                pos = pos_dev[offsets[ci]:offsets[ci + 1]]
                if use_slabs:
                    slab_host = song[int(starts[ci]):int(starts[ci])
                                     + (k - 1) * self.out_len + self.in_len]
                    if cuda:  # chunk i+1's copy overlaps chunk i's forward
                        with torch.cuda.stream(self._copy_stream):
                            inp = slab_host.to(dev, non_blocking=True)
                        stream.wait_stream(self._copy_stream)
                        inp.record_stream(stream)
                    else:
                        inp = slab_host
                    res = self._run_chunk("slabs", inp, pos)
                elif self.mesh is not None:  # this rank's rows, gathered
                    r, b = self.mesh.rank, k // self.mesh.size
                    res = self._run_chunk("song", song_dev,
                                          pos[r * b:(r + 1) * b])
                    res = {k: gather_rows(v, self.mesh)
                           for k, v in res.items()}
                else:
                    res = self._run_chunk("song", song_dev, pos)
            with tracing.span("separate.stitch"):
                if not answer:  # on a card: blocks earlier answers gave back
                    answer = {name: torch.empty(
                        (n_total, C), dtype=self._wire_dtype, pin_memory=cuda)
                        for name in res}
                # Window j sits at j * L, the last right-aligned: the
                # chunk's real windows below the last are one block, and
                # the last goes after it (later writes win). Stream-ordered,
                # before the next replay overwrites the outputs.
                j0 = int(offsets[ci])
                body = min(k, n_win - 1 - j0)
                for name, v in res.items():
                    a = answer[name]
                    if body > 0:
                        a[j0 * L:(j0 + body) * L].view(body, L, C).copy_(
                            v[:body], non_blocking=True)
                    if j0 + k >= n_win:
                        a[n_total - L:].copy_(v[n_win - 1 - j0],
                                              non_blocking=True)
                tracing.count("separate.placed_windows", min(k, n_win - j0))
        if cuda:
            done = torch.cuda.Event()
            done.record(stream)
            with tracing.span("separate.wait"):
                done.synchronize()
        if self._wire16:
            with tracing.span("separate.stitch"):
                return {name: from_wire_np(a.numpy())
                        for name, a in answer.items()}
        return {name: a.numpy() for name, a in answer.items()}


def separate_file(cfg: Config, params, input_path: str,
                  output_path: Optional[str] = None,
                  device: DeviceLike = None,
                  model_state=None, mesh=None) -> Dict[str, str]:
    """Separate a PCM WAV file into one 16-bit WAV per source, written next
    to the input or into ``output_path``; ``model_state`` carries the
    spectrogram model's batch-norm statistics. Returns {source: path}. On a
    ``mesh`` every rank separates and rank 0 writes; the call returns once
    the files are written."""
    from waveunet_tpu_torch.data.audio_io import load_wav, write_wav

    audio, sr = load_wav(input_path)
    sep = Separator(cfg, params, model_state=model_state, device=device,
                    mesh=mesh)
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
        if sep.mesh is None or sep.mesh.rank == 0:
            write_wav(path, est, sr)
        written[name] = path
    if sep.mesh is not None:
        barrier(sep.mesh)
    return written
