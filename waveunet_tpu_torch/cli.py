"""Command-line entry points of the port.

The counterpart of ``waveunet_tpu/cli.py``: the same ten commands and the
same preset + ``key=value`` grammar (the reference's sacred CLI,
``Training.py:152-166``, ``Predict.py:14-17``):

  python -m waveunet_tpu_torch train full_44KHz [key=value ...]
  python -m waveunet_tpu_torch predict full_44KHz input_path=mix.wav \\
      [checkpoint=path|auto|best] [output_path=dir]
  python -m waveunet_tpu_torch evaluate full_44KHz checkpoint=path \\
      [subset=test] [output_path=dir] [max_tracks=N] [win_s=1] \\
      [tpu_bss=0|1|f64] [self_check=1]
  python -m waveunet_tpu_torch stream full_44KHz input_path=mix.wav \\
      [chunk_ms=500] [batch_windows=8]
  python -m waveunet_tpu_torch warmup full_44KHz [max_song_s=360]
  python -m waveunet_tpu_torch profile full_44KHz [output_path=dir]
  python -m waveunet_tpu_torch convert-checkpoint full_44KHz \\
      checkpoint=<tf ckpt> [output_path=dir]
  python -m waveunet_tpu_torch prepare-data full_44KHz   # MUSDB -> npz cache
  python -m waveunet_tpu_torch presets                   # named configs
  python -m waveunet_tpu_torch figures results_dir=<dir> # SDR violin / spectrogram

Every command runs on the CUDA card; ``platform=cpu`` (accepted anywhere on
the line) runs it on the host instead, and without a card a command that
needs one exits 2 saying so. ``random_init=1`` runs with seeded random
weights where no checkpoint is given.

Several cards run one process a card. ``train``, ``evaluate`` and
``predict`` take the pod options of the JAX package, one command a rank:

  python -m waveunet_tpu_torch train full_44KHz coordinator=host0:1234 \
      num_processes=4 process_id=<i> experiment_id=run1

or read ``torchrun``'s environment (``torchrun --nproc-per-node=4 -m
waveunet_tpu_torch train full_44KHz ...``). Each rank takes the card
``LOCAL_RANK``, else ``process_id`` modulo the host's cards; NCCL on the
cards, gloo with ``platform=cpu``. ``train`` trains either model family
data-parallel (the U7 spectrogram U-Net's batch norm takes its statistics
over every rank's rows; process 0 prepares the cache while the others wait,
up to
``WAVEUNET_PREPARE_TIMEOUT_S`` seconds), ``evaluate`` scores a disjoint
track shard on each card and process 0 prints the table, and ``predict``
shards the song's windows over the cards.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

_POD_OPTIONS = ("coordinator", "num_processes", "process_id")


class _Device:
    """The device a command runs on: ``platform=`` when given, else the
    card. Resolved on first use, so commands that need none never ask."""

    def __init__(self, platform: Optional[str]):
        self.platform = platform

    def get(self):
        import torch

        from waveunet_tpu_torch.device import resolve_device

        if self.platform not in (None, "cpu", "cuda", "gpu"):
            _exit(f"unknown platform={self.platform!r}: use cpu or cuda")
        if self.platform in (None, "cuda", "gpu") \
                and not torch.cuda.is_available():
            _exit("no CUDA device is available; pass platform=cpu to run "
                  "on the host")
        if self.platform == "cpu":
            return resolve_device("cpu")
        # a pod rank's own card (initialize set it current)
        return resolve_device(torch.device("cuda",
                                           torch.cuda.current_device()))


def _exit(msg: str, code: int = 2):
    print(f"error: {msg}", file=sys.stderr)
    sys.exit(code)


def _apply_platform(argv: List[str]) -> Tuple[List[str], _Device]:
    """Consume every ``platform=...`` fragment, wherever it stands; the
    last one wins."""
    rest, platform = [], None
    for a in argv:
        if a.startswith("platform="):
            platform = a.split("=", 1)[1].lower()
        else:
            rest.append(a)
    return rest, _Device(platform)


def _split_args(args: List[str]) -> Tuple[List[str], Dict[str, str]]:
    """Split CLI fragments into config fragments and CLI-local options."""
    cli_keys = {"input_path", "output_path", "checkpoint", "subset",
                "experiment_id", "max_epochs", "win_s", "max_tracks",
                "final_eval", "tpu_bss", "chunk_ms", "batch_windows",
                "max_song_s", "random_init", "results_dir", "self_check",
                *_POD_OPTIONS}
    cfg_frags, opts = [], {}
    for a in args:
        if "=" in a:
            k, v = a.split("=", 1)
            if k in cli_keys:
                opts[k] = v
                continue
        cfg_frags.append(a)
    return cfg_frags, opts


def _maybe_init_pod(opts, device) -> int:
    """Bring up the process group before any device use, from the pod
    options or from torchrun's environment; returns the world size (1: a
    single process, nothing to do). ``process_id`` alone runs one process,
    as in the JAX package."""
    import torch.distributed as dist

    from waveunet_tpu_torch.parallel import distributed as D

    if ("coordinator" not in opts and "num_processes" not in opts
            and int(os.environ.get("WORLD_SIZE", "1")) <= 1):
        return 1
    if device.platform != "cpu":
        import torch
        if not torch.cuda.is_available():
            device.get()  # exits 2, saying why
    try:
        rank = D.initialize(
            coordinator_address=opts.get("coordinator"),
            num_processes=(int(opts["num_processes"])
                           if "num_processes" in opts else None),
            process_id=(int(opts["process_id"])
                        if "process_id" in opts else None),
            device="cpu" if device.platform == "cpu" else None)
    except ValueError as e:
        _exit(f"pod options: {e}")
    n = dist.get_world_size() if dist.is_initialized() else 1
    print(f"pod process {rank}/{n} up on {device.get()}")
    return n


def _config(cfg_frags: List[str]):
    from waveunet_tpu_torch.config import config_from_cli
    return config_from_cli(cfg_frags)


def cmd_presets(_args, _device):
    from waveunet_tpu_torch.config import get_config, preset_names
    for name in preset_names():
        cfg = get_config(name)
        print(f"{name:36s} net={cfg.network:16s} sr={cfg.expected_sr:6d} "
              f"ch={cfg.num_channels} ctx={int(cfg.context)} "
              f"out={cfg.output_type}")


def cmd_train(args, device):
    from waveunet_tpu_torch.data import cache
    from waveunet_tpu_torch.ops import shapes
    from waveunet_tpu_torch.parallel.mesh import world
    from waveunet_tpu_torch.train.loop import optimise

    cfg_frags, opts = _split_args(args)
    cfg = _config(cfg_frags)
    n_proc = _maybe_init_pod(opts, device)
    dev = device.get()
    if not cache.is_prepared(cfg):
        if world()[0] != 0:
            # one preparer; the others wait for its marker, with a deadline
            # so a crash of process 0 fails the pod instead of hanging it
            import time
            limit = float(os.environ.get("WAVEUNET_PREPARE_TIMEOUT_S", 7200))
            print(f"waiting for process 0 to prepare the dataset cache "
                  f"(timeout {limit:.0f}s)...")
            t0 = time.monotonic()
            while not cache.is_prepared(cfg):
                if time.monotonic() - t0 > limit:
                    _exit(f"dataset cache not prepared within {limit:.0f}s "
                          f"- did process 0 die? (WAVEUNET_PREPARE_TIMEOUT_S "
                          f"overrides)", 3)
                time.sleep(2.0)
        else:
            print("Preparing dataset cache...")
            cache.prepare_dataset(cfg,
                                  shapes.context_pad(cfg, cfg.num_frames))
    mesh = None
    if n_proc > 1:
        from waveunet_tpu_torch.parallel.mesh import make_mesh
        if cfg.batch_size % n_proc:
            _exit(f"batch_size {cfg.batch_size} must divide across "
                  f"{n_proc} pod devices")
        mesh = make_mesh(devices=[dev])
    max_ep = int(opts["max_epochs"]) if "max_epochs" in opts else None
    resume = opts.get("checkpoint")
    if resume == "auto":  # crash-resume from the newest checkpoint, if any
        resume = _resolve_auto_checkpoint(cfg, opts.get("experiment_id", ""))
        print(f"auto-resume: {resume or 'no checkpoint found, fresh start'}")
    path, test_loss = optimise(cfg, experiment_id=opts.get("experiment_id"),
                               mesh=mesh, resume_path=resume,
                               max_epochs_per_round=max_ep, device=dev)
    print(f"Best model: {path}; test loss {test_loss}")
    # the reference's run ends with MUSDB estimates of the best model
    # (Training.py:161-166); opt-in here, a full BSS-Eval pass is long
    if opts.get("final_eval", "0").lower() in ("1", "true", "musdb") and path:
        _dataset_eval(cfg, opts, path, "test", cfg.estimates_path, dev)


def _dataset_eval(cfg, opts, checkpoint, subset, output_path, dev):
    """The dataset evaluation of ``evaluate`` and ``train final_eval=1``.

    In a pod each rank scores a disjoint stride of the tracks on its own
    card (no collective inside: a per-track loop with file writes must not
    steer the ranks' collectives), all meet at a barrier, and rank 0
    aggregates the shared results folder once."""
    from waveunet_tpu_torch.eval.harness import (aggregate_and_print,
                                                 evaluate_musdb)
    from waveunet_tpu_torch.parallel.mesh import barrier, host_mesh, world

    rank, n_proc = world()
    pod = n_proc > 1
    if pod:
        print(f"pod {subset} eval: scoring track shard {rank}/{n_proc} on "
              f"{dev}")
    params, model_state = _load_params(cfg, checkpoint,
                                       opts.get("experiment_id", ""),
                                       allow_random=_random_ok(opts),
                                       device=dev)
    evaluate_musdb(cfg, params, model_state=model_state, subset=subset,
                   output_path=output_path,
                   max_tracks=(int(opts["max_tracks"])
                               if "max_tracks" in opts else None),
                   win_s=float(opts.get("win_s", 1.0)),
                   tpu_bss=_parse_tpu_bss(opts),
                   shard_index=rank, shard_count=n_proc, aggregate=not pod,
                   self_check=opts.get("self_check", "1").lower()
                   not in ("0", "false"), device=dev)
    if pod:
        barrier(host_mesh())
        if rank == 0:
            aggregate_and_print(os.path.join(output_path, subset))


def _random_ok(opts):
    return opts.get("random_init", "0").lower() in ("1", "true")


def _parse_tpu_bss(opts):
    """tpu_bss=0|1|f64: the host fp64 scorer, the fp32 device scorer, or
    the fp64 device scorer."""
    v = opts.get("tpu_bss", "0").lower()
    if v == "f64":
        return "f64"
    return v in ("1", "true", "fp32")


def _load_params(cfg, checkpoint, experiment_id="", allow_random=False,
                 device=None):
    """Weights for an inference or evaluation command, on ``device``.

    ``checkpoint=auto``: the newest step directory (of ``experiment_id``,
    else of every experiment); ``best``: the checkpoint ``best.txt`` names;
    a dangling auto/best is an error. No checkpoint is an error unless
    ``allow_random`` (``random_init=1``): random weights would pass for a
    very bad model. A TF checkpoint (``.ckpt`` or ``<prefix>.index``) is
    converted; anything else is the port's own step directory."""
    from waveunet_tpu_torch.train import checkpoint as ckpt
    from waveunet_tpu_torch.train.loop import init_state

    if checkpoint in ("auto", "best"):
        mode = checkpoint
        checkpoint = (_resolve_auto_checkpoint(cfg, experiment_id)
                      if mode == "auto"
                      else _resolve_best_checkpoint(cfg, experiment_id))
        if checkpoint is None:
            _exit(f"checkpoint={mode} found nothing under "
                  f"{cfg.model_base_dir!r}"
                  + (f" for experiment_id={experiment_id!r}"
                     if experiment_id else ""))
        print(f"checkpoint={mode} -> {checkpoint}")
    if checkpoint is None:
        if not allow_random:
            _exit("no checkpoint given — pass checkpoint=<path>, "
                  "checkpoint=auto, or random_init=1 to deliberately run "
                  "with random weights")
        print("WARNING: no checkpoint given; using random initialisation")
        st = init_state(cfg, device=device)
        return st.params, st.model_state
    if checkpoint.endswith(".ckpt") or os.path.isfile(checkpoint + ".index"):
        if cfg.network == "unet":
            from waveunet_tpu_torch.compat.tf_checkpoint import (
                load_tf_waveunet)
            return load_tf_waveunet(checkpoint, cfg, device=device), {}
        from waveunet_tpu_torch.compat.tf_checkpoint import load_tf_spectrogram
        return load_tf_spectrogram(checkpoint, cfg, device=device)
    restored = ckpt.restore_checkpoint(checkpoint, map_location=device)
    return restored["params"], restored.get("model_state", {})


def _resolve_auto_checkpoint(cfg, experiment_id):
    from waveunet_tpu_torch.train.checkpoint import latest_checkpoint

    if experiment_id:
        return latest_checkpoint(cfg.model_base_dir, experiment_id)
    if not os.path.isdir(cfg.model_base_dir):
        return None
    best, best_mtime = None, -1.0
    for exp in os.listdir(cfg.model_base_dir):
        path = latest_checkpoint(cfg.model_base_dir, exp)
        if path is not None:
            mtime = os.path.getmtime(path)
            if mtime > best_mtime:
                best, best_mtime = path, mtime
    return best


def _resolve_best_checkpoint(cfg, experiment_id):
    """The checkpoint ``<experiment>/best.txt`` names; without an
    experiment_id, that of the newest best.txt. None if the marker or the
    directory it names is gone: falling back to an older experiment's best
    would score the wrong weights without a word."""
    def read_marker(exp):
        marker = os.path.join(cfg.model_base_dir, str(exp), "best.txt")
        if not os.path.isfile(marker):
            return None
        with open(marker) as f:
            path = f.read().strip()
        return path if path and os.path.isdir(path) else None

    if experiment_id:
        return read_marker(experiment_id)
    if not os.path.isdir(cfg.model_base_dir):
        return None
    newest, newest_mtime = None, -1.0
    for exp in os.listdir(cfg.model_base_dir):
        marker = os.path.join(cfg.model_base_dir, exp, "best.txt")
        if os.path.isfile(marker):
            mtime = os.path.getmtime(marker)
            if mtime > newest_mtime:
                newest, newest_mtime = exp, mtime
    return read_marker(newest) if newest is not None else None


def _resolve_zoo_tf_checkpoint(cfg, preset: str):
    """``Predict.py:10``'s default: the highest-step TF checkpoint of the
    reference zoo's layout ``<model_base_dir>/<preset>/<preset>-<step>``,
    or None."""
    d = os.path.join(cfg.model_base_dir, preset)
    if not os.path.isdir(d):
        return None
    best = None
    for f in os.listdir(d):
        if f.endswith(".index") and "-" in f:
            stem = f[:-len(".index")]
            try:
                step = int(stem.rsplit("-", 1)[1])
            except ValueError:
                continue
            if best is None or step > best[0]:
                best = (step, os.path.join(d, stem))
    return best[1] if best else None


def cmd_predict(args, device):
    from waveunet_tpu_torch.infer.engine import separate_file

    cfg_frags, opts = _split_args(args)
    cfg = _config(cfg_frags)
    if "input_path" not in opts:
        _exit("predict requires input_path=<audio file>")
    n_proc = _maybe_init_pod(opts, device)
    dev = device.get()
    mesh = None
    if n_proc > 1:
        from waveunet_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(devices=[dev])
    checkpoint = opts.get("checkpoint")
    if checkpoint is None and not _random_ok(opts):
        preset = next((a for a in cfg_frags if "=" not in a), "baseline")
        zoo = _resolve_zoo_tf_checkpoint(cfg, preset)
        if zoo is not None:
            print(f"no checkpoint given; using zoo checkpoint {zoo} "
                  f"(reference Predict.py default)")
            checkpoint = zoo
    params, model_state = _load_params(cfg, checkpoint,
                                       opts.get("experiment_id", ""),
                                       allow_random=_random_ok(opts),
                                       device=dev)
    written = separate_file(cfg, params, opts["input_path"],
                            output_path=opts.get("output_path"), device=dev,
                            model_state=model_state, mesh=mesh)
    for name, p in written.items():
        print(f"{name}: {p}")


def cmd_evaluate(args, device):
    cfg_frags, opts = _split_args(args)
    cfg = _config(cfg_frags)
    _maybe_init_pod(opts, device)
    _dataset_eval(cfg, opts, opts.get("checkpoint"),
                  opts.get("subset", "test"),
                  opts.get("output_path", cfg.estimates_path), device.get())


def cmd_prepare_data(args, _device):
    from waveunet_tpu_torch.data import cache
    from waveunet_tpu_torch.ops import shapes

    cfg_frags, _ = _split_args(args)
    cfg = _config(cfg_frags)
    cache.prepare_dataset(cfg, shapes.context_pad(cfg, cfg.num_frames))
    print(f"Cache ready at {cache.cache_dir(cfg)}")


def _test_song(cfg, seconds: float = 30.0) -> np.ndarray:
    sr = cfg.expected_sr
    t = np.arange(int(seconds * sr)) / sr
    song = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)[:, None]
    return np.tile(song, [1, 2]) if cfg.num_channels == 2 else song


def cmd_profile(args, device):
    """A ``torch.profiler`` trace of one 30 s separation (after a warm-up
    one), written as a Chrome trace into ``output_path``; then the
    program's spans (count, total and self ms) and counters of that
    separation (``tracing.py``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from waveunet_tpu_torch import tracing
    from waveunet_tpu_torch.infer.engine import Separator

    cfg_frags, opts = _split_args(args)
    cfg = _config(cfg_frags)
    dev = device.get()
    params, model_state = _load_params(cfg, opts.get("checkpoint"),
                                       opts.get("experiment_id", ""),
                                       allow_random=True, device=dev)
    sep = Separator(cfg, params, model_state=model_state, device=dev)
    song = _test_song(cfg)
    sep.separate(song, cfg.expected_sr)  # kernels built outside the trace
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    out_dir = opts.get("output_path", os.path.join(cfg.log_dir, "profile"))
    os.makedirs(out_dir, exist_ok=True)
    tracing.reset()
    with profile(activities=activities) as prof:
        sep.separate(song, cfg.expected_sr)
    path = os.path.join(out_dir, "separate_trace.json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path} (chrome://tracing or Perfetto)")
    rec = tracing.record()
    for name, (n, total, own) in sorted(rec["spans"].items()):
        print(f"  span {name}: {n} x, total {1e3 * total:.3f} ms, self "
              f"{1e3 * own:.3f} ms")
    for name, n in sorted(rec["counters"].items()):
        print(f"  counter {name}: {n}")


def cmd_warmup(args, device):
    """Capture the serving CUDA graphs of every chunk size (``precompile``),
    the port's counterpart of filling the XLA cache: it needs the card."""
    from waveunet_tpu_torch.infer.engine import Separator

    cfg_frags, opts = _split_args(args)
    cfg = _config(cfg_frags)
    dev = device.get()
    if dev.type != "cuda":
        _exit("warmup captures CUDA graphs and needs the card; on the CPU "
              "there is nothing to compile")
    params, model_state = _load_params(cfg, opts.get("checkpoint"),
                                       opts.get("experiment_id", ""),
                                       allow_random=True, device=dev)
    sep = Separator(cfg, params, model_state=model_state, device=dev)
    n = sep.precompile(max_song_s=float(opts.get("max_song_s", 6 * 60.0)),
                       progress=lambda s: print(s, flush=True))
    print(f"warmup complete; {n} CUDA graphs captured")


def cmd_stream(args, device):
    """Feed an audio file through the streaming separator in fixed-size
    chunks, write stems, report throughput and latency:
    stream <preset> input_path=<audio> [chunk_ms=500] [batch_windows=8]."""
    import time

    from waveunet_tpu_torch.data.audio_io import load, write_wav
    from waveunet_tpu_torch.infer.streaming import StreamingSeparator

    cfg_frags, opts = _split_args(args)
    cfg = _config(cfg_frags)
    if "input_path" not in opts:
        _exit("stream requires input_path=<audio file>")
    dev = device.get()
    params, model_state = _load_params(cfg, opts.get("checkpoint"),
                                       opts.get("experiment_id", ""),
                                       allow_random=_random_ok(opts),
                                       device=dev)
    audio, _sr = load(opts["input_path"], sr=cfg.expected_sr,
                      mono=cfg.mono_downmix)
    if not cfg.mono_downmix and audio.shape[1] == 1:
        audio = np.tile(audio, [1, 2])
    chunk = max(1, int(float(opts.get("chunk_ms", "500"))
                       * cfg.expected_sr / 1000))
    stream = StreamingSeparator(cfg, params,
                                batch_windows=int(opts.get("batch_windows",
                                                           "8")),
                                model_state=model_state, device=dev)
    # build the kernels and warm the allocator outside the timed run
    stream.push(np.zeros((chunk, audio.shape[1]), np.float32))
    stream.flush()
    stream.reset()
    outs = {s: [] for s in cfg.source_names}
    t0 = time.perf_counter()
    for i in range(0, audio.shape[0], chunk):
        for s, v in stream.push(audio[i:i + chunk]).items():
            outs[s].append(v)
    for s, v in stream.flush().items():
        outs[s].append(v)
    dt = time.perf_counter() - t0
    seconds = audio.shape[0] / cfg.expected_sr
    print(f"streamed {seconds:.1f} s in {dt:.2f} s "
          f"({seconds / dt:.1f} audio-s/s warm; algorithmic latency "
          f"{stream.latency_samples / cfg.expected_sr * 1000:.0f} ms)")
    folder, fname = os.path.split(opts["input_path"])
    out_dir = opts.get("output_path") or folder or "."
    os.makedirs(out_dir, exist_ok=True)
    for s, v in outs.items():
        path = os.path.join(out_dir, f"{fname}_{s}_stream.wav")
        write_wav(path, np.concatenate(v), cfg.expected_sr)
        print(f"{s}: {path}")


def cmd_convert_checkpoint(args, device):
    """A reference TF checkpoint -> the port's checkpoint, with fresh Adam
    slots: convert-checkpoint <preset> checkpoint=<tf ckpt>
    [output_path=dir]."""
    from waveunet_tpu_torch.train import checkpoint as ckpt
    from waveunet_tpu_torch.train.step import make_optimizer

    cfg_frags, opts = _split_args(args)
    cfg = _config(cfg_frags)
    if "checkpoint" not in opts:
        _exit("convert-checkpoint requires checkpoint=<tf ckpt path>")
    dev = device.get()
    if cfg.network == "unet":
        from waveunet_tpu_torch.compat.tf_checkpoint import load_tf_waveunet
        params = load_tf_waveunet(opts["checkpoint"], cfg, device=dev)
        model_state = {}
    else:
        from waveunet_tpu_torch.compat.tf_checkpoint import load_tf_spectrogram
        params, model_state = load_tf_spectrogram(opts["checkpoint"], cfg,
                                                  device=dev)
    out_dir = opts.get("output_path", cfg.model_base_dir)
    path = ckpt.save_checkpoint(out_dir, "converted", 0, {
        "params": params, "model_state": model_state,
        "opt_state": make_optimizer(cfg.init_sup_sep_lr).init(params),
        "step": 0})
    print(f"converted checkpoint written to {path}")


def cmd_figures(args, device):
    """The reference's ``Plot.py`` figures:
    figures results_dir=<eval JSON dir> [output_path=out.pdf]  -> SDR violin
    figures input_path=<audio file> [output_path=out.png]      -> spectrogram
    """
    cfg_frags, opts = _split_args(args)
    if cfg_frags:
        _exit(f"figures: unknown arguments {cfg_frags} (takes results_dir=, "
              "input_path=, output_path=)")
    if "results_dir" not in opts and "input_path" not in opts:
        _exit("figures requires results_dir=<eval JSON dir> (SDR violin) "
              "and/or input_path=<audio file> (spectrogram)")
    from waveunet_tpu_torch.eval import plot

    wrote = []
    try:
        if "results_dir" in opts:
            wrote.append(plot.draw_violin_sdr(
                opts["results_dir"],
                out_path=opts.get("output_path", "sdr_violin.pdf")))
        if "input_path" in opts:
            out = opts.get("output_path") if "results_dir" not in opts \
                else None
            wrote.append(plot.draw_spectrogram(opts["input_path"],
                                               out_path=out,
                                               device=device.get()))
    except ImportError as e:
        _exit(f"figures: {e}")
    for p in wrote:
        print(f"figure written to {p}")


_COMMANDS = {
    "train": cmd_train,
    "warmup": cmd_warmup,
    "convert-checkpoint": cmd_convert_checkpoint,
    "predict": cmd_predict,
    "stream": cmd_stream,
    "evaluate": cmd_evaluate,
    "prepare-data": cmd_prepare_data,
    "presets": cmd_presets,
    "profile": cmd_profile,
    "figures": cmd_figures,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in _COMMANDS:
        print(__doc__)
        sys.exit(0 if argv and argv[0] in ("-h", "--help") else 2)
    import torch.distributed as dist

    from waveunet_tpu_torch.config import ConfigError
    rest, device = _apply_platform(argv[1:])
    grouped = dist.is_initialized()
    try:
        _COMMANDS[argv[0]](rest, device)
    except ConfigError as e:
        # unknown preset or bad override: the message, not a traceback
        _exit(str(e))
    finally:
        if not grouped and dist.is_initialized():  # a pod command's group
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
