"""MUSDB evaluation harness: separation on the card -> BSS-Eval v4 -> JSON.

The port's counterpart of ``waveunet_tpu/eval/harness.py`` (itself the
reference's ``produce_musdb_source_estimates`` and ``predict``,
``Evaluate.py:16-80,147-159``): iterate MUSDB test tracks, separate each with
the port's ``Separator`` (one engine for every track), resample the
estimates back to the track's rate, score SDR/ISR/SIR/SAR framewise and
write per-track JSONs that both packages' aggregation reads.

Tracks come from a decoded-WAV layout ``<root>/{train,test}/<song>/
{mixture,vocals,...}.wav``, or from the ``musdb`` package (stems) where it is
installed. Scoring runs in a pool of ``spawn`` worker processes (the host
fp64 scorer), or in one thread beside the separation (the device scorers,
which share the card with it). A worker imports this module and only scores
numpy arrays: importing it starts no CUDA context and builds no kernel.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.data.audio_io import load, write_wav
from waveunet_tpu_torch.device import DeviceLike, refuse_multi_gpu
from waveunet_tpu_torch.eval.aggregate import (compute_mean_metrics,
                                               write_track_json)
from waveunet_tpu_torch.eval.bsseval import bss_eval_framewise
from waveunet_tpu_torch.ops.resample import resample

_EVAL_TARGETS = {
    "voice": ("vocals", "accompaniment"),
    "multi_instrument": ("vocals", "drums", "bass", "other"),
}


def iter_tracks(musdb_path: str, subset: str, skip=None
                ) -> Iterator[Tuple[str, np.ndarray, int, Dict[str, np.ndarray]]]:
    """Yields (name, mixture [n, ch], rate, {target: [n, ch]}).

    ``skip(name) -> bool`` short-circuits BEFORE any audio decode and yields
    ``(name, None, None, None)``: resuming a mostly scored dataset must not
    decode the tracks already scored."""
    part_dir = os.path.join(musdb_path, subset)
    if os.path.isdir(part_dir):  # decoded-WAV layout
        for song in sorted(os.listdir(part_dir)):
            d = os.path.join(part_dir, song)
            mix_p = os.path.join(d, "mixture.wav")
            if not os.path.isfile(mix_p):
                continue
            if skip is not None and skip(song):
                yield song, None, None, None
                continue
            mix, sr = load(mix_p, sr=None, mono=False)
            targets = {}
            for t in ("vocals", "drums", "bass", "other", "accompaniment"):
                p = os.path.join(d, f"{t}.wav")
                if os.path.isfile(p):
                    targets[t] = load(p, sr=None, mono=False)[0]
            if ("accompaniment" not in targets
                    and {"drums", "bass", "other"} <= set(targets)):
                targets["accompaniment"] = np.clip(
                    targets["drums"] + targets["bass"] + targets["other"],
                    -1.0, 1.0)
            yield song, mix, sr, targets
        return

    try:
        import musdb  # type: ignore  # stems layout fallback
    except ImportError as e:
        raise ImportError(
            f"{part_dir!r} is not a directory of decoded WAVs "
            f"(<song>/mixture.wav, ...), and reading MUSDB stems needs the "
            f"musdb package, which is not installed") from e

    mus = musdb.DB(root=musdb_path, subsets=[subset])
    for track in mus.tracks:
        if skip is not None and skip(track.name):
            yield track.name, None, None, None
            continue
        targets = {name: tgt.audio for name, tgt in track.targets.items()}
        yield track.name, track.audio, track.rate, targets


def separate_track(sep, cfg: Config, mix: np.ndarray, rate: int
                   ) -> Dict[str, np.ndarray]:
    """Separate, resample back and re-tile channels (``Evaluate.py:61-67``):
    numpy estimates of the mixture's length and channel count."""
    preds = sep.separate(mix, rate)
    out = {}
    for name, est in preds.items():
        est = resample(est, cfg.expected_sr, rate)[:mix.shape[0]]
        if est.shape[0] < mix.shape[0]:
            est = np.pad(est, [(0, mix.shape[0] - est.shape[0]), (0, 0)])
        if cfg.mono_downmix and mix.shape[1] > 1:
            est = np.tile(est, [1, mix.shape[1]])
        elif est.shape[1] > mix.shape[1]:
            # a stereo model fed a mono track: the engine duplicated the
            # channel, so downmix the estimate back to the track's count
            est = np.mean(est, axis=1, keepdims=True)
        out[name] = est
    return out


def stack_sources(cfg: Config, targets: Dict[str, np.ndarray],
                  preds: Dict[str, np.ndarray], mix_len: int
                  ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """(scored source names, references [S, n, C], estimates [S, n, C]):
    the task's targets present in both, references cut or zero-padded to
    the mixture's length (stems can differ from it by a codec frame)."""
    eval_names = [s for s in _EVAL_TARGETS[cfg.task]
                  if s in preds and s in targets]

    def fit(x):
        x = x[:mix_len]
        if x.shape[0] < mix_len:
            x = np.pad(x, [(0, mix_len - x.shape[0]), (0, 0)])
        return x

    refs = np.stack([fit(targets[s]) for s in eval_names])
    ests = np.stack([preds[s] for s in eval_names])
    return eval_names, refs, ests


def _bss_eval(refs: np.ndarray, ests: np.ndarray, rate: int, win_s: float,
              tpu_bss=False, device: DeviceLike = None
              ) -> Dict[str, np.ndarray]:
    """Framewise metrics. ``tpu_bss``: False, the ``museval`` package where
    it is installed (the reference's scorer, ``Evaluate.py:71``), else the
    host fp64 scorer (``eval/bsseval.py``); True or "fp32", the batched fp32
    device scorer with its two-ridge gate (``eval/bsseval_tpu.py``); "f64",
    the fp64 device scorer (``eval/bsseval_tpu64.py``: the host algorithm
    with the exact assembly)."""
    if isinstance(tpu_bss, str) and tpu_bss == "f64":
        from waveunet_tpu_torch.eval.bsseval_tpu64 import (
            bss_eval_framewise_tpu64)
        return bss_eval_framewise_tpu64(refs, ests, rate, win_s=win_s,
                                        hop_s=win_s, device=device)
    if tpu_bss:
        from waveunet_tpu_torch.eval.bsseval_tpu import (
            bss_eval_framewise_tpu)
        return bss_eval_framewise_tpu(refs, ests, rate, win_s=win_s,
                                      hop_s=win_s, device=device)
    try:
        import museval.metrics as mm  # type: ignore

        sdr, isr, sir, sar, _ = mm.bss_eval(
            refs, ests, window=int(win_s * rate), hop=int(win_s * rate),
            framewise_filters=False, bsseval_sources_version=False)
        return {"SDR": sdr, "ISR": isr, "SIR": sir, "SAR": sar}
    except ImportError:
        return bss_eval_framewise(refs, ests, rate, win_s=win_s, hop_s=win_s)


def _score_and_write(cfg, name, mix_len, rate, targets, preds, results_dir,
                     estimates_dir, win_s, tpu_bss=False, device=None):
    eval_names, refs, ests = stack_sources(cfg, targets, preds, mix_len)
    res = _bss_eval(refs, ests, rate, win_s, tpu_bss, device)
    per_target = {s: {k: res[k][i] for k in res}
                  for i, s in enumerate(eval_names)}
    if results_dir is not None:
        write_track_json(os.path.join(results_dir, f"{name}.json"), name,
                         per_target, win=win_s, hop=win_s)
    if estimates_dir is not None:
        d = os.path.join(estimates_dir, name)
        os.makedirs(d, exist_ok=True)
        for s, est in preds.items():
            write_wav(os.path.join(d, f"{s}.wav"), est, rate)
    med = {s: float(np.nanmedian(m["SDR"])) for s, m in per_target.items()}
    print(f"  {name} median SDR: {med}")
    return per_target


def aggregate_and_print(results_dir: str):
    """Aggregate every per-track JSON under ``results_dir`` and print the
    reference's summary table (``Evaluate.py:195-231`` statistics)."""
    stats, names = compute_mean_metrics(results_dir, return_names=True)
    for name, (median, mad, mean, sd) in zip(names, stats):
        print(f"{name}: SDR median {median:.2f} (MAD {mad:.2f}) "
              f"mean {mean:.2f} (SD {sd:.2f})")
    return stats


def self_check_separator(cfg: Config, sep, seconds: float = 2.0) -> None:
    """The estimates-contract check the reference makes with museval's
    ``mus.test(predict_fun)`` before a dataset run (``Evaluate.py:158``):
    separate a short random track and check source names, shapes, dtype,
    finiteness and peak, so a wiring fault fails in seconds and not after
    the first track. Raises RuntimeError."""
    rng = np.random.default_rng(0)
    n = int(seconds * cfg.expected_sr)
    audio = (0.1 * rng.standard_normal((n, 2))).astype(np.float32)
    preds = sep.separate(audio, cfg.expected_sr)
    problems = []
    if set(preds) != set(cfg.source_names):
        problems.append(f"source names {sorted(preds)} != "
                        f"{sorted(cfg.source_names)}")
    for name, est in preds.items():
        if est.shape != (n, cfg.num_channels):
            problems.append(f"{name}: shape {est.shape} != "
                            f"({n}, {cfg.num_channels})")
        if est.dtype != np.float32:
            problems.append(f"{name}: dtype {est.dtype} != float32")
        if not np.isfinite(est).all():
            problems.append(f"{name}: non-finite samples")
        elif np.abs(est).max() > 1.0 + 1e-6:
            problems.append(f"{name}: peak {np.abs(est).max():.3f} > 1")
    if problems:
        raise RuntimeError("separator self-check failed: "
                           + "; ".join(problems))


def evaluate_musdb(cfg: Config, params, model_state=None, mesh=None,
                   subset: str = "test", output_path: str = "estimates",
                   max_tracks: Optional[int] = None, win_s: float = 1.0,
                   tpu_bss=False,
                   scoring_workers: Optional[int] = None,
                   shard_index: int = 0, shard_count: int = 1,
                   aggregate: bool = True, self_check: bool = True,
                   device: DeviceLike = None):
    """Full-dataset evaluation; prints the aggregate table at the end and
    returns its statistics (None with ``aggregate=False``).

    Pipelined: while track i is scored, the card separates track i+1. The
    host fp64 scorer runs in a pool of ``scoring_workers`` spawned processes
    (default: the cores, at most 8; every outstanding track holds its
    full-length audio, which bounds host memory at about workers + 1
    tracks). ``tpu_bss`` True/"fp32" or "f64" scores on the card instead,
    in one thread beside the separation. A track whose JSON exists is
    skipped before its audio is decoded (delete the JSON to score it
    again). ``shard_index``/``shard_count`` stride the sorted track list,
    ``max_tracks`` counting every shard's tracks, so processes can score
    disjoint shards into one results folder and aggregate once
    (``aggregate=False`` leaves that to the caller). If a scoring worker
    dies, the remaining tracks are scored in-process.

    Runs on the card unless ``device="cpu"``; ``mesh`` is not ported."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from waveunet_tpu_torch.infer.engine import Separator

    refuse_multi_gpu(mesh)
    sep = Separator(cfg, params, model_state=model_state, device=device)
    if self_check:
        self_check_separator(cfg, sep)
    results_dir = os.path.join(output_path, subset)
    os.makedirs(results_dir, exist_ok=True)

    if tpu_bss:
        # the device scorers share the card with the separation
        pool = ThreadPoolExecutor(max_workers=1)
        cap = 2
    else:
        workers = scoring_workers or min(os.cpu_count() or 1, 8)
        # spawn: a forked child of a process holding a CUDA context cannot
        # use it, and the parent runs threads
        pool = ProcessPoolExecutor(max_workers=workers,
                                   mp_context=mp.get_context("spawn"))
        cap = workers + 1

    errors = []
    pending = []  # (args, future); bounded, each holds full-track audio
    pool_broken = False  # one dead worker breaks a ProcessPoolExecutor

    def _submit(args):
        nonlocal pool_broken
        if not pool_broken:
            try:
                pending.append((args, pool.submit(_score_and_write, *args)))
                return
            except Exception as e:  # BrokenProcessPool: every submit raises
                pool_broken = True
                print(f"scoring pool broken ({e}); "
                      f"scoring remaining tracks in-process")
        _score_inline(args)

    def _score_inline(args):
        try:
            _score_and_write(*args)
        except Exception as e:  # surface at the end, keep scoring
            errors.append((args[1], e))

    def _drain(limit):
        while len(pending) > limit:
            args, fut = pending.pop(0)
            try:
                fut.result()
                continue
            except Exception as e:
                # a worker crash loses its batch: rescore it here
                print(f"scoring worker failed for {args[1]} ({e}); "
                      f"rescoring in-process")
            _score_inline(args)

    def _scored(name):
        return os.path.exists(os.path.join(results_dir, f"{name}.json"))

    skip_state = {"i": -1, "why": ""}

    def _skip(name):
        skip_state["i"] += 1
        if skip_state["i"] % shard_count != shard_index:
            skip_state["why"] = (
                f"shard {skip_state['i'] % shard_count}/{shard_count}'s track")
            return True
        if _scored(name):
            skip_state["why"] = "already evaluated"
            return True
        return False

    count = 0
    try:
        for name, mix, rate, targets in iter_tracks(cfg.musdb_path, subset,
                                                    skip=_skip):
            if mix is None:
                print(f"Skipping {name} ({skip_state['why']})")
            else:
                print(f"Separating {name}...")
                preds = separate_track(sep, cfg, mix, rate)
                _submit((cfg, name, mix.shape[0], rate, targets, preds,
                         results_dir, output_path, win_s, tpu_bss,
                         sep.device if tpu_bss else None))
                _drain(cap)
            count += 1
            if max_tracks is not None and count >= max_tracks:
                break
        _drain(0)
    finally:
        pool.shutdown()
    for name, e in errors:
        print(f"WARNING: scoring failed for {name}: {e}")

    if not aggregate:
        return None
    return aggregate_and_print(results_dir)
