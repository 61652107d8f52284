"""Trained quality: train through the product's training loop, score with
BSS-Eval v4, and write the SDR table.

The port's counterpart of ``tools/quality.py``, step for step:

  1. synthesise a MUSDB-layout set (``tools/synth.py``; the JAX package's
     generator and seed);
  2. ``python -m waveunet_tpu_torch train <preset> ... worse_epochs=N
     checkpoint=auto``: the product loop, to early stop over its two
     rounds (the second at twice the batch and lr 1e-5);
  3. ``python -m waveunet_tpu_torch evaluate <preset> checkpoint=best``:
     the best-validation checkpoint through the whole harness;
  4. the mixture-as-estimate baseline (every source estimated by the
     mixture) scored on the same tracks, for the delta column;
  5. the table on stdout and a JSON artifact in the JAX tool's schema,
     with the card's ``nvidia-smi`` name and power limit added.

Usage (from the checkout):

    python -m waveunet_tpu_torch.tools.quality            # on the card
    python -m waveunet_tpu_torch.tools.quality --max-epochs 12 \\
        --out /tmp/quality_synth_torch.json
    python -m waveunet_tpu_torch.tools.quality --root /tmp/q --train-songs 2 \\
        --test-songs 1 --num-val-songs 1 --seconds 6 --epoch-it 3 \\
        --worse-epochs 1 --max-epochs 1 platform=cpu num_layers=3 ...

Fragments after the options (``key=value``) reach both ``train`` and
``evaluate``: an architecture override must match the checkpoint trained
with it. Both the model and the baseline are scored by the host fp64
scorer (``eval/bsseval.py``), as the TPU artifact was.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

from waveunet_tpu_torch.tools.synth import REPO, build_db, run_streamed

SCORING = ("in-repo BSS-Eval v4, host fp64, 1 s windows "
           "(waveunet_tpu_torch/eval/bsseval.py)")


def _score_mixture(cfg, name, mix, rate, targets, results_dir):
    from waveunet_tpu_torch.eval.harness import _score_and_write

    preds = {s: mix for s in targets}
    _score_and_write(cfg, name, mix.shape[0], rate, targets, preds,
                     results_dir, None, win_s=1.0)


def mixture_baseline(cfg, db: str, results_dir: str) -> None:
    """Score est_s = mixture for every source: the no-separation floor the
    trained model's SDR is read against; one spawned process a track."""
    from waveunet_tpu_torch.eval.harness import iter_tracks

    os.makedirs(results_dir, exist_ok=True)
    tracks = list(iter_tracks(db, "test"))
    workers = max(1, min(len(tracks), os.cpu_count() or 1, 8))
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=mp.get_context("spawn")) as pool:
        futures = [pool.submit(_score_mixture, cfg, name, mix, rate, targets,
                               results_dir)
                   for name, mix, rate, targets in tracks]
        for f in futures:
            f.result()


def aggregate(results_dir: str):
    """{source: {metric: median, MAD, mean, SD}} over the track JSONs,
    rounded as the JAX tool rounds them."""
    from waveunet_tpu_torch.eval.aggregate import compute_mean_metrics

    out = {}
    for metric in ("SDR", "ISR", "SIR", "SAR"):
        stats, names = compute_mean_metrics(results_dir, metric=metric,
                                            return_names=True)
        for n, (median, mad, mean, sd) in zip(names, stats):
            out.setdefault(n, {})[metric] = {
                "median": round(float(median), 2),
                "MAD": round(float(mad), 2),
                "mean": round(float(mean), 2),
                "SD": round(float(sd), 2)}
    return out


def card_line(platform: str):
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line, or None
    on the CPU or where nvidia-smi is absent."""
    if platform == "cpu":
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m waveunet_tpu_torch.tools.quality")
    ap.add_argument("--root", default=os.path.join(REPO, ".quality_torch"))
    ap.add_argument("--train-songs", type=int, default=12)
    ap.add_argument("--test-songs", type=int, default=4)
    ap.add_argument("--num-val-songs", type=int, default=2)
    ap.add_argument("--seconds", type=int, default=60)
    ap.add_argument("--epoch-it", type=int, default=500)
    ap.add_argument("--worse-epochs", type=int, default=3)
    ap.add_argument("--max-epochs", type=int, default=None,
                    help="cap of epochs per round (default: none, run to "
                         "early stop)")
    ap.add_argument("--preset", default="full_44KHz")
    ap.add_argument("--out", default=None,
                    help="artifact path (default "
                         "docs/quality_synth_torch.json, with the preset's "
                         "suffix for other presets)")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("extra", nargs="*", help="extra key=value CLI fragments")
    args = ap.parse_args(argv)

    from waveunet_tpu_torch.config import get_config

    task = get_config(args.preset).task
    db_sfx = "_multi" if task == "multi_instrument" else ""
    sfx = {"full_44KHz": "", "full_multi_instrument": "_multi"}.get(
        args.preset, "_" + args.preset)
    if args.out is None:
        args.out = os.path.join(REPO, "docs",
                                f"quality_synth{sfx}_torch.json")
    platform = next((a.split("=", 1)[1].lower() for a in args.extra
                     if a.startswith("platform=")), "cuda")

    if args.fresh and os.path.isdir(args.root):
        shutil.rmtree(args.root)
    db = os.path.join(args.root, f"db{db_sfx}")
    t0 = time.time()
    if not os.path.isdir(db):
        print(f"Synthesizing quality dataset at {db} ({task}) ...",
              flush=True)
        build_db(db, 44100, args.train_songs, args.test_songs, args.seconds,
                 task=task)
    synth_wall = round(time.time() - t0, 1)

    common = [args.preset,
              f"musdb_path={db}",
              f"data_path={os.path.join(args.root, 'cache' + sfx)}",
              f"model_base_dir={os.path.join(args.root, 'ckpts' + sfx)}",
              f"log_dir={os.path.join(args.root, 'logs' + sfx)}",
              f"estimates_path={os.path.join(args.root, 'estimates' + sfx)}",
              f"num_val_songs={args.num_val_songs}",
              f"experiment_id=quality{sfx}"]
    cli = [sys.executable, "-m", "waveunet_tpu_torch"]
    train_wall = None
    if not args.skip_train:
        t_train = time.time()
        run_streamed(cli + ["train"] + common
                     + [f"epoch_it={args.epoch_it}",
                        f"worse_epochs={args.worse_epochs}",
                        "checkpoint=auto"]
                     + ([f"max_epochs={args.max_epochs}"]
                        if args.max_epochs else [])
                     + list(args.extra), t0)
        train_wall = round(time.time() - t_train, 1)

    # checkpoint=best: early stopping's best-validation model, not the
    # newest step, which sat through worse_epochs regressions
    t_eval = time.time()
    run_streamed(cli + ["evaluate"] + common + ["checkpoint=best"]
                 + list(args.extra), t0)
    eval_wall = round(time.time() - t_eval, 1)

    print("Scoring the mixture-as-estimate baseline ...", flush=True)
    t_base = time.time()
    cfg = get_config(args.preset, musdb_path=db)
    base_dir = os.path.join(args.root, "baseline_mixture" + sfx)
    mixture_baseline(cfg, db, base_dir)
    baseline_wall = round(time.time() - t_base, 1)

    model_stats = aggregate(os.path.join(args.root, "estimates" + sfx,
                                         "test"))
    base_stats = aggregate(base_dir)
    table = {
        "dataset": {"kind": "synthetic (waveunet_tpu_torch/tools/synth.py, "
                            "tools/soak.py's generator)",
                    "train_songs": args.train_songs,
                    "valid_songs": args.num_val_songs,
                    "test_songs": args.test_songs,
                    "song_seconds": args.seconds, "sr": 44100,
                    "channels": 2},
        "preset": args.preset,
        "task": task,
        "regime": {"epoch_it": args.epoch_it,
                   "worse_epochs": args.worse_epochs,
                   "max_epochs_per_round": args.max_epochs,
                   "rounds": 2, "train_wall_s": train_wall,
                   "synth_wall_s": synth_wall, "eval_wall_s": eval_wall,
                   "baseline_wall_s": baseline_wall,
                   "extra": list(args.extra)},
        "scoring": SCORING,
        "device": {"platform": "cpu" if platform == "cpu" else "gpu",
                   "nvidia_smi": card_line(platform)},
        "model": model_stats,
        "mixture_baseline": base_stats,
        "delta_sdr_median": {
            s: round(model_stats[s]["SDR"]["median"]
                     - base_stats[s]["SDR"]["median"], 2)
            for s in model_stats if s in base_stats},
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)

    print("\n== Quality table (SDR median dB, model vs mixture baseline) ==")
    for s in model_stats:
        m = model_stats[s]["SDR"]["median"]
        b = base_stats.get(s, {}).get("SDR", {}).get("median")
        print(f"  {s}: {m:+.2f} (mixture {b:+.2f}, "
              f"delta {table['delta_sdr_median'][s]:+.2f})")
    print(f"artifact: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
