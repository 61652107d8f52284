"""A learnable synthetic MUSDB-layout dataset, and a streamed subprocess.

The port's own copy of the generator of ``tools/soak.py`` (``synth_song``,
``synth_song_multi``, ``build_db``, ``run_streamed``), writing through the
port's ``write_wav``: production-shaped songs (stereo 44.1 kHz, minutes
long, decoded-WAV MUSDB layout ``<db>/<train|test>/<song>/<stem>.wav``)
with enough structure for a separator to learn, and the same draws from
the same seed, so both packages write the same files.
"""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np

from waveunet_tpu_torch.data.audio_io import write_wav

# the checkout holding the package: where ``python -m waveunet_tpu_torch``
# resolves
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_streamed(cmd, t0=None, check=True) -> int:
    """Run ``cmd`` from the checkout, echoing every output line with an
    elapsed-seconds prefix. Raises on a non-zero exit when ``check``;
    returns the exit code otherwise."""
    print("+ " + " ".join(cmd), flush=True)
    t0 = time.time() if t0 is None else t0
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO)
    for line in proc.stdout:
        print(f"[{time.time() - t0:8.1f}s] {line}", end="", flush=True)
    rc = proc.wait()
    if check and rc != 0:
        raise RuntimeError(f"{' '.join(cmd[:4])} ... failed rc={rc}")
    return rc


def _stereo(x: np.ndarray, delay: int = 23) -> np.ndarray:
    """Slight stereo decorrelation: the right channel a delayed blend."""
    r = np.roll(x, delay)
    r[:delay] = 0.0
    return np.stack([x, 0.9 * r + 0.1 * x], axis=1)


def synth_song(rng, seconds: int, sr: int):
    """Musical-ish stereo stems: vocals = harmonic tone with vibrato and an
    envelope, accompaniment = chord pad + filtered noise."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = rng.uniform(180.0, 360.0)
    vib = 1.0 + 0.01 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
    voc = np.zeros(n, np.float32)
    for h, a in ((1, 0.5), (2, 0.25), (3, 0.12)):
        voc += a * np.sin(2 * np.pi * f0 * h * vib * t
                          + rng.uniform(0, 2 * np.pi))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(0.1, 0.4) * t))
    voc = (0.35 * voc * env).astype(np.float32)
    acc = np.zeros(n, np.float32)
    root = rng.uniform(80.0, 140.0)
    for ratio in (1.0, 1.25, 1.5):
        acc += 0.2 * np.sin(2 * np.pi * root * ratio * t
                            + rng.uniform(0, 2 * np.pi))
    noise = rng.standard_normal(n).astype(np.float32)
    kernel = np.ones(64, np.float32) / 64.0
    acc += 0.08 * np.convolve(noise, kernel, mode="same")
    acc = (0.35 * acc).astype(np.float32)
    return _stereo(voc), _stereo(acc)


def synth_song_multi(rng, seconds: int, sr: int):
    """Four spectrally separable stems for the multi_instrument task: bass
    = low fundamental with a slow envelope, drums = tempo-locked decaying
    noise bursts, other = chord pad, vocals = the voice task's harmonic
    tone. Returns {stem: [n, 2]}."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    voc, pad = synth_song(rng, seconds, sr)

    f_bass = rng.uniform(50.0, 90.0)
    env_b = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
    bass = 0.28 * env_b * (np.sin(2 * np.pi * f_bass * t)
                           + 0.3 * np.sin(2 * np.pi * 2 * f_bass * t))
    bass = _stereo(bass.astype(np.float32), delay=11)

    bpm = rng.uniform(90.0, 140.0)
    period = int(sr * 60.0 / bpm)
    hit = np.zeros(n, np.float32)
    decay = np.exp(-np.arange(min(period, int(0.08 * sr))) / (0.015 * sr))
    for start in range(0, n, period):
        burst = rng.standard_normal(decay.shape[0]).astype(np.float32) * decay
        end = min(n, start + burst.shape[0])
        hit[start:end] += burst[:end - start]
    drums = _stereo((0.22 * hit).astype(np.float32), delay=5)

    stems = {"bass": bass, "drums": drums,
             "other": (0.7 * pad).astype(np.float32), "vocals": voc}
    # keep the written mixture inside int16 range: the ingest's additivity
    # check needs mixture == sum(stems) after quantisation
    peak = float(np.abs(sum(stems.values())).max())
    if peak > 0.95:
        stems = {k: (0.95 / peak) * v for k, v in stems.items()}
    return stems


def build_db(db_dir: str, sr: int, train_songs: int, test_songs: int,
             seconds: int, task: str = "voice") -> None:
    """Write ``train_songs`` and ``test_songs`` synthesised songs of
    ``seconds`` each as 16-bit WAVs in the MUSDB decoded layout."""
    rng = np.random.default_rng(2026)
    for part, n_songs in (("train", train_songs), ("test", test_songs)):
        for i in range(n_songs):
            d = os.path.join(db_dir, part, f"song{i}")
            os.makedirs(d, exist_ok=True)
            if task == "multi_instrument":
                stems = synth_song_multi(rng, seconds, sr)
            else:
                voc, acc = synth_song(rng, seconds, sr)
                stems = {"vocals": voc, "accompaniment": acc}
            mix = np.zeros_like(next(iter(stems.values())))
            for name, audio in stems.items():
                write_wav(os.path.join(d, f"{name}.wav"), audio, sr)
                mix = mix + audio
            write_wav(os.path.join(d, "mixture.wav"), mix, sr)
            print(f"  wrote {part}/song{i} ({seconds}s stereo @ {sr} Hz, "
                  f"{len(stems)} stems)", flush=True)
