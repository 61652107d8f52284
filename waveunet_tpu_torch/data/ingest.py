"""Dataset ingest: MUSDB18 as pre-extracted WAVs, and the CCMixter manifest.

The port's counterpart of the WAV path of ``waveunet_tpu/data/ingest.py``.
A MUSDB tree in the musdb "is_wav" layout,
``<root>/{train,test}/<song>/{mixture,bass,drums,other,vocals}.wav``, needs
no decoder: each track's accompaniment is synthesised once as
clip(sum of the non-vocal stems), with the mixture's additivity printed. A
voice-task layout of ``mixture``, ``vocals`` and ``accompaniment`` WAVs
reads as it is. Decoding ``.stem.mp4`` files through the ``musdb`` package
and ffmpeg is not ported.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from waveunet_tpu_torch.data.audio_io import load, write_wav

_STEMS = ("bass", "drums", "other", "vocals")


def _ingest_wav_track(track_dir: str) -> Dict[str, str]:
    """Sample paths of one pre-decoded track directory; writes
    ``accompaniment.wav`` when it is missing and the stems are there."""
    paths = {}
    mix_src = os.path.join(track_dir, "mixture.wav")
    if not os.path.exists(mix_src):
        raise FileNotFoundError(f"{track_dir}: no mixture.wav")
    paths["mix"] = mix_src
    have_stems = True
    for stem in _STEMS:
        p = os.path.join(track_dir, f"{stem}.wav")
        if os.path.exists(p):
            paths[stem] = p
        elif stem == "vocals":
            raise FileNotFoundError(f"{track_dir}: missing stem vocals")
        else:
            have_stems = False  # voice-task layout: vocals + accompaniment

    acc_path = os.path.join(track_dir, "accompaniment.wav")
    if not os.path.exists(acc_path) and not have_stems:
        raise FileNotFoundError(
            f"{track_dir}: needs accompaniment.wav or bass/drums/other stems")
    if not os.path.exists(acc_path):
        stems = {s: load(paths[s], sr=None, mono=False)[0] for s in _STEMS}
        mix_audio, sr = load(paths["mix"], sr=None, mono=False)
        acc = np.clip(sum(stems[s] for s in _STEMS if s != "vocals"),
                      -1.0, 1.0)
        write_wav(acc_path, acc, sr)
        n = min(mix_audio.shape[0], acc.shape[0], stems["vocals"].shape[0])
        diff = np.abs(mix_audio[:n] - acc[:n] - stems["vocals"][:n])
        print(f"Additivity check {os.path.basename(track_dir)}: "
              f"max={diff.max():.4f} mean={diff.mean():.6f}")
    paths["accompaniment"] = acc_path
    return paths


def get_musdb(database_path: str) -> Tuple[List[Dict[str, str]],
                                           List[Dict[str, str]]]:
    """(train_samples, test_samples) of a MUSDB tree in the WAV layout; each
    sample maps the source names and "mix" to WAV paths. Tracks missing a
    file are skipped with a warning."""
    if not all(os.path.isdir(os.path.join(database_path, part))
               for part in ("train", "test")):
        raise RuntimeError(
            f"MUSDB not found at {database_path!r} in the WAV layout "
            f"(<root>/train|test/<song>/mixture.wav ...); decoding stems "
            f"through musdb and ffmpeg is not ported")
    subsets = []
    for part in ("train", "test"):
        part_dir = os.path.join(database_path, part)
        samples = []
        for song in sorted(os.listdir(part_dir)):
            track_dir = os.path.join(part_dir, song)
            if not os.path.isdir(track_dir):
                continue
            try:
                samples.append(_ingest_wav_track(track_dir))
            except FileNotFoundError as e:
                print(f"WARNING: skipping {track_dir}: {e}")
        subsets.append(samples)
    if not subsets[0]:
        raise RuntimeError(f"no usable track under {database_path!r}/train")
    return subsets[0], subsets[1]


def get_ccmixter(xml_path: str) -> List[Dict[str, str]]:
    """Parse the CCMixter XML manifest into {mix, accompaniment, vocals}
    paths; tracks without all three are left out."""
    import xml.etree.ElementTree as ET

    root = ET.parse(xml_path).getroot()
    db_path = root.findtext("./databaseFolderPath") or ""
    samples = []
    for track in root.iter("track"):
        by_name = {}
        for inst in track.iter("instrument"):
            name = inst.findtext("instrumentName")
            rel = inst.findtext("relativeFilepath")
            if name and rel:
                by_name[name] = os.path.join(db_path, rel)
        if {"Voice", "Mix", "Instrumental"} <= set(by_name):
            samples.append({"mix": by_name["Mix"],
                            "accompaniment": by_name["Instrumental"],
                            "vocals": by_name["Voice"]})
    return samples
