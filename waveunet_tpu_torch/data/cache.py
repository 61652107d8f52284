"""On-disk preprocessed dataset cache: one npz shard per song.

A copy of ``waveunet_tpu/data/cache.py`` (the port imports nothing of the
JAX package), so either package reads the other's cache. Each song is one
``.npz`` of float32 ``(length, channels)`` arrays, one per source and
``mix``, zero-padded at both ends by the network's context ``(input -
output) // 2``. The directory is named ``task_X_sr_Y_mono_Z`` under
``data_path``, so a config change preprocesses anew, and ``meta.json``,
written last, marks a partition complete. Unreadable source files are
skipped with a warning; a shard that rotted on disk raises ``ValueError``
naming it, which the readers skip.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.data.audio_io import load


def cache_dir(cfg: Config) -> str:
    name = f"task_{cfg.task}_sr_{cfg.expected_sr}_mono_{cfg.mono_downmix}"
    return os.path.join(cfg.data_path, name)


def partition_dir(cfg: Config, partition: str) -> str:
    return os.path.join(cache_dir(cfg), partition)


def is_prepared(cfg: Config) -> bool:
    """Every partition wrote its ``meta.json``: a bare directory may be a
    crashed, partial preprocess."""
    return all(
        os.path.exists(os.path.join(partition_dir(cfg, p), "meta.json"))
        for p in ("train", "valid", "test"))


def write_song(path: str, tracks: Dict[str, np.ndarray]) -> None:
    np.savez(path, **{k: v.astype(np.float32) for k, v in tracks.items()})


def load_song(path: str) -> Dict[str, np.ndarray]:
    """Read one shard. Corruption (a truncated or flipped file) raises
    ``ValueError`` naming the shard; environmental failures (a missing
    file, permissions, memory) propagate untouched, since skipping them
    would shrink the training set over a storage problem."""
    import pickle
    import zipfile
    import zlib
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except (zipfile.BadZipFile, zlib.error, EOFError, KeyError,
            pickle.UnpicklingError, ValueError) as e:
        raise ValueError(f"corrupt cache shard {path!r}: {e}") from e


def list_songs(cfg: Config, partition: str) -> List[str]:
    d = partition_dir(cfg, partition)
    if not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".npz"))


def preprocess_partition(cfg: Config, partition: str,
                         sample_list: Sequence[Dict[str, str]],
                         pad_frames: int) -> List[str]:
    """Load every song's stems (each source name and "mix" mapped to a WAV
    path), context-pad them and write the npz shards and ``meta.json``."""
    out_dir = partition_dir(cfg, partition)
    os.makedirs(out_dir, exist_ok=True)
    all_keys = list(cfg.source_names) + ["mix"]
    written = []
    for idx, sample in enumerate(sample_list):
        try:
            tracks: Dict[str, np.ndarray] = {}
            for key in all_keys:
                audio, _ = load(sample[key], sr=cfg.expected_sr,
                                mono=cfg.mono_downmix)
                if not cfg.mono_downmix and audio.shape[1] == 1:
                    audio = np.tile(audio, [1, 2])  # mono -> stereo
                tracks[key] = audio
        except (OSError, ValueError, KeyError) as e:
            print(f"WARNING: skipping sample {idx} ({e})")
            continue
        length = tracks["mix"].shape[0]
        channels = tracks["mix"].shape[1]
        if not all(v.shape == (length, channels) for v in tracks.values()):
            # stems a frame off after decoding: trim to the shortest
            length = min(v.shape[0] for v in tracks.values())
            tracks = {k: v[:length] for k, v in tracks.items()}
        if pad_frames > 0:
            tracks = {k: np.pad(v, [(pad_frames, pad_frames), (0, 0)])
                      for k, v in tracks.items()}
        path = os.path.join(out_dir, f"song_{idx:04d}.npz")
        write_song(path, tracks)
        written.append(path)

    meta = {"pad_frames": pad_frames, "num_songs": len(written),
            "keys": all_keys, "sr": cfg.expected_sr,
            "channels": cfg.num_channels}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return written


def prepare_dataset(cfg: Config, pad_frames: int,
                    seed: Optional[int] = None) -> None:
    """MUSDB (WAV layout) plus CCMixter for the voice task -> npz cache:
    ``num_val_songs`` validation songs drawn with a seeded permutation from
    the MUSDB train set (never all of it), CCMixter appended to train."""
    from waveunet_tpu_torch.data.ingest import get_ccmixter, get_musdb

    if is_prepared(cfg):
        return
    train_list, test_list = get_musdb(cfg.musdb_path)
    rng = np.random.RandomState(cfg.seed if seed is None else seed)
    n_val = min(cfg.num_val_songs, max(0, len(train_list) - 1))
    val_set = {int(i) for i in rng.choice(len(train_list), size=n_val,
                                          replace=False)}
    partitions = {
        "train": [s for i, s in enumerate(train_list) if i not in val_set],
        "valid": [s for i, s in enumerate(train_list) if i in val_set],
        "test": list(test_list),
    }
    if cfg.task == "voice" and os.path.exists(cfg.ccmixter_xml):
        partitions["train"].extend(get_ccmixter(cfg.ccmixter_xml))
    for part, samples in partitions.items():
        print(f"Writing {part} partition ({len(samples)} songs)...")
        preprocess_partition(cfg, part, samples, pad_frames)
