"""Host batch pipeline over the npz song cache.

A copy of ``waveunet_tpu/data/pipeline.py`` in numpy, so with the same seed
and cache it yields the same batches, bit for bit (with one reader thread:
several readers put songs in the order they finish):

  train: shuffled song visits -> ``num_snippets_per_track`` random snippets
         a visit -> random_amplify when augmenting -> target crop ->
         shuffle buffer (``cache_size`` snippets) -> batch -> prefetch
  eval:  songs in order -> strided snippets (hop = output) -> target crop
         -> batch, remainder dropped

``(host_id, num_hosts)`` gives each host a disjoint round-robin slice of the
songs; an empty slice raises ``EmptyShardError``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.data import cache, sampler


class EmptyShardError(ValueError):
    """This host's (host_id, num_hosts) song slice is empty: fewer cached
    songs than hosts. Distinct from ValueError so a caller can take only
    this case as a shard of weight 0."""


class BatchPipeline:
    def __init__(self, cfg: Config, partition: str, input_len: int,
                 output_len: int, batch_size: Optional[int] = None,
                 host_id: int = 0, num_hosts: int = 1,
                 song_paths: Optional[List[str]] = None, seed: int = 0):
        self.cfg = cfg
        self.partition = partition
        self.input_len = input_len
        self.output_len = output_len
        self.pad = (input_len - output_len) // 2
        self.batch = batch_size or cfg.batch_size
        self.rng = np.random.default_rng(seed + 7919 * host_id)
        paths = song_paths if song_paths is not None else cache.list_songs(
            cfg, partition)
        if not paths:
            raise FileNotFoundError(
                f"no cached songs for partition {partition!r} under "
                f"{cache.partition_dir(cfg, partition)}; run prepare_dataset()")
        self.paths = paths[host_id::num_hosts]
        if not self.paths:
            raise EmptyShardError(
                f"host {host_id}/{num_hosts} got an empty song slice "
                f"({len(paths)} cached songs < num_hosts)")
        self.keys = list(cfg.source_names) + ["mix"]

    def _songs_endless(self) -> Iterator[Dict[str, np.ndarray]]:
        """Endless shuffled song loads from ``cfg.num_workers`` reader
        threads. The song order has its own generator: the readers draw it
        under the lock while the consumer draws from ``self.rng``, and a
        numpy Generator is not thread-safe."""
        order_rng = np.random.default_rng(int(self.rng.integers(2 ** 63)))

        def order_iter():
            while True:
                for si in order_rng.permutation(len(self.paths)):
                    yield self.paths[si]

        paths = order_iter()
        depth = max(1, self.cfg.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        lock = threading.Lock()

        def reader():
            while True:
                with lock:
                    p = next(paths)
                try:
                    q.put(cache.load_song(p))
                except Exception as e:  # a reader thread must keep going
                    #                     (a corrupt or vanished shard)
                    print(f"WARNING: failed to load {p} ({e}); skipping")

        for _ in range(depth):
            threading.Thread(target=reader, daemon=True).start()
        while True:
            yield q.get()

    def _song_snippets_train(self) -> Iterator[Dict[str, np.ndarray]]:
        """Endless augmented snippet groups, one song visit at a time."""
        skipped = 0
        for tracks in self._songs_endless():
            length = tracks["mix"].shape[0]
            if length < self.input_len:
                # every song too short would spin here forever
                skipped += 1
                if skipped > 2 * len(self.paths):
                    raise RuntimeError(
                        f"no cached song in this partition slice reaches the "
                        f"network input length {self.input_len}")
                continue
            skipped = 0
            pos = sampler.random_snippet_positions(
                self.rng, length, self.input_len,
                self.cfg.num_snippets_per_track)
            snip = sampler.extract_snippets(tracks, pos, self.input_len)
            if self.cfg.augmentation:
                snip = sampler.random_amplify(snip, self.rng,
                                              self.cfg.source_names)
            yield sampler.crop_targets(snip, self.pad, self.cfg.source_names)

    def train_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Endless shuffled fixed-shape batches (a shuffle buffer of about
        ``cache_size`` snippets)."""
        buf: List[Dict[str, np.ndarray]] = []
        target = max(self.cfg.cache_size, 2 * self.batch)
        snippets = self._song_snippets_train()
        while True:
            while len(buf) < target:
                group = next(snippets)
                for i in range(group["mix"].shape[0]):
                    buf.append({k: group[k][i] for k in self.keys})
            idx = self.rng.choice(len(buf), size=self.batch, replace=False)
            batch = {k: np.stack([buf[i][k] for i in idx]) for k in self.keys}
            for i in sorted(idx, reverse=True):
                buf[i] = buf[-1]
                buf.pop()
            yield batch

    def eval_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """One deterministic pass: strided snippets, batches, the remainder
        dropped."""
        pend: List[Dict[str, np.ndarray]] = []
        for path in self.paths:
            tracks = cache.load_song(path)
            length = tracks["mix"].shape[0]
            if length < self.input_len:
                continue
            pos = sampler.sequential_snippet_positions(
                length, self.input_len, self.output_len)
            snip = sampler.extract_snippets(tracks, pos, self.input_len)
            snip = sampler.crop_targets(snip, self.pad, self.cfg.source_names)
            for i in range(snip["mix"].shape[0]):
                pend.append({k: snip[k][i] for k in self.keys})
                if len(pend) == self.batch:
                    yield {k: np.stack([s[k] for s in pend])
                           for k in self.keys}
                    pend = []

    def prefetched(self, it: Iterator, depth: int = 2) -> Iterator:
        """Run ``it`` in a background thread with a small queue, so host
        data work overlaps device compute; an error in the worker is raised
        here, not taken for the end of the data."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        sentinel = object()
        err: List[BaseException] = []

        def worker():
            try:
                for item in it:
                    q.put(item)
            except BaseException as e:  # re-raised in the consumer below
                err.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
