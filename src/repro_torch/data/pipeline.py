"""Deterministic, resumable data pipeline (port of ``repro.data.pipeline``).

Numpy copies of the reference's sources (it uses no JAX there), so every
batch is bitwise the reference's:

* ``SyntheticLM``: step-indexed synthetic token stream — batch contents are
  a pure function of (seed, step, host), so resume-after-failure is exact
  and requires only the step counter in the checkpoint.
* ``SyntheticImages``: the CNN-training counterpart — step-indexed NHWC
  image batches with learnable class structure (per-class mean patterns
  plus noise), so a training run's loss genuinely descends.
* ``TokenFileDataset``: memory-mapped flat token file (.bin/.npy),
  sequence-chunked, shuffled by a step-indexed permutation, sharded per
  host.
* ``Prefetcher``: background-thread prefetch with bounded depth.

Batches stay numpy; the trainers move them to the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLM:
    """Pure-function-of-step synthetic LM batches (tokens, labels)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        if batch % n_hosts != 0:
            raise ValueError(
                f"batch {batch} not divisible by n_hosts {n_hosts}")
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed, self.host_id, self.n_hosts = seed, host_id, n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        local = self.batch // self.n_hosts
        toks = rng.integers(0, self.vocab, (local, self.seq + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class SyntheticImages:
    """Pure-function-of-step synthetic image batches (images NHWC f32,
    labels int32) with real class structure: each class has a fixed random
    mean pattern and samples are pattern + Gaussian noise, so training a
    classifier on the stream actually reduces the loss (a uniform-noise
    stream would pin it at log(n_classes))."""

    def __init__(self, batch: int, res: int, channels: int = 3,
                 n_classes: int = 10, seed: int = 0, noise: float = 0.5,
                 host_id: int = 0, n_hosts: int = 1):
        if batch % n_hosts != 0:
            raise ValueError(
                f"batch {batch} not divisible by n_hosts {n_hosts}")
        self.batch, self.res, self.channels = batch, res, channels
        self.n_classes, self.seed, self.noise = n_classes, seed, noise
        self.host_id, self.n_hosts = host_id, n_hosts
        # class prototypes are a function of seed only — every step (and
        # every host) sees the same class structure
        proto_rng = np.random.default_rng(np.random.SeedSequence([seed]))
        self.prototypes = proto_rng.standard_normal(
            (n_classes, res, res, channels)).astype(np.float32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        local = self.batch // self.n_hosts
        labels = rng.integers(0, self.n_classes, local, dtype=np.int32)
        noise = rng.standard_normal(
            (local, self.res, self.res, self.channels)).astype(np.float32)
        images = self.prototypes[labels] + self.noise * noise
        return {"images": images, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class TokenFileDataset:
    """Flat token file -> fixed-length sequences with deterministic
    shuffling.  Resume state is just ``step``; the permutation for epoch e
    is seeded by (seed, e), so every host computes the same global order
    and takes its own slice."""

    def __init__(self, path: str, batch: int, seq: int, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        self.tokens = np.load(path, mmap_mode="r") if path.endswith(".npy") \
            else np.memmap(path, dtype=np.int32, mode="r")
        self.batch, self.seq, self.seed = batch, seq, seed
        self.host_id, self.n_hosts = host_id, n_hosts
        self.n_seqs = (len(self.tokens) - 1) // seq
        if self.n_seqs < batch:
            raise ValueError(
                f"dataset too small: {self.n_seqs} seqs < batch {batch}")
        self.steps_per_epoch = self.n_seqs // batch

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        epoch, within = divmod(step, self.steps_per_epoch)
        perm = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])).permutation(self.n_seqs)
        local = self.batch // self.n_hosts
        lo = within * self.batch + self.host_id * local
        idx = perm[lo:lo + local]
        toks = np.stack([np.asarray(self.tokens[i * self.seq:
                                                i * self.seq + self.seq + 1])
                         for i in idx]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background-thread prefetch with bounded depth: ``next()`` gives
    ``(step, batch)`` in step order from ``start_step``; ``stop()`` ends
    the thread."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self.q.get()

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the thread and drop what it had queued."""
        self._stop.set()
        self._thread.join(timeout)
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
