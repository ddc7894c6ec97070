"""Deterministic synthetic data (port of ``repro.data.pipeline``).

Only ``SyntheticImages`` so far, a numpy copy of the reference's (it uses
no JAX): step-indexed NHWC image batches with learnable class structure
(per-class mean patterns plus noise), so a training run's loss genuinely
descends.  Batches are a pure function of (seed, step, host), bitwise the
reference's.  ``SyntheticLM``, ``TokenFileDataset`` and ``Prefetcher``
wait for the LM training items (ROADMAP §1).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


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
