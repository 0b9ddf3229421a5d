"""Host-side batching for the FL simulation: per-client epoch iterators."""
from __future__ import annotations

import numpy as np


class ClientDataset:
    """One client's local shard, with deterministic epoch shuffling."""

    def __init__(self, data: dict[str, np.ndarray], indices: np.ndarray, seed: int):
        self.data = data
        self.indices = np.asarray(indices)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.indices)

    def batches(self, batch_size: int, epoch: int, drop_remainder: bool = True):
        rng = np.random.default_rng((self.seed * 1_000_003 + epoch) & 0x7FFFFFFF)
        order = rng.permutation(self.indices)
        n = len(order) - (len(order) % batch_size) if drop_remainder else len(order)
        if n == 0:  # tiny client: sample with replacement to fill one batch
            order = rng.choice(self.indices, batch_size, replace=True)
            n = batch_size
        for i in range(0, n, batch_size):
            ix = order[i : i + batch_size]
            yield {k: v[ix] for k, v in self.data.items()}

    def stacked_steps(self, batch_size: int, n_steps: int, round_idx: int):
        """Exactly ``n_steps`` local batches stacked into (n_steps, batch, ...)
        arrays — cycles epochs if the shard is small, so every client's local
        round jits once (fixed shapes) regardless of shard size."""
        out: list[dict] = []
        epoch = 0
        while len(out) < n_steps:
            for b in self.batches(batch_size, round_idx * 131 + epoch):
                out.append(b)
                if len(out) >= n_steps:
                    break
            epoch += 1
        return {k: np.stack([b[k] for b in out]) for k in out[0]}

    def stacked_epochs(self, batch_size: int, epochs: int, round_idx: int):
        """All local batches of ``epochs`` epochs stacked for a lax.scan client
        step: dict of (n_batches, batch, ...) arrays."""
        out: list[dict] = []
        for e in range(epochs):
            out.extend(self.batches(batch_size, round_idx * 131 + e))
        if not out:
            raise ValueError("client has no data")
        return {k: np.stack([b[k] for b in out]) for k in out[0]}


def build_clients(data: dict[str, np.ndarray], parts: list[np.ndarray], seed: int = 0):
    return [ClientDataset(data, ix, seed + i) for i, ix in enumerate(parts)]


def eval_batches(data: dict[str, np.ndarray], batch_size: int):
    n = len(next(iter(data.values())))
    for i in range(0, n - n % batch_size, batch_size):
        yield {k: v[i : i + batch_size] for k, v in data.items()}
