"""Non-IID federated partitioning — Dirichlet(α) label-skew (paper: α=0.5)."""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float = 0.5,
                        seed: int = 0, min_per_client: int = 8) -> list[np.ndarray]:
    """Split sample indices across clients with Dirichlet label proportions.

    Standard construction (Hsu et al. 2019, used verbatim by MetaFed): for
    each class, draw p ~ Dir(alpha * 1_n_clients) and deal that class's
    samples out proportionally.  Retries until every client has at least
    ``min_per_client`` samples (rejection keeps the marginals Dirichlet).
    """
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _attempt in range(100):
        idx_by_client: list[list[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            p = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(p) * len(idx_c)).astype(int)[:-1]
            for client, chunk in enumerate(np.split(idx_c, cuts)):
                idx_by_client[client].extend(chunk.tolist())
        sizes = [len(ix) for ix in idx_by_client]
        if min(sizes) >= min_per_client:
            return [np.array(sorted(ix), dtype=np.int64) for ix in idx_by_client]
    raise RuntimeError("dirichlet_partition: could not satisfy min_per_client")


def label_histogram(labels: np.ndarray, parts: list[np.ndarray], n_classes: int) -> np.ndarray:
    """(n_clients, n_classes) counts — used by tests and the heterogeneity report."""
    out = np.zeros((len(parts), n_classes), np.int64)
    for i, ix in enumerate(parts):
        vals, counts = np.unique(labels[ix], return_counts=True)
        out[i, vals] = counts
    return out
