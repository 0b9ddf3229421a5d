"""Communication graphs + Metropolis mixing for decentralized aggregation.

A copy of ``repro.topo.graph`` (numpy only), so that the port builds the
same graphs and the same float32 mixing matrices bit for bit without
importing the JAX package.

A gossip round mixes the cohort's models over an undirected communication
graph G_t: every node averages with its neighbors through a mixing matrix
W_t.  We use the Metropolis–Hastings weights

    W_ij = 1 / (1 + max(d_i, d_j))     for {i, j} an edge of G_t,
    W_ii = 1 - Σ_{j != i} W_ij,        W_ij = 0 otherwise,

which are symmetric, nonnegative and doubly stochastic for ANY undirected
graph — so x ← W x preserves the fleet average and contracts disagreement at
the rate of the second-largest eigenvalue modulus (SLEM) of W.  On the
complete graph the Metropolis weights are exactly uniform 1/n, which is what
makes the ``"gossip"`` strategy degenerate to FedAvg (the golden-equivalence
anchor in ``tests/test_topo.py``, re-asserted for the port in
``tests/test_torch_gossip.py``).

Four graph families are registered (``GRAPHS``), all deterministic in
``(n, round, seed)`` so a run is reproducible:

    ring      1-D cycle, degree 2 — cheapest per round, gap ~ Θ(1/n²)
    torus     2-D torus r×c (r the largest divisor of n ≤ √n), degree ≤ 4,
              gap ~ Θ(1/n) — the classic mesh-network compromise
    erdos     Erdős–Rényi G(n, p), resampled (bounded retries) until
              connected — gap ~ Θ(1) w.h.p. above the connectivity threshold
    one_peer  time-varying exponential schedule: at round t each node talks
              to i ± 2^(t mod ⌈log2 n⌉) — degree ≤ 2 per round, but the
              union over ⌈log2 n⌉ rounds is an expander
    full      complete graph, uniform 1/n mixing (the FedAvg anchor)

``plan(name, n, rnd, ...)`` returns a :class:`MixingPlan` carrying the
adjacency, the Metropolis matrix, per-node neighbor lists and the spectral
diagnostics (SLEM / spectral gap / rounds-to-consensus estimate) the
telemetry reports.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np

__all__ = [
    "GRAPHS", "MixingPlan", "consensus_rounds", "erdos_adjacency",
    "full_adjacency", "is_connected", "metropolis_weights", "one_peer_adjacency",
    "plan", "ring_adjacency", "slem", "spectral_gap", "torus_adjacency",
]


# ---------------------------------------------------------------------------
# Adjacency constructors — (n, n) bool, symmetric, zero diagonal
# ---------------------------------------------------------------------------


def _empty(n: int) -> np.ndarray:
    return np.zeros((n, n), dtype=bool)


def _symmetrize(adj: np.ndarray) -> np.ndarray:
    adj = adj | adj.T
    np.fill_diagonal(adj, False)
    return adj


def ring_adjacency(n: int) -> np.ndarray:
    """1-D cycle: i ~ i±1 (mod n)."""
    adj = _empty(n)
    if n < 2:
        return adj
    idx = np.arange(n)
    adj[idx, (idx + 1) % n] = True
    return _symmetrize(adj)


def torus_factors(n: int) -> tuple[int, int]:
    """n = r·c with r the largest divisor of n not exceeding √n."""
    r = 1
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            r = d
    return r, n // r


def torus_adjacency(n: int) -> np.ndarray:
    """2-D torus on an r×c grid (4-neighborhood, wrap-around).

    Prime n factors as 1×n and the torus degenerates to the ring — the
    honest fallback, not an error.
    """
    r, c = torus_factors(n)
    if r == 1:
        return ring_adjacency(n)
    adj = _empty(n)
    rows, cols = np.divmod(np.arange(n), c)
    east = rows * c + (cols + 1) % c
    south = ((rows + 1) % r) * c + cols
    adj[np.arange(n), east] = True
    adj[np.arange(n), south] = True
    return _symmetrize(adj)


def erdos_adjacency(n: int, p: float = 0.4, seed: int = 0, rnd: int = 0,
                    max_tries: int = 20) -> np.ndarray:
    """Connected Erdős–Rényi G(n, p), deterministic in (n, p, seed, rnd).

    Disconnected draws stall consensus (SLEM = 1), so we resample with a
    folded seed up to ``max_tries`` times and fall back to unioning a ring —
    deterministic, and only reachable at p far below the ln(n)/n
    connectivity threshold.
    """
    if n < 2:
        return _empty(n)
    for trial in range(max_tries):
        rng = np.random.default_rng(np.random.SeedSequence([seed, rnd, trial]))
        upper = rng.random((n, n)) < p
        adj = _symmetrize(np.triu(upper, 1))
        if is_connected(adj):
            return adj
    return adj | ring_adjacency(n)


def one_peer_adjacency(n: int, rnd: int = 0) -> np.ndarray:
    """Time-varying exponential schedule: i ~ i ± 2^(rnd mod ⌈log2 n⌉).

    Each round is a sparse circulant (degree ≤ 2); cycling the offset
    through the powers of two makes the union over ⌈log2 n⌉ consecutive
    rounds an exponential-graph expander, so consensus still propagates
    at O(log n) hops despite the per-round one-peer budget.
    """
    if n < 2:
        return _empty(n)
    tau = max(1, math.ceil(math.log2(n)))
    g = 1 << (rnd % tau)  # 2^(rnd mod tau) < n since tau = ceil(log2 n)
    adj = _empty(n)
    idx = np.arange(n)
    adj[idx, (idx + g) % n] = True
    return _symmetrize(adj)


def full_adjacency(n: int) -> np.ndarray:
    """Complete graph — Metropolis weights collapse to uniform 1/n."""
    adj = np.ones((n, n), dtype=bool)
    np.fill_diagonal(adj, False)
    return adj


#: registry: name -> fn(n, rnd, seed, p) -> (n, n) bool adjacency
GRAPHS: dict[str, Callable[..., np.ndarray]] = {
    "ring": lambda n, rnd, seed, p: ring_adjacency(n),
    "torus": lambda n, rnd, seed, p: torus_adjacency(n),
    "erdos": lambda n, rnd, seed, p: erdos_adjacency(n, p=p, seed=seed, rnd=rnd),
    "one_peer": lambda n, rnd, seed, p: one_peer_adjacency(n, rnd=rnd),
    "full": lambda n, rnd, seed, p: full_adjacency(n),
}


# ---------------------------------------------------------------------------
# Mixing matrix + spectral diagnostics
# ---------------------------------------------------------------------------


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings mixing matrix of an undirected graph.

    Symmetric, nonnegative, doubly stochastic for any (even disconnected)
    adjacency; the diagonal absorbs whatever the neighbor weights leave.
    """
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    W = np.where(adj, 1.0 / (1.0 + np.maximum.outer(deg, deg)), 0.0)
    W[np.arange(n), np.arange(n)] = 1.0 - W.sum(axis=1)
    return W.astype(np.float32)


def is_connected(adj: np.ndarray) -> bool:
    """BFS reachability from node 0 (n = 0/1 count as connected)."""
    n = adj.shape[0]
    if n <= 1:
        return True
    seen = np.zeros(n, dtype=bool)
    seen[0] = True
    frontier = np.array([0])
    while frontier.size:
        nxt = adj[frontier].any(axis=0) & ~seen
        seen |= nxt
        frontier = np.flatnonzero(nxt)
    return bool(seen.all())


def slem(W: np.ndarray) -> float:
    """Second-largest eigenvalue modulus — the per-step consensus
    contraction factor.  Symmetric W uses the Hermitian path; the
    carbon-reweighted (row-stochastic only) matrices fall back to the
    general eigensolver."""
    W = np.asarray(W, dtype=np.float64)
    if W.shape[0] <= 1:
        return 0.0
    if np.allclose(W, W.T, atol=1e-12):
        mags = np.sort(np.abs(np.linalg.eigvalsh(W)))[::-1]
    else:
        mags = np.sort(np.abs(np.linalg.eigvals(W)))[::-1]
    return float(mags[1])


def spectral_gap(W: np.ndarray) -> float:
    """1 - SLEM: zero on disconnected graphs, 1 on uniform full mixing."""
    return 1.0 - slem(W)


def consensus_rounds(W: np.ndarray, tol: float = 1e-3) -> float:
    """Mixing steps needed to shrink disagreement by ``tol`` (ρ^k ≤ tol).

    ``inf`` when the graph cannot reach consensus (SLEM ≥ 1, i.e.
    disconnected), 0 when one step already lands exactly (complete graph).
    """
    rho = slem(W)
    if rho >= 1.0:
        return float("inf")
    if rho <= 0.0:
        return 0.0
    return float(math.ceil(math.log(tol) / math.log(rho)))


# ---------------------------------------------------------------------------
# Per-round plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MixingPlan:
    """One round's communication graph + Metropolis mixing matrix."""

    graph: str
    n: int
    rnd: int
    adjacency: np.ndarray  # (n, n) bool, symmetric, zero diagonal
    mixing: np.ndarray     # (n, n) float32 Metropolis-Hastings weights

    @functools.cached_property
    def neighbors(self) -> tuple[tuple[int, ...], ...]:
        """Per-node neighbor lists (the gather pattern of one mix step)."""
        return tuple(tuple(np.flatnonzero(row)) for row in self.adjacency)

    @property
    def n_edges(self) -> int:
        """Undirected edge count of this round's graph."""
        return int(self.adjacency.sum()) // 2

    @functools.cached_property
    def slem(self) -> float:
        return slem(self.mixing)

    @property
    def spectral_gap(self) -> float:
        return 1.0 - self.slem

    def consensus_rounds(self, tol: float = 1e-3) -> float:
        return consensus_rounds(self.mixing, tol)

    def bytes_per_step(self, row_bytes: int) -> int:
        """Network bytes one mixing pass moves: every edge carries one model
        row each way (2 directed transfers of ``row_bytes``)."""
        return 2 * self.n_edges * row_bytes


def plan(graph: str, n: int, rnd: int = 0, *, seed: int = 0, p: float = 0.4) -> MixingPlan:
    """Build round ``rnd``'s :class:`MixingPlan` for ``n`` nodes.

    ``graph`` is a :data:`GRAPHS` key; ``seed``/``p`` only matter for the
    random family.  Time-varying families (``one_peer``, ``erdos``) change
    with ``rnd``; the static ones ignore it.
    """
    if graph not in GRAPHS:
        raise ValueError(f"unknown graph {graph!r}; registered: {sorted(GRAPHS)}")
    if n < 1:
        raise ValueError(f"need at least one node, got n={n}")
    adj = GRAPHS[graph](n, rnd, seed, p)
    return MixingPlan(graph=graph, n=n, rnd=rnd, adjacency=adj,
                      mixing=metropolis_weights(adj))
