"""RDP accountant for the Sampled Gaussian Mechanism (Mironov et al., 2019).

MetaFed claims (eps=1.2, delta=1e-5)-DP for its training run: 100 rounds at
20% client sampling.  This accountant computes the Renyi-DP of the sampled
Gaussian mechanism on an integer-alpha grid, composes across rounds, converts
to (eps, delta), and calibrates the noise multiplier sigma needed to land on
the paper's budget — the calibrated sigma is what ``dp.py`` applies to the
aggregated update.

Integer-alpha bound (Poisson subsampling, TF-privacy's _compute_log_a_int):

    A_alpha = sum_{k=0}^{alpha} C(alpha, k) (1-q)^{alpha-k} q^k
              exp( (k^2 - k) / (2 sigma^2) )
    RDP(alpha) = log(A_alpha) / (alpha - 1)
"""
from __future__ import annotations

import math

import numpy as np
from scipy import special

ALPHA_GRID = list(range(2, 129)) + [160, 192, 256, 512]


def rdp_sampled_gaussian(q: float, sigma: float, alpha: int) -> float:
    """One step of the sampled Gaussian mechanism at integer Renyi order."""
    if q == 0:
        return 0.0
    if q == 1.0:
        return alpha / (2 * sigma**2)
    log_terms = []
    for k in range(alpha + 1):
        log_c = special.gammaln(alpha + 1) - special.gammaln(k + 1) - special.gammaln(alpha - k + 1)
        log_term = (
            log_c + (alpha - k) * math.log1p(-q) + k * math.log(q) + (k * k - k) / (2 * sigma**2)
        )
        log_terms.append(log_term)
    return float(special.logsumexp(log_terms)) / (alpha - 1)


def eps_from_rdp(q: float, sigma: float, steps: int, delta: float) -> float:
    """Compose ``steps`` rounds and convert RDP -> (eps, delta)."""
    best = math.inf
    for alpha in ALPHA_GRID:
        rdp = steps * rdp_sampled_gaussian(q, sigma, alpha)
        eps = rdp + math.log1p(-1 / alpha) - (math.log(delta) + math.log(alpha)) / (alpha - 1)
        best = min(best, eps)
    return best


def calibrate_sigma(target_eps: float, q: float, steps: int, delta: float,
                    lo: float = 0.3, hi: float = 64.0, tol: float = 1e-3) -> float:
    """Smallest sigma meeting the (eps, delta) budget (binary search)."""
    if eps_from_rdp(q, hi, steps, delta) > target_eps:
        raise ValueError("target epsilon unreachable within sigma search range")
    for _ in range(64):
        mid = math.sqrt(lo * hi)
        if eps_from_rdp(q, mid, steps, delta) > target_eps:
            lo = mid
        else:
            hi = mid
        if hi / lo < 1 + tol:
            break
    return hi


def paper_budget_sigma() -> float:
    """Sigma for the paper's stated run: (1.2, 1e-5)-DP, q=0.2, 100 rounds."""
    return calibrate_sigma(1.2, 0.2, 100, 1e-5)


class SubsampledAccountant:
    """Stateful RDP accountant for heterogeneous sampled-Gaussian steps.

    The schedule-based :func:`eps_from_rdp` assumes every round runs the same
    (q, sigma) — true for the flat synchronous protocol, false under the
    async hierarchy, where each edge region flushes at its own cadence with
    its own cohort-over-region sampling rate.  This accountant composes
    whatever actually ran: the privacy pipeline's ``NoiseStage`` record
    supplies the sigma of each aggregate call and the caller supplies the
    realized subsampling rate; ``epsilon()`` composes the recorded steps on
    the integer-alpha grid and converts to (eps, delta).

    Homogeneous steps reduce exactly to ``eps_from_rdp(q, sigma, n, delta)``.
    A step with sigma <= 0 (noise disabled) makes epsilon infinite, matching
    ``dp.spent_epsilon``.  RDP vectors are cached per distinct (q, sigma), so
    per-flush ``epsilon()`` polling stays cheap.
    """

    def __init__(self, delta: float):
        self.delta = float(delta)
        self._counts: dict[tuple[float, float], int] = {}
        self._rdp_cache: dict[tuple[float, float], np.ndarray] = {}
        self._unbounded = False

    @property
    def steps(self) -> int:
        """Total composed aggregate calls."""
        return sum(self._counts.values())

    def record(self, q: float, sigma: float) -> None:
        """Compose one sampled-Gaussian step at rate ``q`` and multiplier
        ``sigma`` (call once per noised aggregate)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"sampling rate q={q} must be in [0, 1]")
        if sigma <= 0:
            self._unbounded = True
            return
        key = (float(q), float(sigma))
        self._counts[key] = self._counts.get(key, 0) + 1
        if key not in self._rdp_cache:
            self._rdp_cache[key] = np.asarray(
                [rdp_sampled_gaussian(key[0], key[1], a) for a in ALPHA_GRID]
            )

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """Serializable step log: exactly the (q, sigma) -> count table.

        The floats pass through the container store bit-exactly, so an
        accountant restored via :meth:`load_state_dict` reports the *same*
        epsilon it would have reported uninterrupted (the RDP cache is a
        pure function of the step log and is rebuilt on restore).
        """
        return {
            "delta": self.delta,
            "steps": [[q, sigma, n] for (q, sigma), n in self._counts.items()],
            "unbounded": self._unbounded,
        }

    def load_state_dict(self, s: dict) -> None:
        if float(s["delta"]) != self.delta:
            raise ValueError(
                f"accountant delta mismatch: checkpoint has {s['delta']}, "
                f"this run uses {self.delta}"
            )
        self._counts = {}
        self._rdp_cache = {}
        self._unbounded = bool(s["unbounded"])
        for q, sigma, n in s["steps"]:
            key = (float(q), float(sigma))
            self._counts[key] = int(n)
            self._rdp_cache[key] = np.asarray(
                [rdp_sampled_gaussian(key[0], key[1], a) for a in ALPHA_GRID]
            )

    def epsilon(self) -> float:
        """(eps, self.delta) guarantee of everything recorded so far."""
        if self._unbounded:
            return math.inf
        if not self._counts:
            return 0.0
        total = np.zeros(len(ALPHA_GRID))
        for key, n in self._counts.items():
            total += n * self._rdp_cache[key]
        best = math.inf
        for i, alpha in enumerate(ALPHA_GRID):
            eps = (
                total[i] + math.log1p(-1 / alpha)
                - (math.log(self.delta) + math.log(alpha)) / (alpha - 1)
            )
            best = min(best, eps)
        return float(best)
