"""Client-level differential privacy (port of ``repro.privacy.dp``).

Each client's delta row is L2-clipped to ``clip``; the server adds
``N(0, (sigma·clip)^2 I)`` to the sum of the clipped rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.privacy import accountant


class DPConfig(NamedTuple):
    clip: float = 1.0
    sigma: float = 0.0          # noise multiplier; 0 disables noise
    bits: int = 20              # quantization width for the secure-agg ring
    target_eps: float = 1.2     # paper budget
    delta: float = 1e-5
    sample_rate: float = 0.2    # 10-of-50 clients per round
    rounds: int = 100


def clip_rows(rows: torch.Tensor, clip: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-client L2 clip of (k, P) rows -> (clipped rows, (k,) pre-clip norms)."""
    rows = rows.to(torch.float32)
    norms = ref.row_norms(rows)
    return rows * ref.clip_scale(norms, clip), norms[:, 0]


def add_noise(draws, summed: torch.Tensor, cfg: DPConfig) -> torch.Tensor:
    """Server-side Gaussian mechanism on the summed clipped rows (flat (P,))."""
    if cfg.sigma <= 0:
        return summed
    return summed + cfg.sigma * cfg.clip * draws.dp_noise(summed.shape[0])


def spent_epsilon(cfg: DPConfig, rounds_done: int) -> float:
    """Privacy spent so far at the configured sigma."""
    if cfg.sigma <= 0:
        return float("inf")
    return accountant.eps_from_rdp(cfg.sample_rate, cfg.sigma, max(1, rounds_done), cfg.delta)
