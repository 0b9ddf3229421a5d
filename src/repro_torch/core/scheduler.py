"""Carbon-aware scheduling (port of ``repro.core.scheduler``, Eq. 9).

    Priority(i, t) = Q(s_t, i) / max(1, I_i(t) / I_threshold)
"""
from __future__ import annotations

import torch

from repro_torch.core.carbon import I_THRESHOLD


def priority(q_scores: torch.Tensor, intensity: torch.Tensor) -> torch.Tensor:
    """Eq. 9. q_scores: (n,) Q(s_t, ·); intensity: (n,)."""
    return q_scores / torch.clamp_min(intensity / I_THRESHOLD, 1.0)


def green_scores(uniform: torch.Tensor, intensity: torch.Tensor) -> torch.Tensor:
    """Green-only score: 1/max(1, I/I_threshold) plus 0.3-scale jitter from
    the (n,) ``uniform`` draw, so equally green providers rotate."""
    base = 1.0 / torch.clamp_min(intensity / I_THRESHOLD, 1.0)
    return base + 0.3 * uniform


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of exactly the k highest scores.  Ties go to the lowest
    index, as ``lax.top_k`` breaks them: a stable descending sort, not
    ``torch.topk`` (whose tie order is unspecified)."""
    idx = torch.sort(scores, descending=True, stable=True).indices[:k]
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    mask[idx] = True
    return mask
