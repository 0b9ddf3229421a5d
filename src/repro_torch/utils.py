"""Shape helpers shared across the port."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def pad_to(x: torch.Tensor, size: int, dim: int = 0) -> torch.Tensor:
    """Zero-pad ``x`` along ``dim`` up to ``size``; a tensor already at
    least that long is returned as is."""
    dim = dim % x.ndim
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.ndim - dim - 1) + [0, pad]
    return F.pad(x, widths)
