"""Row-native gossip mixing (port of ``repro.topo.gossip``).

One mixing step replaces every node's model row with the W-weighted average
of its neighborhood:

    X ← W X,        X: (k, P) ParamSpace rows,  W: (k, k) mixing matrix

through the ``gossip_mix`` kernel (``kernels/csrc/gossip_mix.cu`` on the
card, its plain version for CPU tensors).  Also here: the carbon-aware
neighbor reweighting (``carbon_reweight``, a numpy copy of the
reference's) and the consensus-distance diagnostic the ``MixEvent``
telemetry reports.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fl.paramspace import ParamSpace
from repro_torch.kernels import ops as kernel_ops

__all__ = ["carbon_reweight", "consensus_distance", "mix_rows"]


def mix_rows(pspace: ParamSpace, rows: torch.Tensor, mixing: torch.Tensor) -> torch.Tensor:
    """One gossip pass X ← W X over (k, dim) ParamSpace rows.

    The rows are zero-padded to whole 2048-column blocks, as the reference
    pads them for its kernel, mixed, and sliced back to ``pspace.dim``.
    """
    w = mixing.to(device=rows.device, dtype=torch.float32).contiguous()
    out = kernel_ops.gossip_mix(pspace.pad_rows(rows).contiguous(), w)
    return out[:, : pspace.dim]


def carbon_reweight(mixing: np.ndarray, intensities: np.ndarray, beta: float) -> np.ndarray:
    """Tilt neighbor weights toward low-carbon peers (paper §III-D spirit).

    Each off-diagonal column j is scaled by ``exp(-beta · z_j)`` where z_j
    is peer j's grid intensity standardized over the cohort, normalized so
    the largest factor is 1 (weights only shrink); the diagonal absorbs the
    slack.  The result stays row-stochastic and nonnegative, but symmetry
    is given up: consensus drifts toward models trained where the grid is
    green.  ``beta = 0`` returns the matrix unchanged.
    """
    W = np.asarray(mixing, np.float64)
    if beta == 0.0 or W.shape[0] <= 1:
        return W.astype(np.float32)
    inten = np.asarray(intensities, np.float64)
    z = (inten - inten.mean()) / (inten.std() + 1e-9)
    factor = np.exp(-beta * z)
    factor = factor / factor.max()  # <= 1: off-diag mass only ever shrinks
    off = W * factor[None, :]
    np.fill_diagonal(off, 0.0)
    off[np.arange(len(off)), np.arange(len(off))] = 1.0 - off.sum(axis=1)
    return off.astype(np.float32)


def consensus_distance(rows: torch.Tensor) -> float:
    """Mean L2 distance of node models to their average (0 = exact
    consensus), reduced in float32 on the rows' device."""
    rows = rows.to(torch.float32)
    center = rows.mean(dim=0, keepdim=True)
    return float(torch.linalg.vector_norm(rows - center, dim=1).mean())
