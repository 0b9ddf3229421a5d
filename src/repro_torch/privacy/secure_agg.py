"""Masked aggregation (port of ``repro.privacy.secure_agg``).

Two constructions of the same ring-additive contract, as in the reference:

1. **Dealer-masked** (the pipeline's ``MaskStage``): each cohort member adds
   a one-time pad to its quantized row; the server sums ciphertexts and
   subtracts the pad sum (the ``masked_agg`` kernel).  The pads come from
   the round's :class:`~repro_torch.draws.Draws` object, which plays the
   trusted dealer.
2. **Bonawitz pairwise masking** (host-side, numpy): pairwise PRG masks with
   antisymmetric signs cancel in the sum with no auxiliary communication,
   and a dropped client's net mask is removed by the survivors' unmasking
   round.  No strategy calls it; it is the protocol a real edge deployment
   would run.  The PRG and the pair seeds are the reference's, so both
   packages give the same masks.

Ring elements are uint32 (``np.uint32`` here; uint32 bit patterns in
``int32`` tensors on the dealer path).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.privacy import quantize


def mask_rows(draws, k: int, n: int) -> torch.Tensor:
    """(k, n) int32 pad block (uint32 bit patterns), one row per client."""
    return draws.pads(k, n)


def _prg(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed & 0xFFFFFFFFFFFF).integers(
        0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def pairwise_seed(i: int, j: int, session: int = 0) -> int:
    """Symmetric seed for the (i, j) pair (stands in for the DH key agreement)."""
    a, b = (i, j) if i < j else (j, i)
    return hash((a, b, session)) & 0x7FFFFFFFFFFF


def pairwise_mask(i: int, clients: list[int], n: int, session: int = 0) -> np.ndarray:
    """mask_i = Σ_{j>i} PRG(s_ij) − Σ_{j<i} PRG(s_ij)  (mod 2^32)."""
    m = np.zeros(n, np.uint32)
    for j in clients:
        if j == i:
            continue
        s = _prg(pairwise_seed(i, j, session), n)
        m = m + s if j > i else m - s
    return m


def bonawitz_aggregate(q_updates: dict[int, np.ndarray], session: int = 0,
                       planned: list[int] | None = None) -> np.ndarray:
    """Sum quantized uint32 updates under pairwise masks; the masks cancel.

    ``planned``: the client set the masks were made against.  A planned
    client missing from ``q_updates`` dropped out after masking; the
    survivors' unmasking round is simulated by adding its net mask.
    """
    clients = sorted(q_updates)
    planned = sorted(planned) if planned is not None else clients
    n = len(next(iter(q_updates.values())))
    total = np.zeros(n, np.uint32)
    for i in clients:
        total = total + q_updates[i] + pairwise_mask(i, planned, n, session)
    for i in set(planned) - set(clients):  # dropout unmasking round
        total = total + pairwise_mask(i, planned, n, session)
    return total


def aggregate_floats_bonawitz(updates: dict[int, np.ndarray], clip: float, bits: int,
                              session: int = 0) -> np.ndarray:
    """Encode -> pairwise-mask -> sum -> decode: the float sum of ``updates``."""
    quantize.check_headroom(bits, len(updates))
    q = {i: quantize.encode(torch.from_numpy(np.asarray(u, np.float32)), clip, bits)
         .numpy().view(np.uint32) for i, u in updates.items()}
    total = bonawitz_aggregate(q, session)
    return quantize.decode_sum(torch.from_numpy(total.view(np.int32)), clip, bits,
                               len(updates)).numpy()
