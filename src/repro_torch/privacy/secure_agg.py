"""Dealer-masked aggregation (port of the dealer path of
``repro.privacy.secure_agg``).

Each cohort member adds a one-time pad to its quantized row; the server sums
ciphertexts and subtracts the pad sum (the ``masked_agg`` kernel).  The pads
come from the round's :class:`~repro_torch.draws.Draws` object, which plays
the trusted dealer.  The Bonawitz pairwise path is not ported yet.
"""
from __future__ import annotations

import torch


def mask_rows(draws, k: int, n: int) -> torch.Tensor:
    """(k, n) int32 pad block (uint32 bit patterns), one row per client."""
    return draws.pads(k, n)
