"""Fixed-point codec of the masked aggregation (port of ``repro.privacy.quantize``).

    q(x) = round_half_even( clip(x, ±c) · (2^(bits-1) - 1) / c )

Ring elements are uint32 bit patterns carried in ``int32`` tensors; the
aggregate of n clients needs ``bits + ceil(log2 n) <= 32`` so the true sum
never wraps (:func:`check_headroom`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref

RING_BITS = 32


def check_headroom(bits: int, n_clients: int) -> None:
    need = bits + math.ceil(math.log2(max(2, n_clients)))
    if need > RING_BITS:
        raise ValueError(
            f"{bits}-bit quantization x {n_clients} clients needs {need} bits > {RING_BITS}-bit ring"
        )


def encode(x: torch.Tensor, clip: float, bits: int) -> torch.Tensor:
    """float (any shape) -> int32 ring elements (two's complement)."""
    return ref.encode(x, clip, bits)


def decode_sum(q_sum: torch.Tensor, clip: float, bits: int, n_clients: int) -> torch.Tensor:
    """int32 ring sum of n encoded vectors -> float sum (true division, as
    the reference's ``decode_sum``)."""
    return q_sum.to(torch.float32) / ref.quant_scale(clip, bits)


def ring_sum(rows: torch.Tensor) -> torch.Tensor:
    """(k, P) int32 ring rows -> (P,) int32 ring sum mod 2^32."""
    return ref.ring_to_int32(rows.to(torch.int64).sum(0))

