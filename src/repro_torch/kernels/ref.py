"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in plain tensor
operations.  ``kernels.ops`` takes them for tensors on the CPU, and
``chip_smoke.py`` holds each kernel against its plain version on the card.

The uint32 ring of the secure aggregation is carried in ``int32`` tensors
that hold the bit pattern.  Ring sums here are taken in ``int64`` and
reduced mod 2^32 by :func:`ring_to_int32`, so nothing depends on signed
overflow (and PyTorch on the CPU has no uint32 ``add`` or ``sum``).
"""
from __future__ import annotations

from typing import Optional

import torch

_TWO31 = 1 << 31
_RING_MASK = (1 << 32) - 1


def ring_to_int32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32 holding its value mod 2^32 (two's complement)."""
    return (((x.to(torch.int64) + _TWO31) & _RING_MASK) - _TWO31).to(torch.int32)


def ring_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b in the uint32 ring, both held as int32 bit patterns."""
    return ring_to_int32(a.to(torch.int64) + b.to(torch.int64))


def quant_scale(clip: float, bits: int) -> float:
    """Fixed-point scale (2^(bits-1) - 1) / clip, in double as the reference."""
    return ((1 << (bits - 1)) - 1) / clip


def staleness_aggregate_ref(deltas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(k, P) float32 rows, (k,) weights -> (P,) Σ_i w_i·delta_i."""
    return (deltas.to(torch.float32) * weights.to(torch.float32)[:, None]).sum(0)


def masked_aggregate_ref(masked: torch.Tensor, masks: torch.Tensor, clip: float,
                         bits: int) -> torch.Tensor:
    """(k, P) int32 ciphertexts and pads -> (P,) float32 decoded ring sum.

    Decodes with a multiply by float32(1/scale), as the Pallas kernel does
    (``repro/kernels/masked_agg.py``), not with the divide of the
    reference's own oracle; the JAX package runs that kernel on the CPU.
    """
    total = masked.to(torch.int64).sum(0) - masks.to(torch.int64).sum(0)
    inv = torch.tensor(1.0 / quant_scale(clip, bits), dtype=torch.float32, device=masked.device)
    return ring_to_int32(total).to(torch.float32) * inv


def row_norms(rows: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """(k, 1) float32 L2 norms of ``rows[:, :dim]``, accumulated in double
    and rounded once (the kernel's norm is the same correctly rounded value)."""
    dim = rows.shape[1] if dim is None else int(dim)
    sq = rows[:, :dim].to(torch.float64).square().sum(-1, keepdim=True)
    return sq.sqrt().to(torch.float32)


def clip_scale(norms: torch.Tensor, clip: float) -> torch.Tensor:
    """min(1, clip / max(norm, 1e-12)) in float32, by true division."""
    return torch.clamp_max(norms.new_tensor(clip) / norms.clamp_min(1e-12), 1.0)


def encode(x: torch.Tensor, clip: float, bits: int) -> torch.Tensor:
    """float -> int32 ring elements: round_half_even(clamp(x, ±c) · scale)."""
    v = torch.clamp(x.to(torch.float32), -clip, clip) * quant_scale(clip, bits)
    return torch.round(v).to(torch.int32)


def clip_quant_mask_ref(rows: torch.Tensor, masks: torch.Tensor, clip: float, bits: int,
                        dim: Optional[int] = None) -> torch.Tensor:
    """(k, P) float32 rows, (k, P) int32 pads -> (k, P) int32 ciphertext:
    encode(clip_L2(row[:, :dim] norm, c)) + pad  (mod 2^32)."""
    rows = rows.to(torch.float32)
    scaled = rows * clip_scale(row_norms(rows, dim), clip)
    return ring_add(encode(scaled, clip, bits), masks)
