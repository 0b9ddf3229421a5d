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
NEG_INF = -1e30  # masked attention score, as the Pallas kernel's


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


def gossip_mix_ref(rows: torch.Tensor, mixing: torch.Tensor) -> torch.Tensor:
    """(k, P) float32 rows, (k, k) mixing matrix -> (k, P) W @ rows.

    Summed as the kernel sums: out[i] = Σ_j W[i, j]·rows[j] in the order
    j = 0..k-1, each product and each sum rounded on its own (no FMA), so
    the two agree bitwise on the card.
    """
    rows = rows.to(torch.float32)
    w = mixing.to(device=rows.device, dtype=torch.float32)
    out = w[:, :1] * rows[:1]
    for j in range(1, rows.shape[0]):
        out = out + w[:, j:j + 1] * rows[j:j + 1]
    return out


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


def attention_mask(T: int, S: int, *, causal: bool, window: Optional[int], q_offset: int = 0,
                   device=None) -> torch.Tensor:
    """(T, S) bool: query t, at absolute position q_offset + t, sees key s
    when s <= q_offset + t (causal) and s > q_offset + t - window."""
    t = q_offset + torch.arange(T, device=device)[:, None]
    s = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask &= s <= t
    if window is not None:
        mask &= s > t - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        logit_cap: float = 0.0) -> torch.Tensor:
    """q (B, T, H, hd), k and v (B, S, K, hd), H % K == 0 -> (B, T, H, hd) in
    q's dtype; float32 scores and softmax, query head h reads KV head h // (H // K).

    The contract of the reference's ``flash_attention_ref``, except that a
    query row with no valid key gives zeros (as the Pallas kernel does)
    where that oracle gives the mean of v.
    """
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, K, H // K, hd).float()
    s = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) * hd ** -0.5
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    mask = attention_mask(T, S, causal=causal, window=window, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1) * mask.any(-1, keepdim=True)
    o = torch.einsum("bkgts,bskh->btkgh", p, v.float())
    return o.reshape(B, T, H, hd).to(q.dtype)
