"""Wrappers of the hand-written CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, allocates its output
with ``torch.empty`` and, for a CUDA tensor, launches its kernel on the
current stream (``csrc/*.cu``, built at first use by ``_build``).  For a
tensor on the CPU it computes the kernel's plain version (``ref``); any other
device raises.  There is no fallback: a CUDA tensor goes to the kernel or
the call raises.

``launches`` counts, per kernel, the calls that launched it; it counts
nothing on the CPU route.  ``chip_smoke.py`` zeroes it around the main path
to show that the path went through the kernels.

The uint32 ring is carried in ``int32`` tensors holding the bit pattern.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches: dict[str, int] = {name: 0 for name in _build.KERNELS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _route(t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the CPU plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def _vec(P: int, *ts: torch.Tensor) -> int:
    """1 when every row start is 16-byte aligned (16-byte loads are legal)."""
    return int(P % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def staleness_aggregate(deltas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(k, P) float32 rows, (k,) float32 weights -> (P,) Σ_i w_i·delta_i."""
    if deltas.ndim != 2:
        raise ValueError(f"deltas must be (k, P), got {tuple(deltas.shape)}")
    k, P = deltas.shape
    _check(deltas, "deltas", torch.float32, (k, P), deltas.device)
    _check(weights, "weights", torch.float32, (k,), deltas.device)
    if not _route(deltas):
        return ref.staleness_aggregate_ref(deltas, weights)
    out = torch.empty(P, dtype=torch.float32, device=deltas.device)
    if P == 0:
        return out
    err = _build.lib("staleness_agg").rt_staleness_agg(
        deltas.data_ptr(), weights.data_ptr(), out.data_ptr(), k, P,
        _vec(P, deltas, out), _stream())
    _raise_on(err, "staleness_agg")
    launches["staleness_agg"] += 1
    return out


def masked_aggregate(masked: torch.Tensor, masks: torch.Tensor, clip: float,
                     bits: int) -> torch.Tensor:
    """(k, P) int32 ciphertexts and pads -> (P,) float32 decoded ring sum:
    f32(int32(Σ masked − Σ masks mod 2^32)) · f32(1/scale)."""
    if masked.ndim != 2:
        raise ValueError(f"masked must be (k, P), got {tuple(masked.shape)}")
    k, P = masked.shape
    _check(masked, "masked", torch.int32, (k, P), masked.device)
    _check(masks, "masks", torch.int32, (k, P), masked.device)
    if not _route(masked):
        return ref.masked_aggregate_ref(masked, masks, clip, bits)
    out = torch.empty(P, dtype=torch.float32, device=masked.device)
    if P == 0:
        return out
    inv_scale = 1.0 / ref.quant_scale(clip, bits)  # double, rounded to f32 by ctypes
    err = _build.lib("masked_agg").rt_masked_agg(
        masked.data_ptr(), masks.data_ptr(), out.data_ptr(), k, P, inv_scale,
        _vec(P, masked, masks, out), _stream())
    _raise_on(err, "masked_agg")
    launches["masked_agg"] += 1
    return out


def clip_quant_mask(rows: torch.Tensor, masks: torch.Tensor, clip: float, bits: int, *,
                    dim: Optional[int] = None) -> torch.Tensor:
    """(k, P) float32 rows, (k, P) int32 pads -> (k, P) int32 ciphertext;
    the L2 norm runs over the first ``dim`` columns (default P)."""
    if rows.ndim != 2:
        raise ValueError(f"rows must be (k, P), got {tuple(rows.shape)}")
    k, P = rows.shape
    _check(rows, "rows", torch.float32, (k, P), rows.device)
    _check(masks, "masks", torch.int32, (k, P), rows.device)
    dim = P if dim is None else int(dim)
    if not 0 < dim <= P:
        raise ValueError(f"dim={dim} outside (0, {P}]")
    if not _route(rows):
        return ref.clip_quant_mask_ref(rows, masks, clip, bits, dim=dim)
    out = torch.empty((k, P), dtype=torch.int32, device=rows.device)
    if k == 0:
        return out
    lib = _build.lib("clip_quant_mask")
    # per row: the norm tiles' partial sums of squares, then the row's scale
    scratch = torch.empty((k, lib.rt_clip_quant_mask_tiles(dim) + 1), dtype=torch.float64,
                          device=rows.device)
    err = lib.rt_clip_quant_mask(
        rows.data_ptr(), masks.data_ptr(), out.data_ptr(), scratch.data_ptr(), k, P, dim,
        clip, ref.quant_scale(clip, bits), _vec(P, rows, masks, out), _stream())
    _raise_on(err, "clip_quant_mask")
    launches["clip_quant_mask"] += 1
    return out
