"""Wrappers of the hand-written CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity (``flash_attention``:
strides, with a contiguous last dimension), allocates its output
with ``torch.empty`` and, for a CUDA tensor, launches its kernel on the
current stream (``csrc/*.cu``, built at first use by ``_build``).  For a
tensor on the CPU it computes the kernel's plain version (``ref``); any other
device raises.  There is no fallback: a CUDA tensor goes to the kernel or
the call raises.

``launches`` counts, per kernel, the calls that launched it; it counts
nothing on the CPU route.  ``flash_designs`` counts the ``flash_attention``
launches by design (``flash_design``).  ``chip_smoke.py`` zeroes both
around the main path to show that the path went through the kernels.

The uint32 ring is carried in ``int32`` tensors holding the bit pattern.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches: dict[str, int] = {name: 0 for name in _build.KERNELS}
flash_designs: dict[str, int] = {"wgmma": 0, "cuda_core": 0}


def reset_launches() -> None:
    for counts in (launches, flash_designs):
        for name in counts:
            counts[name] = 0


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
    if err < 0:  # flash_attention's tensor-map encode
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with CUresult {-err}")
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


def gossip_mix(rows: torch.Tensor, mixing: torch.Tensor) -> torch.Tensor:
    """(k, P) float32 rows, (k, k) float32 mixing matrix -> (k, P) W @ rows,
    out of place, for any k >= 1."""
    if rows.ndim != 2:
        raise ValueError(f"rows must be (k, P), got {tuple(rows.shape)}")
    k, P = rows.shape
    _check(rows, "rows", torch.float32, (k, P), rows.device)
    _check(mixing, "mixing", torch.float32, (k, k), rows.device)
    if k < 1:
        raise ValueError("gossip_mix takes at least one row")
    if not _route(rows):
        return ref.gossip_mix_ref(rows, mixing)
    out = torch.empty((k, P), dtype=torch.float32, device=rows.device)
    if P == 0:
        return out
    err = _build.lib("gossip_mix").rt_gossip_mix(
        mixing.data_ptr(), rows.data_ptr(), out.data_ptr(), k, P, _vec(P, rows, out), _stream())
    _raise_on(err, "gossip_mix")
    launches["gossip_mix"] += 1
    return out


# head dims instantiated in csrc/flash_attention.cu: those of every config (32 when reduced)
FLASH_HEAD_DIMS = (32, 48, 64, 80, 128, 256)
# head dims of the tensor-core design (csrc/flash_wgmma.cuh), bf16 only: rows
# of whole 128-byte swizzle rows, and at 80 one 32-byte swizzle row more;
# bf16 at 32 and 48 (reduced configs only) runs the CUDA-core design
WGMMA_HEAD_DIMS = (64, 80, 128, 256)


def flash_design(dtype: torch.dtype, hd: int) -> str:
    """The kernel design a ``flash_attention`` launch takes: ``"wgmma"``
    (tensor cores, TMA) for bf16 at ``WGMMA_HEAD_DIMS``, else
    ``"cuda_core"`` (float32 products).  Decided before the launch; a launch
    never falls back to the other design."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "cuda_core"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, logit_cap: float = 0.0) -> torch.Tensor:
    """Attention with GQA: q (B, T, H, hd), k and v (B, S, K, hd), float32 or
    bfloat16, H % K == 0 -> (B, T, H, hd) in q's dtype.

    Query t sees key s when s <= t (``causal``) and s > t - ``window``; scores
    are ``logit_cap * tanh(s / logit_cap)`` when ``logit_cap > 0``; a row with
    no valid key gives zeros.  The inputs are read through their strides
    (the last dimension contiguous, base and other strides 16-byte aligned,
    on every device), so the (B, T, H, hd) layout needs no transposing copy.
    """
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q and k must be (B, T, H, hd) and (B, S, K, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k: shape {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} KV heads")
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {FLASH_HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or tuple(t.shape) != (B, S, K, hd):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, expected "
                             f"{q.dtype} {(B, S, K, hd)} on {q.device}")
    step = 16 // q.element_size()  # elements per 16-byte load of the kernel
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
        if t.data_ptr() % 16 or any(s % step for s in t.stride()[:3]):
            raise ValueError(f"{name}: base and strides {t.stride()} must be 16-byte aligned")
    if not _route(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, logit_cap=logit_cap)
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    design = flash_design(q.dtype, hd)
    err = _build.lib("flash_attention").rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, H, K, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal), window or 0,
        hd ** -0.5, float(logit_cap), int(q.dtype == torch.bfloat16), int(design == "wgmma"),
        _stream())
    _raise_on(err, "flash_attention")
    launches["flash_attention"] += 1
    flash_designs[design] += 1
    return out
