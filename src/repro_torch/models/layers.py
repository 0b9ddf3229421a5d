"""Foundational NN layers of the LLM stack (port of ``repro.models.layers``).

Parameters are plain dicts of tensors in the reference's layout: layer
stacks carry a leading layer axis and weights are ``(d_in, d_out)``, used as
``x @ w``.  ``cdt(cfg)`` is the compute dtype; parameters are stored in
``cfg.param_dtype`` and cast on use.  Norms, rotary embeddings and the
attention softmax run in float32 inside and cast back, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}")
    return _DTYPES[name]


def pdt(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.param_dtype)


def cdt(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Initializers: float32 draws from ``gen`` (on its own device), then cast
# ---------------------------------------------------------------------------


def normal_init(gen: torch.Generator, shape, dtype, *, device, stddev: float = 0.02):
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * stddev).to(device=device, dtype=dtype)


def fanin_init(gen: torch.Generator, shape, dtype, *, device, scale: float = 1.0):
    """LeCun-normal on the penultimate axis (matmul contraction dim)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return normal_init(gen, shape, dtype, device=device, stddev=scale / (fan_in ** 0.5))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-6, plus_one: bool = False):
    """RMSNorm with float32 statistics, cast back to x.dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (y * w).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding (rotate-half form)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(T: int, d: int, dtype=torch.float32, device=None):
    """Classic sin/cos table for the encoder-only (hubert) stack."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    rate = torch.tensor(-math.log(10000.0), dtype=torch.float32) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * rate.to(device))
    tab = torch.zeros((T, d), dtype=torch.float32, device=device)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab.to(dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":  # the reference's jax.nn.gelu(approximate=True)
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}")


def softcap(x, cap: float):
    """grok/gemma-style tanh soft-capping of logits; no-op when cap == 0."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)
