"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain MLP (port of
``repro.models.ffn``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_fn, cdt, fanin_init, pdt


def init_ffn(gen: torch.Generator, cfg: ModelConfig, *, device,
             n_stack: Optional[int] = None) -> dict[str, torch.Tensor]:
    stack = (n_stack,) if n_stack else ()
    d, f, dt = cfg.d_model, cfg.d_ff, pdt(cfg)
    p = {
        "w1": fanin_init(gen, (*stack, d, f), dt, device=device),
        "w2": fanin_init(gen, (*stack, f, d), dt, device=device),
    }
    if cfg.gated:
        p["w3"] = fanin_init(gen, (*stack, d, f), dt, device=device)
    return p


def ffn_forward(p, cfg: ModelConfig, x):
    """x: (..., d_model) -> (..., d_model)."""
    dt = cdt(cfg)
    h = act_fn(cfg.act)(x @ p["w1"].to(dt))
    if cfg.gated:
        h = h * (x @ p["w3"].to(dt))
    return h @ p["w2"].to(dt)
