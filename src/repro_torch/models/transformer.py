"""The LLM stack of the dense, vlm and audio families (port of
``repro.models.transformer``).

dense / vlm : pre-norm decoder blocks (attention + FFN).
audio       : encoder-only (bidirectional) blocks over projected frames.

Layer parameters are stacked on a leading axis, in the reference's layout,
and the stack is a loop over that axis.  The moe, ssm (xlstm), and hybrid
(zamba2) families are not ported yet (``ROADMAP.md`` §2 item 1): every entry
point raises ``NotImplementedError`` for them.

Public API
----------
init_model(gen, cfg, device=)                -> params
forward(params, cfg, batch, use_flash=False) -> (logits fp32, aux)   [prefill]
init_decode_state(cfg, batch, max_len, device=) -> state
decode_step(params, cfg, token, state)       -> (logits, state)
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import cdt, normal_init, pdt, rms_norm, sinusoidal_positions, softcap

PORTED_FAMILIES = ("dense", "vlm", "audio")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES or cfg.xlstm:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md, open items, section 1, item 2: the rest of the LLM zoo, "
            f"the moe, ssm, hybrid and xlstm stacks)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_model(gen: torch.Generator, cfg: ModelConfig, *, device) -> dict[str, Any]:
    """Random parameters in the reference's layout and dtypes, drawn from ``gen``."""
    _require_ported(cfg)
    dt, L, d = pdt(cfg), cfg.n_layers, cfg.d_model
    p: dict[str, Any] = {
        "embed": normal_init(gen, (cfg.vocab, d), dt, device=device),
        "ln_f": torch.ones((d,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = normal_init(gen, (d, cfg.vocab), dt, device=device)
    if cfg.frontend in ("vision", "audio"):
        p["proj"] = normal_init(gen, (cfg.frontend_dim, d), dt, device=device)
    if cfg.frontend == "audio":
        p["mask_emb"] = normal_init(gen, (d,), dt, device=device)
    blocks = {
        "ln1": torch.ones((L, d), dtype=dt, device=device),
        "ln2": torch.ones((L, d), dtype=dt, device=device),
    }
    blocks.update(attn.init_attention(gen, cfg, device=device, n_stack=L))
    blocks.update(ffn_mod.init_ffn(gen, cfg, device=device, n_stack=L))
    p["blocks"] = blocks
    return p


# ---------------------------------------------------------------------------
# Embedding & heads
# ---------------------------------------------------------------------------


def embed_tokens(p, cfg: ModelConfig, tokens):
    x = F.embedding(tokens, p["embed"]).to(cdt(cfg))
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt(cfg), device=x.device)
    return x


def lm_logits(p, cfg: ModelConfig, h):
    h = rms_norm(h, p["ln_f"])
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    logits = h @ head.to(cdt(cfg))
    return softcap(logits.float(), cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------


def _layer(stacked: dict, i: int) -> dict:
    return {name: a[i] for name, a in stacked.items()}


def _scan_stack(block, carry, stacked: dict, length: int):
    """Run ``block(carry, layer_params) -> carry`` over a layer stack."""
    for i in range(length):
        carry = block(carry, _layer(stacked, i))
    return carry


def _dense_stack(p, cfg: ModelConfig, x, use_flash: bool):
    """Uniform attention blocks. Returns (h, aux); aux is the MoE loss, 0 here."""

    def block(h, bp):
        h = h + attn.attention_forward(bp, cfg, rms_norm(h, bp["ln1"]), use_flash=use_flash)
        return h + ffn_mod.ffn_forward(bp, cfg, rms_norm(h, bp["ln2"]))

    h = _scan_stack(block, x, p["blocks"], cfg.n_layers)
    return h, torch.zeros((), dtype=torch.float32, device=x.device)


def _assemble_inputs(p, cfg: ModelConfig, batch):
    """Family-specific input embedding: (B, T, d_model)."""
    dt = cdt(cfg)
    if cfg.family == "vlm":
        patches = batch["patches"].to(dt) @ p["proj"].to(dt)  # (B, n_patch, d)
        if cfg.scale_embed:
            patches = patches * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=patches.device)
        return torch.cat([patches, embed_tokens(p, cfg, batch["tokens"])], dim=1)
    if cfg.family == "audio":
        x = batch["frames"].to(dt) @ p["proj"].to(dt)  # (B, T, d)
        x = torch.where(batch["mask"][..., None], p["mask_emb"].to(dt), x)
        return x + sinusoidal_positions(x.shape[1], cfg.d_model, dt, device=x.device)[None]
    return embed_tokens(p, cfg, batch["tokens"])


def forward(p, cfg: ModelConfig, batch, use_flash: bool = False):
    """Full-sequence forward. Returns (logits fp32, moe_aux)."""
    _require_ported(cfg)
    h, aux = _dense_stack(p, cfg, _assemble_inputs(p, cfg, batch), use_flash)
    return lm_logits(p, cfg, h), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *, device):
    """Decode state: position (0-dim int32) and the stacked ring-buffer KV cache."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} ({cfg.family}) has no autoregressive decode step")
    _require_ported(cfg)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "cache": attn.init_kv_cache(cfg, batch, max_len, device=device, n_stack=cfg.n_layers)}


def decode_step(p, cfg: ModelConfig, token, state):
    """token: (B, 1) int -> (logits (B, 1, V), new state). One position.

    The KV cache tensors of ``state`` are updated in place; the returned
    state holds them and the next position.
    """
    _require_ported(cfg)
    pos = state["pos"]
    h = embed_tokens(p, cfg, token)
    cache = state["cache"]
    for i in range(cfg.n_layers):
        bp = _layer(p["blocks"], i)
        y, _ = attn.attention_decode(bp, cfg, rms_norm(h, bp["ln1"]), _layer(cache, i), pos)
        h = h + y
        h = h + ffn_mod.ffn_forward(bp, cfg, rms_norm(h, bp["ln2"]))
    return lm_logits(p, cfg, h), dict(state, pos=pos + 1)
