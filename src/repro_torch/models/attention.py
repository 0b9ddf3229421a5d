"""Grouped-query attention: full-sequence path and cached decode path (port
of ``repro.models.attention``).

Every attention variant of the assigned architectures: GQA with any
(n_heads, n_kv_heads) split, qkv projection bias (qwen2, internvl2), per-head
q/k RMSNorm (qwen3), sliding windows (mixtral), tanh logit soft-capping
(grok-1) and bidirectional masking (hubert).

``attention_forward(..., use_flash=True)`` runs the hand-written
``flash_attention`` kernel (``kernels/ops.py``) on the (B, T, H, hd)
projections as they are; without the flag it runs :func:`attend_full`, or
:func:`attend_banded` when ``cfg.banded_swa`` applies, as the reference does.

The decode path is a ring-buffer KV cache: for full-context decode it covers
the whole sequence, for sliding-window decode only the window.  Slot ->
absolute-position bookkeeping (``slot_pos``) keeps the masking exact in both
cases.  Unlike the reference, :func:`attention_decode` writes the new K/V
into the cache tensors in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF, attention_mask
from repro_torch.models.layers import apply_rope, cdt, fanin_init, pdt, rms_norm, softcap

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, *, device,
                   n_stack: Optional[int] = None, d_in: Optional[int] = None):
    """Attention parameter dict; ``n_stack`` adds a leading layer axis and
    ``d_in`` overrides the input width."""
    d = d_in or cfg.d_model
    hd = cfg.resolved_head_dim
    stack = (n_stack,) if n_stack else ()
    dt = pdt(cfg)
    p = {
        "wq": fanin_init(gen, (*stack, d, cfg.q_dim), dt, device=device),
        "wk": fanin_init(gen, (*stack, d, cfg.kv_dim), dt, device=device),
        "wv": fanin_init(gen, (*stack, d, cfg.kv_dim), dt, device=device),
        "wo": fanin_init(gen, (*stack, cfg.q_dim, cfg.d_model), dt, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*stack, cfg.q_dim), dtype=dt, device=device)
        p["bk"] = torch.zeros((*stack, cfg.kv_dim), dtype=dt, device=device)
        p["bv"] = torch.zeros((*stack, cfg.kv_dim), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*stack, hd), dtype=dt, device=device)
        p["k_norm"] = torch.ones((*stack, hd), dtype=dt, device=device)
    return p


def _project_qkv(p, cfg: ModelConfig, x, positions):
    """x: (B, T, d_in) -> q (B,T,H,hd), k,v (B,T,K,hd), roped + normed."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = cdt(cfg)
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"].to(dt))
        k = rms_norm(k, p["k_norm"].to(dt))
    if cfg.causal:  # rope only on decoder stacks; hubert uses sinusoidal abs pos
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k, v, G: int):
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    return k, v


def attend_full(q, k, v, *, causal: bool, window: Optional[int], logit_cap: float,
                q_offset: int = 0, probs_bf16: bool = False):
    """Plain attention. q: (B,Tq,H,hd); k,v: (B,Tk,K,hd); GQA via repeat.

    ``q_offset`` is the absolute position of q[0] relative to k[0].  Scores
    and softmax in float32; a fully masked row gets the mean of v, as in the
    reference (no T == S input has one).
    """
    B, Tq, H, hd = q.shape
    k, v = _repeat_kv(k, v, H // k.shape[2])
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * hd ** -0.5
    scores = softcap(scores, logit_cap)
    mask = attention_mask(Tq, k.shape[1], causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    if probs_bf16:  # bf16 probabilities into the PV product, as the reference
        out = torch.einsum("bhts,bshd->bthd", probs.bfloat16(), v.bfloat16())
    else:
        out = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return out.to(v.dtype)


def attend_banded(q, k, v, *, window: int, logit_cap: float, probs_bf16: bool = False):
    """Banded sliding-window attention, exact: query block i (block size W)
    sees only key blocks i-1 and i, so scores are (B, nb, H, W, 2W)."""
    B, T, H, hd = q.shape
    k, v = _repeat_kv(k, v, H // k.shape[2])
    W = window
    nb = -(-T // W)
    pad = nb * W - T
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    qb = q.reshape(B, nb, W, H, hd)
    kb = k.reshape(B, nb, W, H, hd)
    vb = v.reshape(B, nb, W, H, hd)
    # keys of block i = concat(block i-1, block i): (B, nb, 2W, H, hd)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1), kb], 2)
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1), vb], 2)
    scores = torch.einsum("bnthd,bnshd->bnhts", qb.float(), k2.float()) * hd ** -0.5
    scores = softcap(scores, logit_cap)
    t_rel = torch.arange(W, device=q.device)[:, None]
    s_rel = torch.arange(2 * W, device=q.device)[None, :] - W  # relative to the block start
    mask = (s_rel <= t_rel) & (s_rel > t_rel - W)
    blk = torch.arange(nb, device=q.device)[:, None, None]
    valid_key = blk * W + s_rel >= 0  # (nb, W, 2W): block 0 has no predecessor
    full = mask[None, None, None] & valid_key[None, :, None]
    probs = torch.softmax(torch.where(full, scores, NEG_INF), dim=-1)
    if probs_bf16:  # bf16 probabilities into the PV product, as the reference
        probs, v2 = probs.bfloat16(), v2.bfloat16()
    else:
        v2 = v2.float()
    out = torch.einsum("bnhts,bnshd->bnthd", probs, v2)
    return out.reshape(B, nb * W, H, hd)[:, :T].float().to(v.dtype)


def attention_forward(p, cfg: ModelConfig, x, positions=None, use_flash: bool = False):
    """Full-sequence attention (training / prefill). x: (B, T, d_in)."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    W = cfg.sliding_window
    if use_flash:
        out = kops.flash_attention(q, k, v, causal=cfg.causal, window=W,
                                   logit_cap=cfg.attn_logit_softcap)
    elif cfg.banded_swa and cfg.causal and W is not None and T >= 2 * W:
        out = attend_banded(q, k, v, window=W, logit_cap=cfg.attn_logit_softcap,
                            probs_bf16=cfg.probs_bf16)
    else:
        out = attend_full(q, k, v, causal=cfg.causal, window=W,
                          logit_cap=cfg.attn_logit_softcap, probs_bf16=cfg.probs_bf16)
    return out.reshape(B, T, -1) @ p["wo"].to(cdt(cfg))


# ---------------------------------------------------------------------------
# Decode (ring-buffer KV cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                  n_stack: Optional[int] = None):
    """Cache dict. ``max_len`` = full context, or window size under SWA."""
    C = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    stack = (n_stack,) if n_stack else ()
    shape = (*stack, batch, C, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=cdt(cfg), device=device),
        "v": torch.zeros(shape, dtype=cdt(cfg), device=device),
        "slot_pos": torch.full((*stack, C), -1, dtype=torch.int32, device=device),
    }


def attention_decode(p, cfg: ModelConfig, x, cache, pos: torch.Tensor):
    """One-token decode. x: (B, 1, d_in); pos: 0-dim int tensor, the absolute
    position.

    Writes the new K/V into slot ``pos % C`` of ``cache`` in place (ring
    buffer) and attends over every slot whose recorded absolute position is
    valid, causal, and within the sliding window.  Returns (y, cache).
    """
    B = x.shape[0]
    C = cache["k"].shape[-3]
    q, k_new, v_new = _project_qkv(p, cfg, x, pos.reshape(1, 1).expand(B, 1))

    slot = (pos % C).reshape(1).long()
    cache["k"].index_copy_(1, slot, k_new)
    cache["v"].index_copy_(1, slot, v_new)
    cache["slot_pos"].index_copy_(0, slot, pos.reshape(1).to(torch.int32))
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]

    hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
    qg = q.reshape(B, K, cfg.n_heads // K, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float()) * hd ** -0.5
    scores = softcap(scores, cfg.attn_logit_softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if cfg.sliding_window is not None:
        valid &= slot_pos > pos - cfg.sliding_window
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v.float())
    out = out.reshape(B, 1, cfg.q_dim).to(cdt(cfg))
    return out @ p["wo"].to(cdt(cfg)), cache
