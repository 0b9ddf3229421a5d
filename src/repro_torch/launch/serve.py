"""Serving steps: prefill (full-sequence forward) and decode (port of
``repro.launch.serve``'s step builders).

  * ``make_prefill_step`` — batched full-sequence forward returning logits,
    with plain attention, as the reference's.  The flash path is
    ``transformer.forward(params, cfg, batch, use_flash=True)``.
  * ``make_decode_step``  — ONE new token against the KV cache, exactly
    ``transformer.decode_step``.

The reference's ``jit_*`` builders and sharding helpers are mesh code; they
wait for the sharded slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def make_prefill_step(cfg: ModelConfig):
    def prefill(params, batch):
        logits, _ = transformer.forward(params, cfg, batch)
        return logits

    return prefill


def make_decode_step(cfg: ModelConfig):
    def decode(params, token, state):
        return transformer.decode_step(params, cfg, token, state)

    return decode
