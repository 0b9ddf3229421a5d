"""The four assigned input shapes (a copy of the JAX package's
``repro.configs.shapes``, less its ``jax.ShapeDtypeStruct`` builders).

Shapes (assigned):
    train_4k     seq_len=4,096    global_batch=256   (training)
    prefill_32k  seq_len=32,768   global_batch=32    (inference-prefill)
    decode_32k   seq_len=32,768   global_batch=128   (inference-decode: ONE
                 new token against a KV cache / recurrent state of seq_len)
    long_500k    seq_len=524,288  global_batch=1     (long-context decode)

``long_500k`` requires sub-quadratic attention.  ssm/hybrid archs run it
natively (O(1) state); mixtral's sliding window is native; the pure
full-attention dense/moe archs run it ONLY through the beyond-paper
sliding-window decode variant applied by :func:`cfg_for_shape`
(window 8192, flagged in the returned config name).  hubert (encoder-only)
has no decode step — both decode shapes are skipped (see ``skip_reason``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig

LONG_SWA_WINDOW = 8192  # beyond-paper long-context decode variant for dense archs


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """Non-None => this (arch, shape) pair is a documented skip."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return f"{cfg.name} is encoder-only: no autoregressive decode step"
    return None


def cfg_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-specific config adjustments.

    long_500k on a full-attention arch switches on the sliding-window decode
    variant (beyond-paper; window 8192) so the KV cache is O(window) instead
    of O(524k).  All other (arch, shape) pairs run the published config.
    """
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid") and cfg.sliding_window is None:
        return dataclasses.replace(cfg, sliding_window=LONG_SWA_WINDOW)
    return cfg
