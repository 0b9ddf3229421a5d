"""Model/architecture configuration dataclasses and the config registry.

Every assigned architecture gets one module in ``repro_torch/configs/<id>.py`` that
exports ``CONFIG`` (the exact published configuration, with its source cited)
and registers itself.  ``ModelConfig.reduced()`` derives the CPU smoke-test
variant (<=2 layers, d_model<=512, <=4 experts) of the *same family*.
A copy of the JAX package's ``repro.configs.base``: the same fields,
defaults, counts and registry.  ``remat`` and ``scan_layers`` are kept as
data; the port's stacks are plain loops and ignore them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 0          # N, the SSM state size per head
    expand: int = 2         # d_inner = expand * d_model
    headdim: int = 64       # mamba2 head dim (d_inner/headdim heads)
    conv: int = 4           # depthwise causal conv width
    chunk: int = 128        # SSD chunk length (training path)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- attention ---
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q,k
    qkv_bias: bool = False           # qwen2-style bias on qkv projections
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    causal: bool = True              # False => encoder-only (hubert)
    attn_logit_softcap: float = 0.0  # grok/gemma2-style tanh soft-capping (0=off)
    # --- ffn ---
    act: str = "silu"                # activation for the gated MLP ("silu"|"gelu")
    gated: bool = True               # gated (SwiGLU/GeGLU) vs plain MLP
    # --- mixtures / recurrences ---
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    shared_attn_every: int = 0       # zamba2: shared attn block period (0=off)
    shared_attn_lora_rank: int = 16  # zamba2: per-site LoRA rank on the shared block
    xlstm: bool = False              # alternating sLSTM/mLSTM stack
    xlstm_proj_factor: float = 2.0   # mLSTM up-projection factor
    # --- embeddings / output ---
    tie_embeddings: bool = False
    scale_embed: bool = False        # gemma: embeddings * sqrt(d_model)
    final_logit_softcap: float = 0.0
    # --- modality frontend stub (precomputed embeddings) ---
    frontend: Optional[str] = None   # None | "audio" | "vision"
    frontend_dim: int = 0            # feature dim of the precomputed embeddings
    n_patches: int = 0               # vlm: image patches prepended per example
    mask_prob: float = 0.08          # audio: masked-prediction corruption rate
    # --- numerics / memory ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False              # rematerialize blocks in the scan
    scan_layers: bool = True         # lax.scan over layers (False: unroll —
                                     # used by the dry-run for exact per-layer
                                     # collective accounting in the HLO)
    banded_swa: bool = False         # beyond-paper: banded sliding-window
                                     # attention (exact; §Perf hillclimb)
    probs_bf16: bool = False         # beyond-paper: bf16 attention probs
                                     # for the PV matmul (§Perf hillclimb)
    moe_batched_dispatch: bool = False  # beyond-paper: batch-preserving MoE
                                     # dispatch (keeps tokens data-sharded)
    # --- provenance ---
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_decode(self) -> bool:
        return self.causal and self.family != "cnn"

    @property
    def subquadratic(self) -> bool:
        """True when long-context decode is O(1)/O(window) per token."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and reporting)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab * d
        out = 0 if self.tie_embeddings else self.vocab * d
        per_layer = 0
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.gated:
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        if self.family == "moe":
            ffn = self.moe.n_experts * ffn + d * self.moe.n_experts
        if self.family in ("dense", "moe", "vlm", "audio"):
            per_layer = attn + ffn + 2 * d
        elif self.family == "ssm" and self.xlstm:
            # rough: mLSTM ~ 4*d*d_in + d_in*d ; sLSTM ~ 4*(d*d + d*d/heads)
            d_in = int(self.xlstm_proj_factor * d)
            per_layer = (4 * d * d_in + d_in * d + 4 * d * d + 4 * d * d) // 2
        elif self.family in ("ssm", "hybrid"):
            d_inner = self.ssm.expand * d
            nheads = d_inner // self.ssm.headdim
            per_layer = d * (2 * d_inner + 2 * self.ssm.state * 1 + nheads) + d_inner * d
            if self.family == "hybrid" and self.shared_attn_every:
                per_layer += (attn + 2 * d) // max(1, self.n_layers // self.shared_attn_every) // max(1, self.n_layers)
        total = emb + out + self.n_layers * per_layer + d
        if self.frontend == "vision":
            total += self.frontend_dim * d
        if self.frontend == "audio":
            total += self.frontend_dim * d
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe" or not self.moe.n_experts:
            return self.param_count()
        d = self.d_model
        ffn_one = (3 if self.gated else 2) * d * self.d_ff
        dense_part = self.param_count() - self.n_layers * self.moe.n_experts * ffn_one
        return int(dense_part + self.n_layers * self.moe.top_k * ffn_one)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family (2 layers, d<=512, <=4 experts)."""
        layers = 2 if not self.xlstm else 2  # xlstm pairs -> keep 2 (1 sLSTM + 1 mLSTM)
        d_model = min(self.d_model, 128)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        hd = 32 if self.head_dim else 0
        changes = dict(
            name=self.name + "-smoke",
            n_layers=layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 256),
            vocab=min(self.vocab, 512),
            moe=dataclasses.replace(self.moe, n_experts=min(self.moe.n_experts, 4)) if self.moe.n_experts else self.moe,
            ssm=dataclasses.replace(self.ssm, state=min(self.ssm.state, 16), headdim=16, chunk=16) if self.ssm.state else self.ssm,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            scan_layers=True,
        )
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False

ASSIGNED = [
    "mixtral-8x22b",
    "internvl2-1b",
    "qwen2-0.5b",
    "hubert-xlarge",
    "zamba2-1.2b",
    "qwen3-0.6b",
    "deepseek-7b",
    "grok-1-314b",
    "xlstm-125m",
    "gemma-7b",
]


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import importlib

    for mod in ASSIGNED + ["resnet_tiny"]:
        importlib.import_module("repro_torch.configs." + mod.replace("-", "_").replace(".", "_"))
