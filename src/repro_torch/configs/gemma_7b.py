"""gemma-7b — Gemma [arXiv:2403.08295].

28L, d_model 3072, 16 heads (MHA on 7B; MQA is the 2B variant), head_dim 256
(explicit — 16*256 = 4096 > d_model), d_ff 24576 with GeGLU, vocab 256000,
embeddings scaled by sqrt(d_model) and tied with the output head.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab=256000,
        rope_theta=10_000.0,
        act="gelu",
        gated=True,
        tie_embeddings=True,
        scale_embed=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        source="[arXiv:2403.08295] Gemma (7B config: GeGLU, head_dim 256)",
    )
)
