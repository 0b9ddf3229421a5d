"""qwen3-0.6b — Qwen3 family [hf:Qwen/Qwen3-8B lineage, 0.6B card].

28L, d_model 1024, 16 q-heads / 8 kv-heads, head_dim 128 (explicit — larger
than d_model/n_heads), d_ff 3072, vocab 151936; per-head q/k RMSNorm
("qk_norm"); no qkv bias; tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab=151936,
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        act="silu",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        gated=True,
        source="[hf:Qwen/Qwen3-8B] family card (0.6B config: qk_norm, GQA)",
    )
)
