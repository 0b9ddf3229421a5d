"""qwen2-0.5b — Qwen2 technical report [arXiv:2407.10671].

24L, d_model 896, 14 q-heads / 2 kv-heads, head_dim 64, d_ff 4864,
vocab 151936; QKV projection bias; tied embeddings; rope theta 1e6.
The paper-scale "edge client" model of the pool.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        act="silu",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        gated=True,
        source="[arXiv:2407.10671] Qwen2 Technical Report (0.5B config)",
    )
)
