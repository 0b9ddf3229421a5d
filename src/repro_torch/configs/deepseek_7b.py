"""deepseek-7b — DeepSeek LLM 7B [arXiv:2401.02954], llama-architecture.

30L, d_model 4096, 32 heads MHA (kv=32), head_dim 128, d_ff 11008,
vocab 102400, SwiGLU, RMSNorm, RoPE.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-7b",
        family="dense",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab=102400,
        rope_theta=10_000.0,
        act="silu",
        gated=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        source="[arXiv:2401.02954] DeepSeek LLM (7B base config)",
    )
)
