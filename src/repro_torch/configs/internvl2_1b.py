"""internvl2-1b — InternVL2 [arXiv:2404.16821], 1B scale point.

VLM: InternViT-300M vision encoder + Qwen2-0.5B language backbone.  The
vision tower is a STUB — the model takes precomputed patch embeddings
(frontend_dim 1024 = InternViT hidden size, 256 patches after
pixel-shuffle) and we implement the language/decoder transformer that
consumes them through a learned projector.

Backbone: 24L, d_model 896, 14 q / 2 kv heads, head_dim 64, d_ff 4864,
vocab 151655 (Qwen2 tokenizer + InternVL special tokens), QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab=151655,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        act="silu",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        gated=True,
        frontend="vision",
        frontend_dim=1024,
        n_patches=256,
        source="[arXiv:2404.16821] InternVL2 (1B: InternViT-300M + Qwen2-0.5B)",
    )
)
