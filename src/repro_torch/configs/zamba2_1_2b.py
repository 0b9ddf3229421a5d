"""zamba2-1.2b — Zamba2 [arXiv:2411.15242], hybrid Mamba2 + shared attention.

38 Mamba-2 layers, d_model 2048 (d_inner 4096, headdim 64 -> 64 SSM heads,
state N=64), vocab 32000.  A single *shared* attention+MLP block (32 heads,
head_dim 64, d_ff 8192) is interleaved every 6 layers, consuming
concat(hidden, initial embedding) (2*d_model input) with per-site LoRA
deltas on q/k/v — the Zamba2 parameter-sharing scheme.

Recurrent decode state is O(1) in context length ⇒ runs ``long_500k``
natively.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab=32000,
        ssm=SSMConfig(state=64, expand=2, headdim=64, conv=4, chunk=128),
        shared_attn_every=6,
        shared_attn_lora_rank=16,
        tie_embeddings=True,
        act="gelu",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        gated=True,
        source="[arXiv:2411.15242] Zamba2 (1.2B: Mamba2 backbone, shared attn blocks)",
    )
)
