"""mixtral-8x22b — Mixtral of Experts [arXiv:2401.04088], 8x22B scale point.

56L, d_model 6144, 48 q-heads / 8 kv-heads (GQA), head_dim 128, d_ff 16384,
vocab 32768, 8 experts top-2, sliding-window attention (assignment card:
SWA, window 4096 as in the Mixtral/Mistral lineage).  SWA makes this MoE the
one assigned arch that runs ``long_500k`` with its *native* attention.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=32768,
        sliding_window=4096,
        rope_theta=1_000_000.0,
        act="silu",
        gated=True,
        moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        source="[arXiv:2401.04088] Mixtral of Experts; 8x22B model card (mistral.ai)",
    )
)
