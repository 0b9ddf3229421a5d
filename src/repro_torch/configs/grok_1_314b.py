"""grok-1-314b — xAI Grok-1 [hf:xai-org/grok-1].

64L, d_model 6144, 48 q-heads / 8 kv-heads, head_dim 128, d_ff 32768,
vocab 131072, 8 experts top-2.  Grok-1 applies tanh soft-capping (30.0) to
attention logits.  314B total / ~86B active parameters — the stress test for
the secure-aggregation quantizer and the adafactor dry-run memory budget.
Full (non-windowed) attention natively; ``long_500k`` runs only through the
beyond-paper sliding-window decode variant (see configs/shapes.py).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab=131072,
        rope_theta=10_000.0,
        attn_logit_softcap=30.0,
        final_logit_softcap=30.0,
        act="gelu",
        gated=True,
        moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        source="[hf:xai-org/grok-1] model card / released JAX weights config",
    )
)
