"""hubert-xlarge — HuBERT X-Large [arXiv:2106.07447] (w2v2 encoder arch).

48L encoder-only transformer, d_model 1280, 16 heads MHA, head_dim 80,
d_ff 5120 (plain GELU MLP, not gated), output vocab 504 (k-means codebook
targets of the masked-prediction objective).

The conv waveform feature extractor is a STUB: the model takes
precomputed 512-dim frame embeddings; we implement
the transformer that consumes them (learned projection + sinusoidal
positions) with the HuBERT masked-prediction loss.

Encoder-only ⇒ no autoregressive decode: ``decode_32k`` and ``long_500k``
are skipped for this arch (``configs.shapes.skip_reason``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab=504,
        causal=False,
        act="gelu",
        gated=False,
        frontend="audio",
        frontend_dim=512,
        mask_prob=0.08,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        source="[arXiv:2106.07447] HuBERT (X-Large encoder; w2v2 architecture)",
    )
)
