"""xlstm-125m — xLSTM [arXiv:2405.04517], 125M scale point.

12 blocks alternating sLSTM/mLSTM, d_model 768, 4 heads, vocab 50304
(GPT-NeoX tokenizer rounding), d_ff = 0 — the up/down projections
(proj-factor 2) live inside the mLSTM block, per the paper's 125M config.
O(1) recurrent decode state ⇒ runs ``long_500k`` natively.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        xlstm=True,
        xlstm_proj_factor=2.0,
        act="gelu",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        gated=False,
        source="[arXiv:2405.04517] xLSTM (125M: sLSTM + mLSTM blocks)",
    )
)
