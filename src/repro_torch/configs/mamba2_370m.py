"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.

48L d=1024 vocab=50280 ssm_state=128 headdim=64 expand=2.  [arXiv:2405.21060]"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    head_dim=0,
    hidden_act="silu",
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,   # keeps the (B,NC,Q,Q,H) intra-chunk decay in budget
    conv_width=4,
    tie_embeddings=True,
    analog=AnalogSpec(enabled=True, adc_bits=5, activation="silu"),
)

SMOKE = CONFIG.replace(
    name="mamba2-370m-smoke", n_layers=2, d_model=64, ssm_state=16,
    ssm_headdim=16, ssm_chunk=16, vocab=256, vocab_pad_multiple=8,
)
