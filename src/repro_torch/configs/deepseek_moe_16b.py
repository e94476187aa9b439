"""deepseek-moe-16b [moe]: fine-grained MoE, 2 shared + 64 routed top-6.

28L d=2048 16H (kv=16) d_ff=1408/expert vocab=102400.  [arXiv:2401.06066]"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    hidden_act="silu",
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    capacity_factor=1.0,
    analog=AnalogSpec(enabled=True, adc_bits=5, activation="silu"),
)

SMOKE = CONFIG.replace(
    name="deepseek-moe-16b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=32, vocab=256, n_experts=8, top_k=2,
    n_shared_experts=1, vocab_pad_multiple=8,
)
