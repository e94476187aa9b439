"""qwen2.5-32b [dense]: GQA + QKV bias.  64L d=5120 40H kv=8 ff=27648
vocab=152064.  [hf:Qwen/Qwen2.5-0.5B family]"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    hidden_act="silu",
    rope_theta=1_000_000.0,
    analog=AnalogSpec(enabled=True, adc_bits=5, activation="silu"),
)

SMOKE = CONFIG.replace(
    name="qwen2.5-32b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=160, vocab=256, vocab_pad_multiple=8,
)
