"""qwen2.5-3b [dense]: GQA kv=2 + QKV bias.  36L d=2048 16H ff=11008
vocab=151936.  [hf:Qwen/Qwen2.5-0.5B family]"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    hidden_act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    analog=AnalogSpec(enabled=True, adc_bits=5, activation="silu"),
)

SMOKE = CONFIG.replace(
    name="qwen2.5-3b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=160, vocab=256, vocab_pad_multiple=8,
)
