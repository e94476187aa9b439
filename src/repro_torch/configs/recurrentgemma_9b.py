"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent.

38L d=4096 16H (kv=1 in local-attn MQA) d_ff=12288 vocab=256000, window=2048.
[arXiv:2402.19427 (Griffin)]"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    hidden_act="gelu",            # GeGLU MLP
    block_pattern=("rec", "rec", "attn"),
    window=2048,
    lru_width=4096,
    lru_gate_blocks=16,   # Griffin: block-diagonal gates, one per head
    analog=AnalogSpec(enabled=True, adc_bits=5, activation="gelu"),
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-9b-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=1, head_dim=16, d_ff=128, vocab=256, window=8, lru_width=64,
    vocab_pad_multiple=8,
)
