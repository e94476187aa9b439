"""granite-34b [dense]: llama-arch code model, MQA (kv=1).
88L d=6144 48H kv=1 ff=24576 vocab=49152.  [arXiv:2405.04324]"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    hidden_act="gelu",           # granite code models use gelu MLPs
    analog=AnalogSpec(enabled=True, adc_bits=5, activation="gelu"),
)

SMOKE = CONFIG.replace(
    name="granite-34b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    head_dim=16, d_ff=128, vocab=256, vocab_pad_multiple=8,
)
