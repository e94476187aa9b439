"""granite-3-8b [dense]: GQA kv=8.  40L d=4096 32H ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0 family]"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    head_dim=128,
    hidden_act="silu",
    tie_embeddings=True,
    analog=AnalogSpec(enabled=True, adc_bits=5, activation="silu"),
)

SMOKE = CONFIG.replace(
    name="granite-3-8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=255, vocab_pad_multiple=8,
)
