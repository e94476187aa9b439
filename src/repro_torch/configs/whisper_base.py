"""whisper-base [audio]: enc-dec transformer, conv frontend stubbed.

6L encoder + 6L decoder, d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
[arXiv:2212.04356]  The conv/mel frontend is a STUB: the model takes
precomputed frame embeddings (batch, enc_len, d_model).
"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=12,          # 6 enc + 6 dec
    n_enc_layers=6,
    n_dec_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    head_dim=64,
    hidden_act="gelu",
    qkv_bias=True,
    enc_len=1500,
    modality="audio",
    analog=AnalogSpec(enabled=True, adc_bits=5, activation="gelu"),
)

SMOKE = CONFIG.replace(
    name="whisper-base-smoke", n_layers=4, n_enc_layers=2, n_dec_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=128,
    enc_len=16, vocab_pad_multiple=8, max_position=64,
)
