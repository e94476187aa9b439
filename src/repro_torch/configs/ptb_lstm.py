"""ptb_lstm: the paper's character-prediction model (Methods).

LSTM-with-projection (input=128 random-orthogonal char embedding,
hidden=2016, proj=504) -> FC(504 -> 50 chars); sequence length 128.
6,112,512 weights on a logical 633x8064 crossbar (16 physical 633x512 tiles,
3-phase input presentation).
"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="ptb_lstm",
    family="lstm",
    n_layers=1,
    d_model=504,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50,
    head_dim=0,
    lstm_hidden=2016,
    lstm_proj=504,
    n_input_features=128,
    n_classes=50,
    analog=AnalogSpec(enabled=True, adc_bits=5, input_bits=5, mode="infer"),
)

SMOKE = CONFIG.replace(
    name="ptb_lstm-smoke", lstm_hidden=32, lstm_proj=16, d_model=16,
    n_input_features=16,
)
