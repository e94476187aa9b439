"""kws_lstm: the paper's keyword-spotting model (Methods).

LSTM(input=40 MFCC features, hidden=32) -> FC(32 -> 12 classes); sequence
length 49; 9216 weights in a 72x128 crossbar.  All four gates + the cell tanh
run through the 5-bit NL-ADC with full analog noise simulation.
"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="kws_lstm",
    family="lstm",
    n_layers=1,
    d_model=32,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=0,
    head_dim=0,
    lstm_hidden=32,
    n_input_features=40,
    n_classes=12,
    analog=AnalogSpec(enabled=True, adc_bits=5, input_bits=5, mode="infer"),
)

SMOKE = CONFIG.replace(name="kws_lstm-smoke", lstm_hidden=8, d_model=8)
