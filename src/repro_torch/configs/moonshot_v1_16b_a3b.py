"""moonshot-v1-16b-a3b [moe]: kimi/moonlight fine-grained MoE, 64e top-6.

48L d=2048 16H (kv=16) d_ff=1408/expert vocab=163840, 2 shared experts.
[hf:moonshotai/Moonlight-16B-A3B]"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    head_dim=128,
    hidden_act="silu",
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    capacity_factor=1.0,
    router_score="sigmoid",      # moonlight: sigmoid scores, normalized top-k
    analog=AnalogSpec(enabled=True, adc_bits=5, activation="silu"),
)

SMOKE = CONFIG.replace(
    name="moonshot-v1-16b-a3b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=32, vocab=256, n_experts=8, top_k=2,
    n_shared_experts=1, vocab_pad_multiple=8,
)
