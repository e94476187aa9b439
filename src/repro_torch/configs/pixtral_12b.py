"""pixtral-12b [vlm]: Pixtral-ViT frontend (stub) + Mistral-Nemo-style decoder.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128
(Nemo projects 5120 -> 32*128=4096 for Q).  [hf:mistralai/Pixtral-12B-2409]
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings that overwrite the first ``n_patches`` token positions.
"""

from repro_torch.configs.base import AnalogSpec, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    hidden_act="silu",
    rope_theta=1_000_000.0,
    modality="vision",
    n_patches=256,
    analog=AnalogSpec(enabled=True, adc_bits=5, activation="silu"),
)

SMOKE = CONFIG.replace(
    name="pixtral-12b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=256, n_patches=4, vocab_pad_multiple=8,
)
