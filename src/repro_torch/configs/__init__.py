"""Model configs: the paper's KWS and PTB LSTM workloads, the dense LMs
qwen2.5-3b, granite-3-8b, qwen2.5-32b, pixtral-12b (a decoder whose first
positions take vision patch embeddings) and granite-34b (MQA, a plain
gelu MLP), the encoder-decoder whisper-base (audio frame embeddings into
its encoder), the MoE LMs moonshot-v1-16b-a3b and deepseek-moe-16b, and the
recurrent LMs mamba2-370m (SSD) and recurrentgemma-9b (RG-LRU with local
attention).

``get(name)`` returns the published config, ``get_smoke(name)`` a reduced
same-family variant for CPU tests.
"""

from repro_torch.configs.base import (  # noqa: F401
    ARCH_NAMES,
    AnalogSpec,
    ModelConfig,
    get,
    get_smoke,
)
