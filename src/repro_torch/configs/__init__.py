"""Model configs: the paper's KWS and PTB LSTM workloads, qwen2.5-3b, the
MoE LMs moonshot-v1-16b-a3b and deepseek-moe-16b, and the recurrent LMs
mamba2-370m (SSD) and recurrentgemma-9b (RG-LRU with local attention).

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
