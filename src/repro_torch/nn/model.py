"""Model factory: one entry point for the ported LM architectures."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build(cfg: ModelConfig, device=None):
    """Return the model object for a config, its ramps on ``device``:
    ``cuda`` unless the caller asks for another (``device="cpu"``); without
    a GPU the default raises."""
    if cfg.family == "lstm":
        raise ValueError(
            "LSTM workloads use repro_torch.nn.lstm directly (see "
            "repro_torch.launch.lstm_eval)")
    from repro_torch.nn.transformer import LM

    return LM(cfg, device)
