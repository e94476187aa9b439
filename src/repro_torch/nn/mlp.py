"""MLPs with the NL-ADC epilogue on the gate nonlinearity.

Three variants, chosen per family as in the JAX package:

* ``swiglu`` — silu-gated (llama/qwen/moe experts): the silu output is the
  paper's non-monotonic swish NL-ADC;
* ``geglu``  — gelu-gated (recurrentgemma): gelu NL-ADC (extremum split);
* ``plain``  — two-matrix act MLP (whisper, granite-34b/gptbigcode): the
  activation after the up-projection is NL-ADC'd.

The gate projection + NL-ADC pair goes through the analog backend's
``matmul_nladc`` (:func:`repro_torch.core.analog_layer.dense_nladc`): one
hand-written kernel on the ``cuda`` backend.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.analog_layer import (AnalogActivation, AnalogConfig,
                                           RampDraws, dense_nladc)
from repro_torch.nn import layers as L


def mlp_type_for(cfg) -> str:
    if cfg.family == "encdec" or (cfg.family == "dense"
                                  and cfg.hidden_act == "gelu"):
        return "plain"
    if cfg.family == "hybrid":
        return "geglu"
    return "swiglu"


def make_activation(cfg, device=None) -> AnalogActivation:
    """The model's NL-ADC'd hidden activation (shared across layers), its
    ramp's tensors on ``device``."""
    a = cfg.analog
    return AnalogActivation(a.activation or cfg.hidden_act,
                            AnalogConfig.from_spec(a), device)


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             kind: str):
    if kind in ("swiglu", "geglu"):
        return {
            "wi_gate": L.dense_init(generator, d_model, d_ff),
            "wi_up": L.dense_init(generator, d_model, d_ff),
            "wo": L.dense_init(generator, d_ff, d_model),
        }
    return {
        "wi": L.dense_init(generator, d_model, d_ff),
        "wo": L.dense_init(generator, d_ff, d_model),
    }


def mlp_apply(p, x: torch.Tensor, kind: str, act: AnalogActivation, *,
              draws: Optional[RampDraws] = None
              ) -> torch.Tensor:
    """The MLP; ``draws``: the train-mode ramp draws of the key the call
    shares (:class:`~repro_torch.core.analog_layer.RampDraws`), None for
    none."""
    gated = kind in ("swiglu", "geglu")
    gate_p = p["wi_gate"] if gated else p["wi"]
    h = dense_nladc(gate_p, x, act,
                    z=act.ramp_z(draws, gate_p["w"].shape[-1]))
    if gated:
        h = h * L.dense_apply(p["wi_up"], x)
    return L.dense_apply(p["wo"], h)
