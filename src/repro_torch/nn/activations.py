"""Exact (float) activations used as the software baseline.

The NL-ADC path (:mod:`repro_torch.core.analog_layer`) quantizes these;
``exact`` is both the baseline mode and the reference the quantizer is
validated against.  Names match :mod:`repro_torch.core.functions`'s
registry.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

_SELU_ALPHA = 2.0
_SELU_SLOPE = 0.5


def _selu_paper(x):
    # The paper's simplified selu (Tab. S1): 0.5x (x>=0), 2(e^x - 1) (x<0).
    return torch.where(x >= 0, _SELU_SLOPE * x, _SELU_ALPHA * torch.expm1(x))


def _softsign(x):
    return x / (1.0 + torch.abs(x))


_EXACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "softsign": _softsign,
    "elu": F.elu,
    "selu": _selu_paper,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "swish": F.silu,
    "silu": F.silu,
    "relu": F.relu,
    "identity": lambda x: x,
}


def exact(name: str) -> Callable:
    try:
        return _EXACT[name]
    except KeyError:
        raise KeyError(f"unknown activation {name!r}; "
                       f"known: {sorted(_EXACT)}") from None
