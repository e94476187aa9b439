"""Primitive layers: seeded init helpers and Dense.

Params are plain dicts of float32 tensors; every layer is an
``init(generator, ...) -> params`` + ``apply(params, x)`` pair.  Draws come
from a ``torch.Generator`` and land on that generator's device.
"""

from __future__ import annotations

import math

import torch


def trunc_normal(generator: torch.Generator, shape, scale: float = 1.0):
    """Fan-in init: N(0, 1) truncated to [-2, 2], times
    ``scale / sqrt(fan_in)`` (the MaxText/T5 convention)."""
    stddev = scale / math.sqrt(max(shape[0], 1))
    lo, hi = -2.0, 2.0
    cdf_lo = 0.5 * (1.0 + math.erf(lo / math.sqrt(2.0)))
    cdf_hi = 0.5 * (1.0 + math.erf(hi / math.sqrt(2.0)))
    u = torch.rand(tuple(shape), generator=generator,
                   device=generator.device, dtype=torch.float32)
    u = cdf_lo + u * (cdf_hi - cdf_lo)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return stddev * x.clamp(lo, hi)


def dense_init(generator: torch.Generator, n_in: int, n_out: int, *,
               bias: bool = False, scale: float = 1.0):
    p = {"w": trunc_normal(generator, (n_in, n_out), scale)}
    if bias:
        p["b"] = torch.zeros((n_out,), device=generator.device)
    return p


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y
