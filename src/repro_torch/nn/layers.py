"""Primitive layers: seeded init helpers, Dense, Embedding, RMSNorm, RoPE.

Params are plain dicts of float32 tensors (the master weights); every
layer is an ``init(generator, ...) -> params`` + ``apply(params, x)`` pair.
Draws come from a ``torch.Generator`` and land on that generator's device.
Compute runs in the model's dtype (bf16 by default) with params cast at
use; norms accumulate in float32.  Each apply mirrors the JAX package's
``repro/nn/layers.py`` op for op.
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


def dense_apply(p, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """Matmul in x's dtype by default (params are f32 master weights)."""
    dt = compute_dtype or x.dtype
    y = x.to(dt) @ p["w"].to(dt)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def embedding_init(generator: torch.Generator, vocab: int, d_model: int):
    return {"table": trunc_normal(generator, (vocab, d_model), 1.0)}


def embedding_apply(p, tokens: torch.Tensor, *,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    return p["table"][tokens].to(compute_dtype)


def embedding_attend(p, x: torch.Tensor) -> torch.Tensor:
    """Tied readout: logits = x @ table.T, with x promoted to float32 as
    the reference's mixed-dtype einsum promotes it."""
    return x.float() @ p["table"].T


def rmsnorm_init(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None):
    """Inverse frequencies, shape (head_dim // 2,)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate pairs (x[..., ::2], x[..., 1::2]).

    x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    """
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def causal_mask(q_len: int, kv_len: int, *, q_offset: int = 0,
                window: int = 0, device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len) mask; True = attend.

    ``q_offset`` shifts query positions (decode with a cache).  ``window``
    > 0 restricts to a local band of that width (recurrentgemma local
    attention).
    """
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = k_pos <= q_pos
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    return mask
