"""Attention: GQA over a decode cache, one new token at a time.

The serving slice of the JAX package's ``repro/nn/attention.py``: the
parameter init, the grouped layout, ``attend_full`` (unchunked attention,
the reference for the cached-attention kernel), the bf16/f32 decode cache,
and the non-int8, global-attention branch of ``decode_self_attention``,
whose attention goes through the analog backend's ``prefill_attention``
primitive (``ref``: ``attend_full``; ``cuda``: the hand-written kernel).
Chunked attention and the full-sequence ``self_attention`` belong to the
forward/training slice, the rolling-window cache to the hybrid family, the
int8 cache to the int8-KV slice.

GQA is computed in the grouped layout ``(B, S, H_kv, G, D)`` so KV heads
are never repeated.  RoPE is applied before caching.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import backend as BK
from repro_torch.nn import layers as L

NEG_INF = -1e30


def attn_init(generator: torch.Generator, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, *, qkv_bias: bool = False):
    q_dim, kv_dim = n_heads * head_dim, n_kv_heads * head_dim
    return {
        "wq": L.dense_init(generator, d_model, q_dim, bias=qkv_bias),
        "wk": L.dense_init(generator, d_model, kv_dim, bias=qkv_bias),
        "wv": L.dense_init(generator, d_model, kv_dim, bias=qkv_bias),
        "wo": L.dense_init(generator, q_dim, d_model, bias=False),
    }


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int):
    return x.reshape(x.shape[:-1] + (n_heads, head_dim))


def _grouped(q: torch.Tensor, n_kv_heads: int):
    """(B, S, H, D) -> (B, S, H_kv, G, D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv_heads, h // n_kv_heads, d)


def attend_full(q, k, v, mask, *, scale: Optional[float] = None):
    """Unchunked attention.  q: (B, Sq, H, D); k, v: (B, Skv, H_kv, D);
    mask (bool, True = attend): (B, Sq, Skv) or broadcastable to
    (B, H_kv, G, Sq, Skv).  Returns (B, Sq, H, D) in q.dtype.

    The reference's rounding order: the scale is cast to q's dtype and
    ``q * scale`` rounded there; scores sum in float32 from the q-dtype
    operands; the softmax runs in float32; the probabilities are rounded
    to q's dtype before the float32 PV sum.
    """
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = _grouped(q, hkv) * torch.tensor(scale, dtype=q.dtype,
                                         device=q.device)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = torch.where(mask[:, None, None] if mask.dim() == 3 else mask, s,
                    NEG_INF)
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = e / torch.sum(e, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype).float(), v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def init_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               *, dtype=torch.bfloat16, quantized: bool = False,
               device=None):
    """Decode cache for one layer: ``max_len`` slots of K and V."""
    if quantized:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet; ROADMAP.md queue A item "
            "N1 (the int8-KV decode slice) brings it")
    shape = (batch, max_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_self_attention(p, x, cache, index: int, *, n_heads: int,
                          n_kv_heads: int, head_dim: int, rope_theta: float,
                          analog_backend: str = ""):
    """One-token decode step.  ``index`` = absolute position of the new
    token.  x: (B, 1, d_model).  Returns (y, cache).

    The new K/V land in ``cache`` in place, at slot ``index``, for every
    batch row: the reference returns an updated copy, and the engine only
    ever keeps the new state.
    """
    b = x.shape[0]
    q = _split_heads(L.dense_apply(p["wq"], x), n_heads, head_dim)
    k = _split_heads(L.dense_apply(p["wk"], x), n_kv_heads, head_dim)
    v = _split_heads(L.dense_apply(p["wv"], x), n_kv_heads, head_dim)
    pos = torch.full((1, 1), index, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, pos, rope_theta)
    k = L.apply_rope(k, pos, rope_theta)

    if "k_scale" in cache:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet; ROADMAP.md queue A item "
            "N1 (the int8-KV decode slice) brings it")
    cache["k"][:, index] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, index] = v[:, 0].to(cache["v"].dtype)
    valid = torch.arange(cache["k"].shape[1], device=x.device) <= index
    out = BK.get_backend(analog_backend).prefill_attention(
        q, cache["k"], cache["v"], valid[None, None, :])
    y = L.dense_apply(p["wo"], out.reshape(b, 1, n_heads * head_dim))
    return y, cache
