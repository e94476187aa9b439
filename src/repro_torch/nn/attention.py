"""Attention: GQA over a full sequence and over a decode cache.

The JAX package's ``repro/nn/attention.py`` for the dense and MoE
families: the parameter init, the grouped layout, ``attend_chunked`` (the
online softmax over KV chunks) and the causal, optionally windowed
``self_attention`` over a full sequence, ``attend_full`` (unchunked
attention, the reference for the cached-attention kernel), the bf16/f32
and int8 decode caches, and the global-attention branches of
``decode_self_attention``, with the hybrid family's rolling-window cache.
A bf16/f32 cache attends through the analog backend's
``prefill_attention`` primitive (``ref``: ``attend_full``; ``cuda``: the
hand-written kernel), a global int8 cache through ``decode_attention_int8``
(``ref``: the dequantize-all oracle; ``cuda``: the flash-decode kernel,
which dequantizes per tile inside the kernel), and a rolling int8 cache
through the reference's dequantize-all fallback into
``prefill_attention``.  The full-sequence path is plain torch, as the
reference's is plain jnp.  The encoder-decoder family's
``cross_attn_init``, ``cross_kv``, ``cross_attention`` and
``bidirectional_attention`` (whisper's encoder) attend through
``attend_chunked`` with every frame visible, plain torch as the
reference's.

GQA is computed in the grouped layout ``(B, S, H_kv, G, D)`` so KV heads
are never repeated.  RoPE is applied before caching.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def attend_chunked(q, k, v, *, mask_fn, kv_chunk: int = 1024,
                   scale: Optional[float] = None):
    """Online-softmax attention over KV chunks of ``kv_chunk`` slots.

    q: (B, Sq, H, D); k, v: (B, Skv, H_kv, D); ``mask_fn(kv_start,
    kv_len) -> (Sq, kv_len)`` bool (True = attend) for one chunk.  Returns
    (B, Sq, H, D) in q.dtype.  The reference's scan as a Python loop, in
    its chunk order: K and V padded to whole chunks and the padding masked,
    q-dtype operands summed in float32 (its ``preferred_element_type``),
    the running max, sum and accumulator in float32, the probabilities
    rounded to q's dtype before the PV sum.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    g = h // hkv
    qg = (_grouped(q, hkv) * torch.tensor(scale, dtype=q.dtype,
                                          device=q.device)).float()
    n_chunks = math.ceil(skv / kv_chunk)
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32,
                      device=q.device)
    for ci in range(n_chunks):
        kv_start = ci * kv_chunk
        kci = k[:, kv_start:kv_start + kv_chunk].float()
        vci = v[:, kv_start:kv_start + kv_chunk].float()
        s = torch.einsum("bqhgd,bchd->bhgqc", qg, kci)
        mask = mask_fn(kv_start, kv_chunk)
        if pad:
            in_range = kv_start + torch.arange(kv_chunk, device=q.device) \
                < skv
            mask = mask & in_range[None, :]
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bhgqc,bchd->bhgqd", p.to(q.dtype).float(), vci)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def self_attention(p, x, *, n_heads: int, n_kv_heads: int, head_dim: int,
                   rope_theta: float, window: int = 0, positions=None,
                   kv_chunk: int = 1024):
    """Causal (optionally windowed) self-attention over a full sequence.
    x: (B, S, d_model).  The reference's ``return_kv`` option has no
    caller there (``prefill_cache`` writes the cache through the decode
    path, in both packages), so the port has none."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = _split_heads(L.dense_apply(p["wq"], x), n_heads, head_dim)
    k = _split_heads(L.dense_apply(p["wk"], x), n_kv_heads, head_dim)
    v = _split_heads(L.dense_apply(p["wv"], x), n_kv_heads, head_dim)
    q = L.apply_rope(q, positions, rope_theta)
    k = L.apply_rope(k, positions, rope_theta)

    def mask_fn(kv_start, kv_len):
        return L.causal_mask(s, kv_len, q_offset=-kv_start, window=window,
                             device=x.device)

    out = attend_chunked(q, k, v, mask_fn=mask_fn, kv_chunk=kv_chunk)
    return L.dense_apply(p["wo"], out.reshape(b, s, n_heads * head_dim))


def init_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               *, window: int = 0, dtype=torch.bfloat16,
               quantized: bool = False, device=None):
    """Decode cache for one layer: ``max_len`` slots of K and V, or a
    rolling buffer of ``min(max_len, window)`` slots when ``window`` > 0.

    ``quantized``: int8 codes with one bfloat16 scale per (slot, KV head)
    (per-token-per-head symmetric quantization, as the reference)."""
    slots = min(max_len, window) if window > 0 else max_len
    shape = (batch, slots, n_kv_heads, head_dim)
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                   device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quant_kv(x: torch.Tensor):
    """(B, 1, H, D) -> int8 codes + (B, 1, H) bfloat16 scales.

    The reference writes ``amax / 127.0``; XLA compiles that division by a
    constant into a multiplication by its float32 reciprocal
    (``multiply(amax, 0.00787401572)`` in the jitted HLO, which is how the
    serving engine runs it), and about 4% of float32 values round
    differently than under a true division.  The port multiplies by the
    same float32 reciprocal, a tensor on x's device, so CPU and CUDA
    compute the same bits as the served reference.  The codes are
    computed with the float32 scale and rounded half to even; only then is
    the scale rounded to bfloat16.
    """
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    inv_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(amax * inv_127, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


def decode_self_attention(p, x, cache, index: int, *, n_heads: int,
                          n_kv_heads: int, head_dim: int, rope_theta: float,
                          window: int = 0, analog_backend: str = ""):
    """One-token decode step.  ``index`` = absolute position of the new
    token.  x: (B, 1, d_model).  Returns (y, cache).

    The new K/V (or their int8 codes and scales) land in ``cache`` in
    place, for every batch row: the reference returns an updated copy, and
    the engine only ever keeps the new state.  A global cache writes slot
    ``index``; past its last slot the write lands on that slot, as the
    reference's ``dynamic_update_slice`` clamps its start (the serving
    engine's shared index only grows), and RoPE keeps the true ``index``.
    A rolling cache (``window`` > 0) writes slot ``index % slots`` and
    attends to the slots ``< min(index + 1, slots)``.  A global int8 cache
    attends through the backend's ``decode_attention_int8`` over the first
    ``index + 1`` slots, at most all of them (the reference's mask then
    hides none); a rolling int8 cache dequantizes every slot into the
    compute dtype and attends through ``prefill_attention``, the
    reference's fallback.
    """
    b = x.shape[0]
    q = _split_heads(L.dense_apply(p["wq"], x), n_heads, head_dim)
    k = _split_heads(L.dense_apply(p["wk"], x), n_kv_heads, head_dim)
    v = _split_heads(L.dense_apply(p["wv"], x), n_kv_heads, head_dim)
    pos = torch.full((1, 1), index, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, pos, rope_theta)
    k = L.apply_rope(k, pos, rope_theta)

    slots = cache["k"].shape[1]
    slot = cache_slot(index, slots, window)
    bk = BK.get_backend(analog_backend)
    if "k_scale" in cache:
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        cache["k"][:, slot] = kq[:, 0]
        cache["v"][:, slot] = vq[:, 0]
        cache["k_scale"][:, slot] = ks[:, 0]
        cache["v_scale"][:, slot] = vs[:, 0]
        if window <= 0:
            length = torch.full((b,), min(index + 1, slots),
                                dtype=torch.int32, device=x.device)
            out = bk.decode_attention_int8(
                q[:, 0], cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], length)
            out = out[:, None].to(x.dtype)              # (B, 1, H, D)
            y = L.dense_apply(p["wo"], out.reshape(b, 1, n_heads * head_dim))
            return y, cache
        k_att = _dequant(cache["k"], cache["k_scale"], x.dtype)
        v_att = _dequant(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        k_att, v_att = cache["k"], cache["v"]
    slot_ids = torch.arange(slots, device=x.device)
    valid = slot_ids < min(index + 1, slots) if window > 0 \
        else slot_ids <= index
    out = bk.prefill_attention(q, k_att, v_att, valid[None, None, :])
    y = L.dense_apply(p["wo"], out.reshape(b, 1, n_heads * head_dim))
    return y, cache


def cache_slot(index: int, slots: int, window: int = 0) -> int:
    """The slot a decode step at ``index`` writes: ``index % slots`` in a
    rolling cache, else ``index`` clamped to the last slot."""
    return index % slots if window > 0 else min(index, slots - 1)


# ---------------------------------------------------------------------------
# Cross-attention and the encoder's self-attention (whisper)
# ---------------------------------------------------------------------------

def cross_attn_init(generator: torch.Generator, d_model: int, n_heads: int,
                    n_kv_heads: int, head_dim: int, *, qkv_bias: bool = False):
    return attn_init(generator, d_model, n_heads, n_kv_heads, head_dim,
                     qkv_bias=qkv_bias)


def cross_kv(p, enc_out: torch.Tensor, *, n_kv_heads: int, head_dim: int):
    """K and V of the encoder output (B, T, d_model), computed once a
    request: each (B, T, H_kv, D)."""
    k = _split_heads(L.dense_apply(p["wk"], enc_out), n_kv_heads, head_dim)
    v = _split_heads(L.dense_apply(p["wv"], enc_out), n_kv_heads, head_dim)
    return k, v


def _all_visible(s: int, device):
    return lambda kv_start, kv_len: torch.ones((s, kv_len), dtype=torch.bool,
                                               device=device)


def cross_attention(p, x, kv: Tuple[torch.Tensor, torch.Tensor], *,
                    n_heads: int, head_dim: int, kv_chunk: int = 1024):
    """Decoder-to-encoder attention, every frame visible (the K/V padded
    to whole chunks and the padding masked, as the reference's).  x: (B,
    S, d_model); kv: :func:`cross_kv`'s."""
    b, s, _ = x.shape
    k, v = kv
    q = _split_heads(L.dense_apply(p["wq"], x), n_heads, head_dim)
    out = attend_chunked(q, k, v, mask_fn=_all_visible(s, x.device),
                         kv_chunk=kv_chunk)
    return L.dense_apply(p["wo"], out.reshape(b, s, n_heads * head_dim))


def bidirectional_attention(p, x, *, n_heads: int, n_kv_heads: int,
                            head_dim: int, kv_chunk: int = 1024):
    """The encoder's self-attention: every position visible, no RoPE."""
    b, s, _ = x.shape
    q = _split_heads(L.dense_apply(p["wq"], x), n_heads, head_dim)
    k = _split_heads(L.dense_apply(p["wk"], x), n_kv_heads, head_dim)
    v = _split_heads(L.dense_apply(p["wv"], x), n_kv_heads, head_dim)
    out = attend_chunked(q, k, v, mask_fn=_all_visible(s, x.device),
                         kv_chunk=kv_chunk)
    return L.dense_apply(p["wo"], out.reshape(b, s, n_heads * head_dim))
