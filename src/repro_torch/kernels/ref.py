"""Plain-torch oracles for the kernels, the plain versions of the LM
kernels, and the LSTM tail's rounding contract.

The closed-form decode (thermometer count -> affine / split-affine y) is
how the TPU kernels decode; the port's kernels decode by a lookup in the
ramp's ``y_table`` instead, which is what the reference backend computes.
The two agree on every code and differ by float rounding only.

:func:`fma_f32` is the LSTM tail's cell-update contract,
``c' = fma(f, c, i*a)`` with one rounding, shared by every torch path that
computes ``c'``.  :func:`split_bf16x3` is the dense gate's exact three-way
bfloat16 split of its float32 operands at M > 8 (the tensor-core route).

:func:`nladc_plain`, :func:`fused_matmul_nladc_plain`,
:func:`moe_fused_matmul_plain`, :func:`prefill_attention_plain` and
:func:`flash_decode_int8_plain` are the plain torch versions of the LM
paths' kernels, and :func:`analog_tile_plain` that of the crossbar-tile
kernel, in the kernels' signatures: the CPU wrappers run them, and the
tests and ``chip_smoke.py`` hold the kernels against them.

The crossbar tile alone decodes in closed form, as its TPU kernel does, and
with one rounding: :func:`closed_form_params` and
:func:`closed_form_decode_fma` compute ``fma(d, lsb, y0)``, which is what
XLA compiles the Pallas body's ``y0 + d * lsb`` into under ``jax.jit``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.nladc import Ramp, pwm_forward


MODE_AFFINE = 0       # uniform y:              y(n) = y0 + n * lsb
MODE_VSHAPE = 1       # extremum split (S12):   y(n) = y0 + |n - m| * lsb_s
MODE_SIGNED = 2       # monotonic split (selu): y(n) = y0 + (n - m) * lsb_s


def decode_mode(ramp: Ramp) -> int:
    if ramp.split_index < 0:
        return MODE_AFFINE
    return MODE_SIGNED if ramp.monotonic_split else MODE_VSHAPE


def decode_params(ramp: Ramp) -> Tuple[float, float, float, int]:
    """(y0, lsb_left, lsb_right, m) of the closed-form thermometer decode."""
    yt = np.asarray(ramp.y_table, dtype=np.float64)
    if ramp.split_index < 0:
        lsb = (yt[-1] - yt[0]) / (len(yt) - 1)
        return float(yt[0]), float(lsb), float(lsb), 0
    m = ramp.split_index
    if ramp.monotonic_split:
        lsb_left = (yt[m] - yt[0]) / m
    else:
        lsb_left = (yt[0] - yt[m]) / m
    lsb_right = (yt[-1] - yt[m]) / (len(yt) - 1 - m)
    return float(yt[m]), float(lsb_left), float(lsb_right), m


def closed_form_decode(n, mode, y0, lsb_l, lsb_r, m):
    """y(n) from the count ``n`` (float32) and the ramp's decode params."""
    if mode == MODE_AFFINE:
        return y0 + n * lsb_l
    if mode == MODE_VSHAPE:
        return torch.where(n <= m, y0 + (m - n) * lsb_l, y0 + (n - m) * lsb_r)
    return torch.where(n <= m, y0 - (m - n) * lsb_l, y0 + (n - m) * lsb_r)


class ClosedForm(NamedTuple):
    """A ramp's closed-form decode as the kernels take it: the mode and the
    split index ``m``, and ``y0`` and the two LSBs rounded to float32 (as
    ``jax.jit`` makes the Python floats constants of a float32 body)."""
    mode: int
    y0: float
    lsb_l: float
    lsb_r: float
    m: int


def closed_form_params(ramp: Ramp) -> ClosedForm:
    """The float32 closed-form decode of ``ramp``."""
    y0, lsb_l, lsb_r, m = decode_params(ramp)
    f32 = np.float32
    return ClosedForm(decode_mode(ramp), float(f32(y0)), float(f32(lsb_l)),
                      float(f32(lsb_r)), int(m))


def closed_form_decode_fma(n: torch.Tensor, dec: ClosedForm) -> torch.Tensor:
    """y(n) with one rounding per value: ``fma(d, lsb, y0)`` with ``d = n``
    (affine), ``m - n`` left of a V-shaped split and ``n - m`` right of it,
    or ``n - m`` on both sides of a signed split (``y0 - (m - n) * lsb``
    contracts to ``fma(n - m, lsb, y0)``).  n: float32 counts."""
    def const(v):
        return torch.tensor(v, dtype=torch.float32,
                            device=n.device).expand_as(n)

    y0 = const(dec.y0)
    if dec.mode == MODE_AFFINE:
        return fma_f32(n, const(dec.lsb_l), y0)
    d = n - dec.m
    left = fma_f32(-d if dec.mode == MODE_VSHAPE else d, const(dec.lsb_l), y0)
    return torch.where(n <= dec.m, left, fma_f32(d, const(dec.lsb_r), y0))


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 ulps between ``a`` and ``b`` elementwise (int64): the
    distance of their bit patterns on the ordered integer line, so +0 and
    -0 are 0 apart and a step across zero counts every float between.  Two
    NaNs are 0 apart; a NaN against a number is ``2**62``."""
    def key(x):
        i = x.float().contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i >= 0, i, -(i & 0x7FFFFFFF))
    d = (key(a) - key(b)).abs()
    na, nb = torch.isnan(a), torch.isnan(b)
    d = torch.where(na & nb, torch.zeros_like(d), d)
    return torch.where(na ^ nb, torch.full_like(d, 2 ** 62), d)


def thermometer_count(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """``n = sum_k [x > V_k]`` over the last axis of ``x``.

    ``thr`` is ``(P,)`` (one ramp for every column) or ``(N, P)`` (one
    ramp row per column of ``x``'s last axis); the one broadcast covers
    both.  Equal to ``searchsorted(right=False)`` on sorted thresholds,
    except that NaN counts 0 here (every compare with NaN is false, as in
    the Pallas kernels' count) and P there (``tests/
    test_torch_nladc_nonfinite.py``).
    """
    return (x.to(thr.dtype)[..., None] > thr).sum(-1)


def nladc_decode(n: torch.Tensor, ramp: Ramp) -> torch.Tensor:
    """Closed-form y(n) (matches ramp.y_table up to float rounding)."""
    y0, lsb_l, lsb_r, m = decode_params(ramp)
    return closed_form_decode(n.to(torch.float32), decode_mode(ramp),
                              y0, lsb_l, lsb_r, m)


def nladc(x: torch.Tensor, ramp: Ramp, thr=None) -> torch.Tensor:
    """Elementwise NL-ADC with the closed-form decode; ``thr`` overrides the
    ramp's thresholds with a ``(P,)`` or per-column ``(N, P)`` tensor."""
    if thr is None:
        thr = torch.from_numpy(np.asarray(ramp.thresholds, np.float32))
    thr = thr.to(device=x.device, dtype=torch.float32)
    return nladc_decode(thermometer_count(x, thr), ramp).to(x.dtype)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` rounded once to float32, as CUDA's ``__fmaf_rn``.

    The product of two float32 is exact in float64.  The float64 sum is
    rounded to odd (its exact error, from TwoSum, sets the last bit when
    it is not zero), and a round-to-odd value 29 bits finer than float32
    rounds to float32 exactly as the infinitely precise sum would.
    """
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _trunc16(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` with its low 16 bits cleared: the bfloat16 of ``v``
    rounded toward zero, as a float32."""
    return (v.view(torch.int32) & -65536).view(torch.float32)


def split_bf16x3(w: torch.Tensor):
    """The M > 8 dense gate's split of a float32 tensor into three bfloat16
    parts, ``w == h1 + h2 + h3`` (``csrc/hopper.cuh::split3_pair``): each
    part the next 8 significant bits, cut by truncation (round toward zero,
    so the top part cannot round up to infinity at +-FLT_MAX), the
    residuals exact float32 subtractions.  Then every product of a part
    with a bfloat16 is exact in float32.

    The sum is exact for ``|w| >= 2**-110`` and for 0: below, the bits under
    bfloat16's smallest subnormal (2**-133) are lost from the third part.
    +-inf and NaN go whole into ``h1`` (the residual ``w - h1`` is NaN there
    and is replaced by 0), so they stay inf and NaN.
    """
    w = w.float().contiguous()
    t1 = _trunc16(w)
    h1 = torch.where(torch.isnan(w), w, t1)    # cvt.rz keeps a NaN a NaN
    r1 = w - t1
    r1 = torch.where(torch.isnan(r1), torch.zeros_like(r1), r1)
    t2 = _trunc16(r1)
    t3 = _trunc16(r1 - t2)
    return h1.bfloat16(), t2.bfloat16(), t3.bfloat16()


def lstm_gates(gates: torch.Tensor, c: torch.Tensor, sig_ramp: Ramp,
               tanh_ramp: Ramp, sig_thr=None, tanh_thr=None):
    """Fused LSTM elementwise tail (paper Eq. 5 / Fig. S6), closed-form
    decode.  gates: (B, 4H) in the order [f, a, i, o]; c: (B, H).
    Returns (h', c')."""
    h = gates.shape[-1] // 4
    gf, ga, gi, go = torch.split(gates, h, dim=-1)
    f = nladc(gf, sig_ramp, sig_thr)
    a = nladc(ga, tanh_ramp, tanh_thr)
    i = nladc(gi, sig_ramp, sig_thr)
    o = nladc(go, sig_ramp, sig_thr)
    c_new = fma_f32(f, c, i * a)
    return o * nladc(c_new, tanh_ramp, tanh_thr), c_new


def analog_tile_plain(x: torch.Tensor, w: torch.Tensor,
                      w_noise: Optional[torch.Tensor], thr: torch.Tensor,
                      dec: ClosedForm, input_bits: Optional[int] = None,
                      input_clip: float = 1.0) -> torch.Tensor:
    """One crossbar tile, the TPU kernel's function
    (``repro/kernels/crossbar_mac.py``): x cast to float32, then PWM
    quantized (``round(clip(x) * r) * step``, the jitted form; skipped for
    ``input_bits`` None), times ``w + w_noise`` (one rounding; w alone
    without noise) with float32 accumulation, the strict comparator count
    against ``thr`` and the closed-form decode with one rounding, cast to
    x's dtype.  x: (M, K) float32 or bfloat16; w, w_noise: (K, N) float32;
    thr: (P,) float32.

    Where the kernel and the reference's jnp oracle part, this follows the
    kernel: a bfloat16 x is quantized in float32, not in bfloat16.
    """
    xq, w_eff = effective_operands(x, w, w_noise, input_bits, input_clip)
    n = thermometer_count(xq @ w_eff, thr).to(torch.float32)
    return closed_form_decode_fma(n, dec).to(x.dtype)


def effective_operands(x: torch.Tensor, w: torch.Tensor,
                       w_noise: Optional[torch.Tensor] = None,
                       input_bits: Optional[int] = None,
                       input_clip: float = 1.0):
    """``(pwm(f32(x)), w + w_noise)``: the operands whose float32 product
    the crossbar tile sums (the bound of ``code_flips`` is computed on
    them)."""
    xq = x.float()
    if input_bits is not None:
        xq = pwm_forward(xq, input_bits, input_clip)
    return xq, (w if w_noise is None else w + w_noise)


def nladc_plain(x: torch.Tensor, thr: torch.Tensor,
                y_table: torch.Tensor) -> torch.Tensor:
    """``y_table[#{j : x > thr_j}]`` cast to ``x.dtype``: the reference
    backend's elementwise NL-ADC (strict comparator, table decode).  x: any
    shape; thr: (P,) or per-column (N, P) over x's last axis."""
    return y_table[thermometer_count(x, thr)].to(x.dtype)


def fused_matmul_nladc_plain(x: torch.Tensor, w: torch.Tensor, bias,
                             thr: torch.Tensor,
                             y_table: torch.Tensor) -> torch.Tensor:
    """``NLADC(f32(x) @ f32(w) + bias)`` cast to ``x.dtype``: the Pallas
    kernel's function (both operands promoted to float32, float32
    accumulation, the NL-ADC on the accumulator), decoded by ``y_table``
    lookup.  x: (M, K); w: (K, N); bias: (N,) or None; thr: (P,) or
    per-column (N, P)."""
    acc = x.float() @ w.float()
    if bias is not None:
        acc = acc + bias.float()
    return y_table[thermometer_count(acc, thr)].to(x.dtype)


def prefill_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: torch.Tensor):
    """One-query cached attention, ``attend_full`` op for op.

    q: (B, H, D); k, v: (B, S, Hkv, D); mask: (B, S), nonzero where valid.
    Returns (B, H, D) in q.dtype.
    """
    from repro_torch.nn.attention import attend_full   # nn imports kernels

    return attend_full(q[:, None], k, v, (mask != 0)[:, None, :])[:, 0]


def moe_fused_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                           thr: torch.Tensor,
                           y_table: torch.Tensor) -> torch.Tensor:
    """:func:`fused_matmul_nladc_plain` over the expert axis, one threshold
    set shared by every expert: ``NLADC(f32(x[e]) @ f32(w[e]))`` cast to
    ``x.dtype``.  x: (E, C, d); w: (E, d, f); thr: (P,) or per-column
    (f, P).  Returns (E, C, f)."""
    return fused_matmul_nladc_plain(x, w, None, thr, y_table)


def inv_sqrt_d(d: int, device=None) -> torch.Tensor:
    """``1/sqrt(d)`` rounded to float32, as a tensor on ``device`` (a
    Python scalar would be rounded per device's kernel)."""
    return torch.tensor(np.float32(1.0) / np.sqrt(np.float32(d)),
                        dtype=torch.float32, device=device)


def flash_decode_int8_plain(q: torch.Tensor, k8: torch.Tensor,
                            k_scale: torch.Tensor, v8: torch.Tensor,
                            v_scale: torch.Tensor,
                            length: torch.Tensor) -> torch.Tensor:
    """One-token attention over an int8 KV cache, the reference's
    dequantize-all oracle (``repro/kernels/ref.py::flash_decode_int8``)
    op for op as XLA compiles it: K and V dequantized in float32, q scaled
    by ``1/sqrt(D)`` (the oracle's ``q / sqrt(d)`` is a division by a
    constant, which the jitted HLO computes as a multiplication by its
    float32 reciprocal, 0.0883883461 at D 128, as the Pallas kernel
    does), float32 scores, slots at or past ``length`` set to -1e30,
    ``exp(s - max) / sum`` and the float32 PV sum.

    q: (B, H, D); k8, v8: (B, S, Hkv, D) int8; scales: (B, S, Hkv);
    length: (B,) valid-slot counts.  Returns (B, H, D) float32.
    """
    b, h, d = q.shape
    hkv = k8.shape[2]
    g = h // hkv
    k = k8.float() * k_scale.float()[..., None]
    v = v8.float() * v_scale.float()[..., None]
    qg = q.float().reshape(b, hkv, g, d) * inv_sqrt_d(d, q.device)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k)
    slot = torch.arange(k8.shape[1], device=q.device)
    valid = slot[None, :] < length[:, None]
    s = torch.where(valid[:, None, None, :], s, -1e30)
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = e / torch.sum(e, dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    return o.reshape(b, h, d)
