"""Plain-torch oracles for the kernels, the plain versions of the LM
kernels, and the LSTM tail's rounding contract.

The closed-form decode (thermometer count -> affine / split-affine y) is
how the TPU kernels decode; the port's kernels decode by a lookup in the
ramp's ``y_table`` instead, which is what the reference backend computes.
The two agree on every code and differ by float rounding only.

:func:`fma_f32` is the LSTM tail's cell-update contract,
``c' = fma(f, c, i*a)`` with one rounding, shared by every torch path that
computes ``c'``.

:func:`fused_matmul_nladc_plain` and :func:`prefill_attention_plain` are
the plain torch versions of the LM path's two kernels, in the kernels'
signatures: the CPU wrappers run them, and the tests and ``chip_smoke.py``
hold the kernels against them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.nladc import Ramp


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


def thermometer_count(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """``n = sum_k [x > V_k]`` over the last axis of ``x``.

    ``thr`` is ``(P,)`` (one ramp for every column) or ``(N, P)`` (one
    ramp row per column of ``x``'s last axis); the one broadcast covers
    both.  Equal to ``searchsorted(right=False)`` on sorted thresholds.
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
