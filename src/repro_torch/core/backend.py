"""Pluggable analog-execution backends: the single dispatch seam.

* ``"ref"``  — plain torch on any device; its semantics define the
  contract (strict-comparator ``searchsorted`` + ``y_table`` decode, the
  cell update ``c' = fma(f, c, i*a)`` rounded once, the LM's gate matmul
  and the MoE's expert-gate einsum in the compute dtype, ``attend_full``
  for cached attention, and the dequantize-all oracle for attention over
  an int8 cache).
* ``"cuda"`` — the hand-written kernels of :mod:`repro_torch.kernels`.  It
  takes CUDA tensors only and raises on anything else; it never falls
  back to the plain version.  Its gate matmul is the Pallas kernel's
  function: float32 operands and accumulator, the NL-ADC on the
  accumulator, then the cast to x's dtype.  In float32 the two backends
  compute the same function; in bfloat16 the ``ref`` backend rounds the
  weights and the matmul output to bfloat16 first, as the JAX package's
  ``ref`` backend does against its ``pallas`` backend.

Selection: ``AnalogConfig.backend`` (empty string = auto), else the
``REPRO_TORCH_BACKEND`` env var, else ``ref``.  Third-party backends can be
added with :func:`register_backend`.

Threshold operands are ``(P,)`` tensors or :class:`BankedThresholds` (the
``(n_col_tiles, P)`` per-col-tile layout, each output column compared
against its own bank's ramp).

Gradients (Alg. 1): ``ref``'s NL-ADC is
:func:`repro_torch.core.nladc.nladc_apply` (the straight-through backward),
and ``lstm_gates`` on both backends is one ``torch.autograd.Function``
whose forward is the backend's tail and whose backward is the reference's
hand-written chain (``src/repro/core/backend.py:279-307``): it saves only
the residuals ``(gates, c, thresholds)`` and rematerializes the tail, on
``ref`` with :func:`~repro_torch.kernels.lstm_cell.lstm_gates_bwd_plain`,
on ``cuda`` with the backward kernel.  The ``cuda`` backend's ``nladc``,
``matmul_nladc``, ``moe_matmul_nladc`` and ``prefill_attention`` are
Functions too (:class:`_NLADCKernel`, :class:`_GateKernel`,
:class:`_ExpertGateKernel`, :class:`_AttentionKernel`): the kernel
forward, and the backward of the JAX ``pallas`` backend's ``custom_vjp``
in plain torch (``src/repro/core/backend.py:182-251``, ``:318-373``).
Each is taken only where an input requires a gradient under grad mode, so
the infer and serve steps launch the kernel alone.  The thresholds get no
gradient.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from repro_torch.core import functions as F
from repro_torch.core.nladc import (NLADC, BankedThresholds, nladc_apply,
                                    nladc_ste)
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import fused_matmul_nladc as fmn
from repro_torch.kernels import lstm_cell
from repro_torch.kernels import nladc as nk
from repro_torch.kernels import prefill_attention as pa
from repro_torch.kernels.ref import fma_f32, flash_decode_int8_plain

DEFAULT_BACKEND = "ref"


def resolve_backend(name: str = "") -> str:
    """Explicit name, else the ``REPRO_TORCH_BACKEND`` env var, else ref."""
    if name:
        return name
    return os.environ.get("REPRO_TORCH_BACKEND", "") or DEFAULT_BACKEND


def _domain(adc: NLADC):
    spec = F.get(adc.ramp.name)
    return spec.x_lo, spec.x_hi


class _LSTMTail(torch.autograd.Function):
    """The tail with the reference's straight-through backward.

    ``forward(gates, c, sig_dense, tanh_dense, backend, sig_adc,
    tanh_adc, sig_thr, tanh_thr)`` runs ``backend._lstm_tail`` on the
    thresholds as given (``(P,)`` or :class:`BankedThresholds`) and saves
    the residuals, the thresholds as the dense ``(P,)`` or ``(H, P)``
    operands; ``backward`` hands them and the cotangents to
    ``backend._lstm_tail_bwd``."""

    @staticmethod
    def forward(ctx, gates, c, sig_dense, tanh_dense, backend, sig_adc,
                tanh_adc, sig_thr, tanh_thr):
        ctx.save_for_backward(gates, c, sig_dense, tanh_dense)
        ctx.tail = (backend, sig_adc, tanh_adc)
        return backend._lstm_tail(gates, c, sig_thr, tanh_thr, sig_adc,
                                  tanh_adc)

    @staticmethod
    def backward(ctx, ct_h, ct_c):
        gates, c, sig_dense, tanh_dense = ctx.saved_tensors
        backend, sig_adc, tanh_adc = ctx.tail
        d_gates, d_c = backend._lstm_tail_bwd(
            gates, c, sig_dense, tanh_dense, sig_adc, tanh_adc,
            ct_h.contiguous(), ct_c.contiguous())
        return (d_gates, d_c) + (None,) * 7


def _lstm_gates(backend, gates, c, sig_adc, tanh_adc, sig_thr, tanh_thr):
    """Both backends' ``lstm_gates``.  The path follows ``requires_grad``
    of ``gates`` or ``c`` under grad mode: with it :class:`_LSTMTail`,
    without it the forward alone, as the NL-ADC's ``nladc_apply`` does."""
    names =(sig_adc.ramp.name, tanh_adc.ramp.name)
    if names != ("sigmoid", "tanh"):
        raise ValueError(f"lstm_gates takes a sigmoid and a tanh ramp, got "
                         f"{names}")
    sig_thr = sig_adc.thresholds if sig_thr is None else sig_thr
    tanh_thr = tanh_adc.thresholds if tanh_thr is None else tanh_thr
    if not (torch.is_grad_enabled()
            and (gates.requires_grad or c.requires_grad)):
        return backend._lstm_tail(gates, c, sig_thr, tanh_thr, sig_adc,
                                  tanh_adc)
    return _LSTMTail.apply(gates, c, _dense(sig_thr, sig_adc),
                           _dense(tanh_thr, tanh_adc), backend, sig_adc,
                           tanh_adc, sig_thr, tanh_thr)


class RefBackend:
    """The plain-torch path; its semantics define the contract."""

    name = "ref"

    def nladc(self, x: torch.Tensor, adc: NLADC, thresholds=None):
        """Elementwise NL-ADC: thermometer count + ``y_table`` decode, with
        the straight-through backward."""
        thr = adc.thresholds if thresholds is None else thresholds
        return nladc_apply(x, thr, adc.y_table, adc.ramp.name)

    def lstm_gates(self, gates: torch.Tensor, c: torch.Tensor,
                   sig_adc: NLADC, tanh_adc: NLADC,
                   sig_thr=None, tanh_thr=None):
        """The LSTM elementwise tail (Eq. 5): 5 NL-ADCs + cell update.

        gates: (B, 4H) raw MAC results in [f|a|i|o] order; c: (B, H).
        Differentiable: the reference's straight-through chain
        (:class:`_LSTMTail`).
        """
        return _lstm_gates(self, gates, c, sig_adc, tanh_adc, sig_thr,
                           tanh_thr)

    def _lstm_tail(self, gates, c, sig_thr, tanh_thr, sig_adc, tanh_adc):
        """The forward: strict-comparator counts (``searchsorted``), table
        decodes, ``c' = fma(f, c, i*a)`` rounded once."""
        hf, ha, hi, ho = torch.split(gates, gates.shape[-1] // 4, dim=-1)
        f = self.nladc(hf, sig_adc, sig_thr)
        a = self.nladc(ha, tanh_adc, tanh_thr)
        i = self.nladc(hi, sig_adc, sig_thr)
        o = self.nladc(ho, sig_adc, sig_thr)
        c_new = fma_f32(f, c, i * a)
        return o * self.nladc(c_new, tanh_adc, tanh_thr), c_new

    def _lstm_tail_bwd(self, gates, c, sig_thr, tanh_thr, sig_adc, tanh_adc,
                       ct_h, ct_c):
        return lstm_cell.lstm_gates_bwd_plain(
            gates, c, sig_thr, sig_adc.y_table, tanh_thr, tanh_adc.y_table,
            ct_h, ct_c, sig_domain=_domain(sig_adc),
            tanh_domain=_domain(tanh_adc))

    def matmul_nladc(self, x: torch.Tensor, w: torch.Tensor, adc: NLADC,
                     bias=None, thresholds=None):
        """NLADC(x @ w + bias), the matmul in x's compute dtype (the LM
        dense path)."""
        y = x @ w.to(x.dtype)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return self.nladc(y, adc, thresholds).to(x.dtype)

    def moe_matmul_nladc(self, x: torch.Tensor, w: torch.Tensor,
                         adc: NLADC, thresholds=None):
        """Per-expert fused gate: NLADC(x[e] @ w[e]) for every expert.

        x: (E, C, d) dispatched expert buffers, w: (E, d, f) expert
        weights -> (E, C, f).  The einsum runs in x's compute dtype, then
        the elementwise NL-ADC, as the reference's ``ref`` backend."""
        h = torch.einsum("ecd,edf->ecf", x, w.to(x.dtype))
        return self.nladc(h, adc, thresholds)

    def prefill_attention(self, q, k, v, mask):
        """One-query cached attention (scan prefill / decode step).

        q: (B, 1, H, D); k, v: (B, S, Hkv, D); mask broadcastable to
        (B, 1, S).  The ref path is ``nn.attention.attend_full`` itself.
        """
        from repro_torch.nn.attention import attend_full   # nn imports core

        return attend_full(q, k, v, mask)

    def decode_attention_int8(self, q, k8, k_scale, v8, v_scale, length):
        """One-token attention over an int8 KV cache (dequantize-all).

        q: (B, H, D); k8/v8: (B, S, H_kv, D) int8; scales (B, S, H_kv);
        length: (B,) valid-slot counts.  Returns (B, H, D) float32."""
        return flash_decode_int8_plain(q, k8, k_scale, v8, v_scale, length)


def _dense(thr, adc: NLADC) -> torch.Tensor:
    """A ``(P,)`` or per-column ``(H, P)`` kernel operand."""
    thr = adc.thresholds if thr is None else thr
    if isinstance(thr, BankedThresholds):
        return thr.per_column
    return thr


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


class _NLADCKernel(torch.autograd.Function):
    """The NL-ADC kernel forward; backward :func:`nladc_ste` on the saved
    input (``_pallas_nladc_fn``)."""

    @staticmethod
    def forward(ctx, x, thr, y_table, grad_name):
        ctx.grad_name = grad_name
        ctx.save_for_backward(x)
        return nk.nladc(x, thr, y_table)

    @staticmethod
    def backward(ctx, ct):
        (x,) = ctx.saved_tensors
        return nladc_ste(ctx.grad_name, x, ct), None, None, None


class _GateKernel(torch.autograd.Function):
    """The fused gate kernel forward on (M, K) rows; the backward of
    ``_pallas_matmul_fn``: the accumulator recomputed as the ``ref``
    backend computes it (``x @ w`` in x's dtype, plus the bias), the
    straight-through mask on it, then the dx / dw / db products in x's
    dtype (full-precision GEMMs: ``launch.common.configure_numerics``)."""

    @staticmethod
    def forward(ctx, x, w, bias, thr, y_table, grad_name):
        ctx.grad_name = grad_name
        ctx.save_for_backward(x, w, bias)
        return fmn.fused_matmul_nladc(x, w, bias, thr, y_table)

    @staticmethod
    def backward(ctx, ct):
        x, w, bias = ctx.saved_tensors
        w_used = w.to(x.dtype)
        pre = x @ w_used
        if bias is not None:
            pre = pre + bias.to(pre.dtype)
        d_pre = nladc_ste(ctx.grad_name, pre, ct.to(pre.dtype))
        dx = (d_pre @ w_used.T).to(x.dtype)
        dw = (x.T @ d_pre).to(w.dtype)
        db = None if bias is None else d_pre.sum(0).to(bias.dtype)
        return dx, dw, db, None, None, None


class _ExpertGateKernel(torch.autograd.Function):
    """The expert-gate kernel forward on (E, C, d) buffers; the backward of
    ``_pallas_moe_fn``: ``pre = einsum("ecd,edf->ecf")`` in x's dtype, the
    straight-through mask, then the batched dx / dw products."""

    @staticmethod
    def forward(ctx, x, w, thr, y_table, grad_name):
        ctx.grad_name = grad_name
        ctx.save_for_backward(x, w)
        return fmn.moe_fused_matmul(x, w, thr, y_table)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        w_used = w.to(x.dtype)
        pre = torch.bmm(x, w_used)
        d_pre = nladc_ste(ctx.grad_name, pre, ct.to(pre.dtype))
        dx = torch.bmm(d_pre, w_used.transpose(1, 2)).to(x.dtype)
        dw = torch.bmm(x.transpose(1, 2), d_pre).to(w.dtype)
        return dx, dw, None, None, None


def _attention_kernel(q, k, v, mask):
    """(B, 1, H, D) queries over (B, S, H_kv, D) through the kernel."""
    mask2 = torch.broadcast_to(mask, (q.shape[0], 1, k.shape[1]))[:, 0]
    out = pa.prefill_attention(q[:, 0].contiguous(), k.contiguous(),
                               v.contiguous(),
                               mask2.to(torch.int32).contiguous())
    return out[:, None]


class _AttentionKernel(torch.autograd.Function):
    """The cached-attention kernel forward; the backward of
    ``_pallas_prefill_attention_fn``: autograd through ``attend_full`` on
    the saved q, k, v and mask."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return _attention_kernel(q, k, v, mask)

    @staticmethod
    def backward(ctx, ct):
        from repro_torch.nn.attention import attend_full  # nn imports core

        q, k, v, mask = ctx.saved_tensors
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            out = attend_full(*qkv, mask)
        dq, dk, dv = torch.autograd.grad(out, qkv, ct)
        return dq, dk, dv, None


class CudaBackend(RefBackend):
    """Hand-written CUDA kernels for the primitives that have one.  Its
    operands must lie on ``device_type`` (``cuda``); the kernel wrappers
    take their plain versions on the CPU, so ``CudaBackend("cpu")`` runs
    this backend's code there."""

    name = "cuda"

    def __init__(self, device_type: str = "cuda"):
        self.device_type = device_type

    def _on_device(self, t: torch.Tensor, name: str) -> None:
        if t.device.type != self.device_type:
            raise ValueError(f"the {self.name} backend takes "
                             f"{self.device_type.upper()} tensors; {name} "
                             f"is on {t.device}")

    def nladc(self, x, adc, thresholds=None):
        self._on_device(x, "x")
        thr = _dense(thresholds, adc)
        if _wants_grad(x):
            return _NLADCKernel.apply(x.contiguous(), thr, adc.y_table,
                                      adc.ramp.name)
        return nk.nladc(x.contiguous(), thr, adc.y_table)

    def lstm_gates(self, gates, c, sig_adc, tanh_adc,
                   sig_thr=None, tanh_thr=None):
        self._on_device(gates, "gates")
        return _lstm_gates(self, gates, c, sig_adc, tanh_adc, sig_thr,
                           tanh_thr)

    def _lstm_tail(self, gates, c, sig_thr, tanh_thr, sig_adc, tanh_adc):
        return lstm_cell.lstm_gates(
            gates, c, _dense(sig_thr, sig_adc), sig_adc.y_table,
            _dense(tanh_thr, tanh_adc), tanh_adc.y_table)

    def _lstm_tail_bwd(self, gates, c, sig_thr, tanh_thr, sig_adc, tanh_adc,
                       ct_h, ct_c):
        self._on_device(gates, "gates")
        return lstm_cell.lstm_gates_bwd(
            gates, c, sig_thr, sig_adc.y_table, tanh_thr, tanh_adc.y_table,
            ct_h, ct_c, sig_domain=_domain(sig_adc),
            tanh_domain=_domain(tanh_adc))

    def matmul_nladc(self, x, w, adc, bias=None, thresholds=None):
        self._on_device(x, "x")
        lead = x.shape[:-1]
        args = (x.reshape(-1, x.shape[-1]).contiguous(), w.contiguous(),
                bias, _dense(thresholds, adc), adc.y_table)
        if _wants_grad(x, w, bias):
            y = _GateKernel.apply(*args, adc.ramp.name)
        else:
            y = fmn.fused_matmul_nladc(*args)
        return y.reshape(lead + (w.shape[-1],))

    def moe_matmul_nladc(self, x, w, adc, thresholds=None):
        self._on_device(x, "x")
        args = (x.contiguous(), w.contiguous(), _dense(thresholds, adc),
                adc.y_table)
        if _wants_grad(x, w):
            return _ExpertGateKernel.apply(*args, adc.ramp.name)
        return fmn.moe_fused_matmul(*args)

    def decode_attention_int8(self, q, k8, k_scale, v8, v_scale, length):
        self._on_device(q, "q")
        return fd.flash_decode_int8(q.contiguous(), k8, k_scale, v8, v_scale,
                                    length)

    def prefill_attention(self, q, k, v, mask):
        self._on_device(q, "q")
        if q.shape[1] != 1:
            raise ValueError(f"prefill_attention is one-query; got q_len "
                             f"{q.shape[1]}")
        if _wants_grad(q, k, v):
            return _AttentionKernel.apply(q, k, v, mask)
        return _attention_kernel(q, k, v, mask)


_REGISTRY: Dict[str, object] = {}


def register_backend(name: str, impl) -> None:
    """Register an analog backend implementation under ``name``."""
    _REGISTRY[name] = impl


register_backend("ref", RefBackend())
register_backend("cuda", CudaBackend())


def get_backend(name: str = ""):
    """Resolve (explicit / env / default) and return the backend object."""
    resolved = resolve_backend(name)
    try:
        return _REGISTRY[resolved]
    except KeyError:
        raise KeyError(
            f"unknown analog backend {resolved!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def backend_names():
    return tuple(sorted(_REGISTRY))
