"""RG-LRU recurrent block (recurrentgemma / Griffin, arXiv:2402.19427).

The JAX package's ``repro/nn/rglru.py``::

    u = W_x x ; conv1d(width 4) ; gated linear recurrence
    r_t = sigmoid(W_a u_t)          (recurrence gate)   <- NL-ADC
    i_t = sigmoid(W_i u_t)          (input gate)        <- NL-ADC
    a_t = exp(c * softplus(Lambda) * (-r_t))            (per-channel decay)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
    y   = W_o (gelu(W_g x) * h)

Both sigmoid gates run through the NL-ADC, as the hidden activation does
on the ``W_g`` branch.  Dense gates fuse the matmul and the quantizer into
the backend's ``matmul_nladc`` (kernel 3 on ``cuda``); Griffin's
block-diagonal gates keep a batched matmul and quantize its output
elementwise (``nladc``, kernel 2).  Torch has no associative scan: the
full sequence runs the recurrence as a sequential scan in the scan dtype
(held to a tolerance against the reference's tree-ordered scan); decode is
the O(1) update of a carried ``(B, W)`` state.
"""

from __future__ import annotations

import torch

from repro_torch.core.analog_layer import AnalogActivation, dense_nladc
from repro_torch.nn import layers as L
from repro_torch.nn.ssd import _causal_conv, _conv_step

_C = 8.0  # Griffin's fixed gate sharpness


def rglru_init(generator: torch.Generator, d_model: int, width: int,
               conv_width: int = 4, gate_blocks: int = 0):
    """Seeded float32 params on the generator's device.  ``gate_blocks``
    > 0: Griffin's block-diagonal gates, one ``(w/nb, w/nb)`` block per
    head stacked as ``(nb, w/nb, w/nb)``; 0: dense gates (the ablation)."""
    dev = generator.device
    wx = L.dense_init(generator, d_model, width)
    wg = L.dense_init(generator, d_model, width)
    if gate_blocks > 0:
        bw = width // gate_blocks
        scale = 1.0 / (bw ** 0.5)
        wa = scale * torch.randn((gate_blocks, bw, bw), generator=generator,
                                 device=dev)
        wi = scale * torch.randn((gate_blocks, bw, bw), generator=generator,
                                 device=dev)
    else:
        wa = L.dense_init(generator, width, width)
        wi = L.dense_init(generator, width, width)
    wo = L.dense_init(generator, width, d_model)
    conv = 0.1 * torch.randn((conv_width, width), generator=generator,
                             device=dev)
    return {"wx": wx, "wg": wg, "wa": wa, "wi": wi, "wo": wo, "conv": conv,
            # Lambda spans softplus^-1 of a^c in (~0.9, ~0.999)
            "lam": torch.linspace(0.3, 1.5, width, device=dev)}


def _gate_matmul(w, u: torch.Tensor) -> torch.Tensor:
    """Dense (dict) or block-diagonal (stacked tensor) gate projection."""
    if isinstance(w, dict):
        return L.dense_apply(w, u)
    nb, bw, _ = w.shape
    lead = u.shape[:-1]
    out = torch.einsum("...nw,nwv->...nv", u.reshape(lead + (nb, bw)),
                       w.to(u.dtype))
    return out.reshape(lead + (nb * bw,))


def _gated(w, u: torch.Tensor, gate_act: AnalogActivation) -> torch.Tensor:
    """Gate projection and its sigmoid NL-ADC through the analog backend:
    one fused ``matmul_nladc`` for dense gates, the batched matmul then
    the elementwise NL-ADC for block-diagonal ones."""
    if isinstance(w, dict):
        return dense_nladc(w, u, gate_act)
    return gate_act(_gate_matmul(w, u))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_decay(p, r: torch.Tensor) -> torch.Tensor:
    """log a_t = -c * softplus(lam) * r_t, elementwise in float32."""
    lam = _softplus(p["lam"].float())
    return -_C * lam * r.float()


def _linear_recurrence(a: torch.Tensor, b: torch.Tensor, *,
                       chunk: int = 0) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1, h_{-1} = 0, in a's dtype.

    ``chunk > 0`` (dividing S, and below it) blocks the sequence as the
    reference does: a scan inside each chunk gives the chunk's running
    decay product and state, a scan over the chunks' ends carries the
    state, and ``h = h_intra + decay_intra * carry_in`` joins them.
    """
    bsz, s, w = a.shape

    def scan(aa, bb):
        """Running (prod a, h) along axis 1 of (..., T, W) tensors."""
        pa, ph = [aa[:, 0]], [bb[:, 0]]
        for t in range(1, aa.shape[1]):
            pa.append(aa[:, t] * pa[-1])
            ph.append(aa[:, t] * ph[-1] + bb[:, t])
        return torch.stack(pa, dim=1), torch.stack(ph, dim=1)

    if chunk <= 0 or s <= chunk or s % chunk:
        return scan(a, b)[1]
    nc = s // chunk
    pa, ph = scan(a.reshape(bsz * nc, chunk, w), b.reshape(bsz * nc,
                                                         chunk, w))
    pa = pa.reshape(bsz, nc, chunk, w)
    ph = ph.reshape(bsz, nc, chunk, w)
    _, carry = scan(pa[:, :, -1], ph[:, :, -1])
    carry_in = torch.cat([torch.zeros_like(carry[:, :1]), carry[:, :-1]],
                         dim=1)
    return (ph + pa * carry_in[:, :, None, :]).reshape(bsz, s, w)


def rglru_apply(p, x: torch.Tensor, gate_act: AnalogActivation,
                hidden_act: AnalogActivation, *,
                scan_dtype=torch.float32, chunk: int = 0) -> torch.Tensor:
    """Full-sequence forward.  x: (B, S, d) -> (B, S, d)."""
    u = _causal_conv(L.dense_apply(p["wx"], x), p["conv"])
    r = _gated(p["wa"], u, gate_act)
    i = _gated(p["wi"], u, gate_act)
    log_a = _log_decay(p, r)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) \
        * (i.float() * u.float())
    h = _linear_recurrence(a.to(scan_dtype), b.to(scan_dtype),
                           chunk=chunk).float()
    g = hidden_act(L.dense_apply(p["wg"], x))
    return L.dense_apply(p["wo"], (g.float() * h).to(x.dtype))


def rglru_init_state(batch: int, width: int, conv_width: int = 4,
                     dtype=torch.float32, device=None):
    """The decode state: ``h`` (B, W) float32 and ``conv`` (B, K-1, W), the
    last K-1 conv inputs in the compute dtype."""
    return {"h": torch.zeros((batch, width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_width - 1, width), dtype=dtype,
                                device=device)}


def rglru_decode(p, x: torch.Tensor, state, gate_act: AnalogActivation,
                 hidden_act: AnalogActivation):
    """One-token step.  x: (B, 1, d) -> (y (B, 1, d), new state).  The
    state's tensors are replaced, never written in place."""
    u = L.dense_apply(p["wx"], x)[:, 0]                         # (B, W)
    hist = torch.cat([state["conv"], u[:, None]], dim=1)        # (B, K, W)
    uc = _conv_step(hist, p["conv"])
    r = _gated(p["wa"], uc, gate_act)
    i = _gated(p["wi"], uc, gate_act)
    lam = _softplus(p["lam"].float())
    a = torch.exp(-_C * lam * r.float())
    h = a * state["h"] + torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) \
        * (i.float() * uc.float())
    g = hidden_act(L.dense_apply(p["wg"], x[:, 0]))
    y = L.dense_apply(p["wo"], (g.float() * h).to(x.dtype))
    return y[:, None, :], {"h": h, "conv": hist[:, 1:].contiguous()}
