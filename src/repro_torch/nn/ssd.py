"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

The JAX package's ``repro/nn/ssd.py``.  Selective state space with a
scalar decay per head::

    a_t = exp(-dt_t * A)                         dt_t = softplus(dt_raw)
    S_t = a_t S_{t-1} + dt_t * x_t B_t^T         S: (H, P, N) state
    y_t = C_t S_t + D * x_t

The full sequence runs the chunked SSD algorithm: chunks of ``Q`` steps
use the quadratic (attention-like) form inside, and a short scan carries
the state from chunk to chunk.  The reference's ``associative_scan`` over
chunks is a plain loop here (a handful of chunks); it sums in another
order, so the port holds the full-sequence path to a tolerance, not
bitwise; so is its backward, torch autograd through the loop against the
reference's autodiff of the scan (the masked pairs' ``exp(-inf) = 0``
pass a zero gradient, and padded ``dt = 0`` steps none).  Decode is the
O(1) update of a carried ``(B, H, P, N)`` state.

NL-ADC insertion points, as in the reference: ``dt = softplus(.)`` is the
softplus ramp and the ``z`` gate's silu the swish ramp, both through
:class:`~repro_torch.core.analog_layer.AnalogActivation` (the ``nladc``
kernel on the ``cuda`` backend).  The conv's silu is the exact function.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
from repro_torch.nn import layers as L


def make_dt_act(analog_spec, device=None) -> AnalogActivation:
    """The dt softplus NL-ADC; device-model physics per
    ``analog_spec.device``, its ramp's tensors on ``device``."""
    return AnalogActivation("softplus", AnalogConfig.from_spec(analog_spec),
                            device)


def ssd_init(generator: torch.Generator, d_model: int, *, expand: int = 2,
             headdim: int = 64, d_state: int = 128, conv_width: int = 4):
    """Seeded float32 params on the generator's device, the reference's
    tree: ``in_proj`` packs ``[z (d_inner), x (d_inner), B (N), C (N),
    dt (H)]``."""
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    dev = generator.device
    d_in_proj = 2 * d_inner + 2 * d_state + n_heads
    in_proj = L.dense_init(generator, d_model, d_in_proj)
    conv = 0.1 * torch.randn((conv_width, d_inner + 2 * d_state),
                             generator=generator, device=dev)
    out_proj = L.dense_init(generator, d_inner, d_model)
    return {
        "in_proj": in_proj,
        "conv": conv,
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev)),
        "dt_bias": torch.zeros((n_heads,), device=dev),
        "d_skip": torch.ones((n_heads,), device=dev),
        "out_proj": out_proj,
        "norm": L.rmsnorm_init(d_inner, dev),
    }


def _split_proj(zxbcdt, d_inner: int, d_state: int, n_heads: int):
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    b = zxbcdt[..., 2 * d_inner:2 * d_inner + d_state]
    c = zxbcdt[..., 2 * d_inner + d_state:2 * d_inner + 2 * d_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * d_state:]
    return z, x, b, c, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time, summed in float32 tap by tap in
    the reference's order.  u: (B, S, C), w: (K, C)."""
    k, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    wf = w.float()
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(k):
        out = out + pad[:, i:i + s].float() * wf[k - 1 - i]
    return out.to(u.dtype)


def _conv_step(hist: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One step of the causal conv over the last ``K`` inputs, the
    reference's ``sum(hist * w[::-1], axis=1)`` in float32, summed in the
    order of the history.  hist: (B, K, C), w: (K, C)."""
    k = w.shape[0]
    wf = w.float()
    out = hist[:, 0].float() * wf[k - 1]
    for j in range(1, k):
        out = out + hist[:, j].float() * wf[k - 1 - j]
    return out.to(hist.dtype)


def ssd_chunked(x, dt, a_log, b, c, *, chunk: int):
    """Chunked SSD scan.

    x: (B, S, H, P) values; dt: (B, S, H) positive step sizes; a_log: (H,)
    log decay rates (A = exp(a_log)); b, c: (B, S, N) input and output
    projections (one group).  Returns y (B, S, H, P) and the final state
    (B, H, P, N), float32.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = chunk
    nc = s // q
    if nc * q != s:
        raise ValueError(f"seq {s} not divisible by chunk {q}")

    a = torch.exp(a_log.float())                               # (H,)
    log_a = -dt.float() * a[None, None, :]                     # (B, S, H)
    xw = x.float() * dt.float()[..., None]

    cum = torch.cumsum(log_a.reshape(bsz, nc, q, h), dim=2)
    xc = xw.reshape(bsz, nc, q, h, p)
    bc = b.float().reshape(bsz, nc, q, n)
    cc = c.float().reshape(bsz, nc, q, n)

    # intra-chunk (quadratic) term: decay from step j to step i >= j is
    # exp(cum_i - cum_j); the mask goes in BEFORE the exp, so pairs out of
    # the band are exp(-inf) = 0, never inf
    li = cum[:, :, :, None, :]                                 # (B,NC,Q,1,H)
    lj = cum[:, :, None, :, :]                                 # (B,NC,1,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], li - lj,
                                  -math.inf))                  # (B,NC,Q,Q,H)
    scores = torch.einsum("zcin,zcjn->zcij", cc, bc)           # (B,NC,Q,Q)
    y_intra = torch.einsum("zcijh,zcjhp->zcihp",
                           scores[..., None] * decay, xc)

    # the state each chunk contributes at its end
    tail = cum[:, :, -1:, :] - cum                             # decay j..end
    states = torch.einsum("zcjh,zcjn,zcjhp->zchpn", torch.exp(tail), bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B,NC,H)

    # carry the state across chunks: st_in[i] is the state entering chunk i
    st = torch.zeros_like(states[:, 0])
    st_in = []
    for i in range(nc):
        st_in.append(st)
        st = st * chunk_decay[:, i, :, None, None] + states[:, i]
    st_in = torch.stack(st_in, dim=1)                          # (B,NC,H,P,N)

    y_inter = torch.einsum("zcin,zcih,zchpn->zcihp", cc, torch.exp(cum),
                           st_in)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, st


def ssd_apply(p, x, *, expand: int, headdim: int, d_state: int, chunk: int,
              dt_act: AnalogActivation, gate_act: AnalogActivation,
              draws=None, return_state: bool = False):
    """Full-sequence SSD block.  x: (B, S, d) -> (B, S, d).  ``draws``:
    the train-mode ramp draws of the block's key
    (:class:`~repro_torch.core.analog_layer.RampDraws`), which the dt
    softplus (width H) and the z gate's silu (width d_inner) both take,
    as the reference hands both its layer key."""
    bsz, s, d = x.shape
    d_inner = expand * d
    n_heads = d_inner // headdim
    zxbcdt = L.dense_apply(p["in_proj"], x)
    z, xin, b, c, dt_raw = _split_proj(zxbcdt, d_inner, d_state, n_heads)
    xbc = F.silu(_causal_conv(torch.cat([xin, b, c], dim=-1), p["conv"]))
    xin = xbc[..., :d_inner]
    b = xbc[..., d_inner:d_inner + d_state]
    c = xbc[..., d_inner + d_state:]
    dt = dt_act(dt_raw + p["dt_bias"].to(dt_raw.dtype),
                z=dt_act.ramp_z(draws, n_heads))
    xh = xin.reshape(bsz, s, n_heads, headdim)
    # pad to a chunk multiple with dt = 0 steps: decay exp(0) = 1 and
    # xw = 0, so padded steps are exact no-ops for the outputs and state
    pad = (-s) % chunk
    if pad:
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    else:
        xh_p = xh
    y, state = ssd_chunked(xh_p, dt, p["a_log"], b, c, chunk=chunk)
    y = y[:, :s] + p["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = L.rmsnorm_apply(p["norm"], y * gate_act(
        z, z=gate_act.ramp_z(draws, d_inner)))
    out = L.dense_apply(p["out_proj"], y)
    if return_state:
        return out, state
    return out


def ssd_init_state(batch: int, d_model: int, *, expand: int, headdim: int,
                   d_state: int, conv_width: int = 4, dtype=torch.float32,
                   device=None):
    """The decode state: ``ssm`` (B, H, P, N) float32 and ``conv`` (B, K-1,
    C), the last K-1 conv inputs in the compute dtype."""
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    return {
        "ssm": torch.zeros((batch, n_heads, headdim, d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, d_inner + 2 * d_state),
                            dtype=dtype, device=device),
    }


def ssd_decode(p, x, state, *, expand: int, headdim: int, d_state: int,
               dt_act: AnalogActivation, gate_act: AnalogActivation):
    """One-token step.  x: (B, 1, d) -> (y (B, 1, d), new state).  The
    state's tensors are replaced, never written in place."""
    bsz, _, d = x.shape
    d_inner = expand * d
    n_heads = d_inner // headdim
    zxbcdt = L.dense_apply(p["in_proj"], x[:, 0])
    z, xin, b, c, dt_raw = _split_proj(zxbcdt, d_inner, d_state, n_heads)
    xbc = torch.cat([xin, b, c], dim=-1)                        # (B, C)
    hist = torch.cat([state["conv"], xbc[:, None]], dim=1)      # (B, K, C)
    xbc = F.silu(_conv_step(hist, p["conv"]))
    xin = xbc[..., :d_inner]
    b = xbc[..., d_inner:d_inner + d_state]
    c = xbc[..., d_inner + d_state:]
    dt = dt_act(dt_raw + p["dt_bias"].to(dt_raw.dtype))
    a = torch.exp(p["a_log"].float())
    decay = torch.exp(-dt.float() * a[None, :])                 # (B, H)
    xh = xin.reshape(bsz, n_heads, headdim).float()
    dbx = dt.float()[..., None, None] * xh[..., None] \
        * b.float()[:, None, None, :]
    new_ssm = state["ssm"] * decay[..., None, None] + dbx       # (B,H,P,N)
    y = torch.einsum("bhpn,bn->bhp", new_ssm, c.float())
    y = y + p["d_skip"].float()[None, :, None] * xh
    y = y.reshape(bsz, d_inner).to(x.dtype)
    y = L.rmsnorm_apply(p["norm"], y * gate_act(z))
    out = L.dense_apply(p["out_proj"], y)
    return out[:, None, :], {"ssm": new_ssm,
                             "conv": hist[:, 1:].contiguous()}
