"""The paper's analog LSTM: 4 NL-ADC gates on a crossbar-mapped matmul.

Eq. (4)/(5) and the Methods:

    [h_f, h_a, h_i, h_o] = [sigma, tanh, sigma, sigma]([x, h^{t-1}] [W; U])
    h_c^t = h_f * h_c^{t-1} + h_i * h_a        (digital elementwise, Fig. S6)
    h^t   = h_o * tanh(h_c^t)                  (tanh NL-ADC'd on chip)

* the gate matmul maps to the crossbar: inputs PWM-quantized, weights
  clipped to [-2, 2], noise per ``AnalogConfig.device`` (``TrainNoise`` on
  the weights and the ramp steps in train mode, ``ReadNoise`` in infer
  mode);
* all four gate nonlinearities AND the cell tanh are NL-ADC ramp quantized,
  through the backend's ``lstm_gates`` primitive (the CUDA kernel on the
  ``cuda`` backend), while the gate matmul stays one wide GEMM;
* the optional projection (PTB model) and the FC readout are separate
  crossbar-mapped matmuls.

Layouts follow the JAX package: gates ``(B, 4H)`` in the order
``[f|a|i|o]``, ``xs`` ``(B, T, n_in)``, ``w_gates`` ``(n_in + out_dim, 4H)``.

Hardware-aware training (Alg. 1) is ``mode="train"``: the classifier's
weights are trainable parameters, every quantizer has its
straight-through backward, and on the ``cuda`` backend the tail's backward
is a kernel of its own.

Per-step noise comes from one :class:`NoiseSource`, in call order.  One
time step draws: the gate weights' noise, then (train mode only) one ramp
draw ``z`` of the thresholds' shape, which the sigmoid and the tanh
thresholds both take, then the projection weights' noise.  The FC
weights' draw comes after the last step.  Under ``paired_noise`` in infer
mode each weight draw is two, the positive devices' then the negative
devices' (train noise stays one draw per weight).  (The JAX reference
derives the gate and projection draws of a step from one key, and both
ramps from another; a replayed source reproduces that, a generator draws
each afresh.)

Under the circuit-level device stages (``paper-ir``, ``stressed-ir``)
every crossbar read also takes the ``NonlinearIV`` transform of its
inputs and the ``LineResistance`` correction of its noisy weights, per
crossbar tile and before the backend seam
(:mod:`repro_torch.core.analog_layer`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core import backend as BK
from repro_torch.core.analog_layer import (AnalogActivation, AnalogConfig,
                                           analog_matmul_act)
from repro_torch.core.crossbar import NoiseSource
from repro_torch.nn import layers as L


@dataclasses.dataclass(frozen=True)
class LSTMSpec:
    n_in: int
    n_hidden: int
    n_proj: int = 0           # 0 = no projection
    analog: AnalogConfig = dataclasses.field(
        default_factory=lambda: AnalogConfig(enabled=True))

    @property
    def out_dim(self) -> int:
        return self.n_proj or self.n_hidden


def lstm_init(generator: torch.Generator, spec: LSTMSpec):
    n_cat = spec.n_in + spec.out_dim
    p = {"w_gates": L.trunc_normal(generator, (n_cat, 4 * spec.n_hidden))}
    if spec.n_proj:
        p["w_proj"] = L.trunc_normal(generator, (spec.n_hidden, spec.n_proj))
    return p


def make_gate_acts(cfg: AnalogConfig, width: int = 0, device=None):
    """(sigmoid, tanh) NL-ADC pair shared by gates and the cell tanh.

    ``width`` (the hidden size) realizes the per-col-tile threshold banks
    up front when ``cfg.bank_cols`` is set.
    """
    acts = (AnalogActivation("sigmoid", cfg, device),
            AnalogActivation("tanh", cfg, device))
    if width:
        for act in acts:
            act.bank_for(width)
    return acts


def lstm_cell(p, x, h, c, spec: LSTMSpec, acts: Tuple, *,
              noise: Optional[NoiseSource] = None):
    """One timestep. x: (B, n_in); h: (B, out_dim); c: (B, n_hidden)."""
    sig, tnh = acts
    cfg = spec.analog
    xh = torch.cat([x, h], dim=-1)
    gates = analog_matmul_act(xh, p["w_gates"], cfg, noise=noise)
    if cfg.enabled and sig.ramp is not None and tnh.ramp is not None:
        # one ramp draw for both activations (the reference's one key)
        z = sig.ramp_noise(noise, spec.n_hidden)
        h_new, c_new = BK.get_backend(cfg.backend).lstm_gates(
            gates, c, sig.adc, tnh.adc,
            sig_thr=sig.thresholds_for(spec.n_hidden, z=z),
            tanh_thr=tnh.thresholds_for(spec.n_hidden, z=z))
    else:
        hf, ha, hi, ho = torch.split(gates, spec.n_hidden, dim=-1)
        hf, ha, hi, ho = sig(hf), tnh(ha), sig(hi), sig(ho)
        c_new = hf * c + hi * ha
        h_new = ho * tnh(c_new)
    if spec.n_proj:
        h_new = analog_matmul_act(h_new, p["w_proj"], cfg, noise=noise)
    return h_new, c_new


def lstm_scan(p, xs, spec: LSTMSpec, acts: Tuple, *,
              noise: Optional[NoiseSource] = None, h0=None, c0=None):
    """Run over a sequence. xs: (B, T, n_in) -> outputs (B, T, out_dim)."""
    b = xs.shape[0]
    h = xs.new_zeros((b, spec.out_dim)) if h0 is None else h0
    c = xs.new_zeros((b, spec.n_hidden)) if c0 is None else c0
    ys = []
    for t in range(xs.shape[1]):
        h, c = lstm_cell(p, xs[:, t], h, c, spec, acts, noise=noise)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


# ---------------------------------------------------------------------------
# Full classifier models (KWS / PTB)
# ---------------------------------------------------------------------------

def classifier_init(generator: torch.Generator, spec: LSTMSpec,
                    n_classes: int):
    return {"lstm": lstm_init(generator, spec),
            "fc": L.dense_init(generator, spec.out_dim, n_classes)}


def classifier_apply(p, xs, spec: LSTMSpec, acts, *,
                     noise: Optional[NoiseSource] = None,
                     all_steps: bool = False):
    """KWS: last-step logits.  PTB (all_steps): per-step logits."""
    ys, _ = lstm_scan(p["lstm"], xs, spec, acts, noise=noise)
    feats = ys if all_steps else ys[:, -1]
    # The FC layer also lives on-crossbar (digitized, no NL).
    return analog_matmul_act(feats, p["fc"]["w"], spec.analog, noise=noise)


class LSTMClassifier(nn.Module):
    """The classifier as a module: its weights, its deployed NL-ADCs, and
    :func:`classifier_apply` as ``forward``.

    ``params`` is a tree in the layout of :func:`classifier_init` (e.g.
    from :func:`repro_torch.convert.params_from_jax`); without it the
    weights are drawn from ``generator``.  The weights are trainable
    parameters (Alg. 1 trains them in ``mode="train"``).
    """

    def __init__(self, spec: LSTMSpec, n_classes: int, *, params=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if params is None:
            if generator is None:
                raise ValueError("LSTMClassifier needs params or a generator")
            params = classifier_init(generator, spec, n_classes)
        self.spec = spec
        self.w_gates = nn.Parameter(params["lstm"]["w_gates"].to(device))
        self.w_proj = None
        if spec.n_proj:
            self.w_proj = nn.Parameter(params["lstm"]["w_proj"].to(device))
        self.fc_w = nn.Parameter(params["fc"]["w"].to(device))
        self.acts = make_gate_acts(spec.analog, spec.n_hidden, device)

    def params(self):
        lstm = {"w_gates": self.w_gates}
        if self.w_proj is not None:
            lstm["w_proj"] = self.w_proj
        return {"lstm": lstm, "fc": {"w": self.fc_w}}

    def forward(self, xs, *, noise: Optional[NoiseSource] = None,
                all_steps: bool = False):
        return classifier_apply(self.params(), xs, self.spec, self.acts,
                                noise=noise, all_steps=all_steps)
