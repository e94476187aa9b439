"""Analog crossbar layers: config, NL-ADC activations, matmul orchestration.

The paper's technique as torch pieces:

    y = NLADC_g( PWM_quant(x) @ (W + noise) + b )

Operating modes:

* ``exact``  — quantized inputs and NL-ADC activations, no device noise;
               with ``enabled=False`` the float software baseline (the
               exact activations of :mod:`repro_torch.nn.activations`);
* ``train``  — hardware-aware training (Alg. 1): the device model's
               ``TrainNoise`` added to the clipped weights (a constant with
               respect to them, so the gradient reaches the clean shadow
               weights) and to the ideal ramp's steps, drawn per call;
               NL-ADC and PWM quantization with straight-through backwards;
* ``infer``  — deployment simulation: the device model's build stage
               (programmed ramps: write noise + redundancy + calibration +
               drift, drawn once, host-side; the weights are aged once by
               ``DeviceModel.age_params``) + per-step read noise + NL-ADC.

Under the circuit-level stages, train and infer mode also pass the PWM
inputs through the ``NonlinearIV`` transform and the noisy weights
through the ``LineResistance`` correction per crossbar tile.

**Ramp noise in train mode.**  Each call's thresholds are
``sort(v_init + cumsum(steps + sigma_us * z * g_scale))`` over the ideal
ramp's steps (per bank where banked): noise on one step's memristor shifts
every later level.  ``z`` is one standard-normal draw of the thresholds'
shape, ``(P,)`` or ``(n_banks, P)``, from the :class:`NoiseSource`; the
prefix sum is ``torch.cumsum`` in float32.  The reference computes the same
expression under ``jax.jit``, where XLA folds ``sqrt(2) * sigma_us *
g_scale`` into one constant inside its normal draw and sums in rows of 16,
so the two agree within a few float32 ulps of the ramp's largest level,
not bitwise (``tests/test_torch_train_noise.py`` states the bound).

This module is orchestration only: mode logic, quantization and the noise
draws are shared code, and the LSTM tail, the elementwise NL-ADC
(:class:`AnalogActivation`), the LM's fused gate projection
(:func:`dense_nladc`) and the MoE's per-expert gate
(:func:`moe_gate_nladc`) dispatch through :mod:`repro_torch.core.backend`
(``ref`` torch, or the ``cuda`` kernels).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import backend as BK
from repro_torch.core import crossbar
from repro_torch.core.crossbar import NoiseSource
from repro_torch.core.device import IDEAL, DeviceModel, resolve_device
from repro_torch.core.nladc import (NLADC, BankedThresholds, Ramp,
                                    bank_map_for, build_ramp,
                                    check_threshold_degeneracy, pwm_quantize)
from repro_torch.nn import activations

MODES = ("exact", "train", "infer")


@dataclasses.dataclass(frozen=True)
class AnalogConfig:
    """Knobs for the analog-hardware simulation (paper Methods).

    ``device`` accepts a :class:`DeviceModel` or a preset name; a name
    (including the default, which honors ``REPRO_DEVICE``) is resolved to
    the model at construction time.  ``bank_cols`` > 0 gives one
    independently programmed ramp per group of ``bank_cols`` output columns
    (the ``(n_col_tiles, P)`` banked layout); 0 shares one ``(P,)`` ramp.
    """

    enabled: bool = True
    adc_bits: int = 5
    input_bits: Optional[int] = 5
    input_clip: float = 1.0
    mode: str = "exact"                   # exact | train | infer
    backend: str = ""                     # "" = auto (env) | ref | cuda
    device: DeviceModel = ""              # model | preset name | "" = auto
    bank_cols: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown analog mode {self.mode!r}; "
                             f"known: {MODES}")
        if not isinstance(self.device, DeviceModel):
            object.__setattr__(self, "device", resolve_device(self.device))

    def replace(self, **kw) -> "AnalogConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_spec(cls, spec, **kw) -> "AnalogConfig":
        """Build from a :class:`repro_torch.configs.base.AnalogSpec`;
        ``**kw`` may override ``input_clip``, ``device`` and
        ``bank_cols``."""
        fixed = ("enabled", "adc_bits", "input_bits", "mode", "backend")
        valid = {f.name for f in dataclasses.fields(cls)} - set(fixed)
        for k in kw:
            if k not in valid:
                where = "is fixed by the spec" if k in fixed else "is unknown"
                raise TypeError(
                    f"AnalogConfig.from_spec: {k!r} {where}; "
                    f"overridable fields: {sorted(valid)}")
        kw.setdefault("device", resolve_device(spec.device))
        kw.setdefault("bank_cols", spec.bank_cols)
        return cls(enabled=spec.enabled, adc_bits=spec.adc_bits,
                   input_bits=spec.input_bits, mode=spec.mode,
                   backend=spec.backend, **kw)


# Explicit device=IDEAL: constructed at import time, where consulting
# REPRO_DEVICE could name a preset that is registered later.
EXACT = AnalogConfig(enabled=False, mode="exact", device=IDEAL)


def _noisy_ramp(v_init, steps: torch.Tensor, g_scale, z: torch.Tensor,
                sigma_us: float) -> torch.Tensor:
    """One call's train-noise thresholds: ``sort(v_init + cumsum(steps +
    sigma_us * z * g_scale))`` along the last axis, for one ramp
    (``(P,)`` steps, float ``v_init`` and ``g_scale``) or one per bank
    (``(n_banks, P)`` steps, ``(n_banks, 1)`` tensors).  Sorted: strong
    step noise can de-order neighbouring levels; the thermometer count does
    not care, searchsorted does."""
    noisy = steps + (sigma_us * z) * g_scale
    return torch.sort(v_init + torch.cumsum(noisy, dim=-1), dim=-1).values


class DeployedBank:
    """One activation's ``(n_col_tiles, P)`` threshold bank at one width.

    Holds the per-col-tile programmed ramps, their float64 stack (the
    ground truth, which a deployment checkpoint records) and the float32
    operand the backends consume.
    """

    def __init__(self, ideal: Ramp, ramps, width: int, bank_cols: int,
                 device=None):
        self.ideal = ideal
        self.width = width
        self.device = device
        self.bank_map = bank_map_for(width, bank_cols)
        self.redeploy(ramps)

    @property
    def n_banks(self) -> int:
        return self.bank_map.n_banks

    def redeploy(self, ramps) -> None:
        """Swap in newly realized per-bank ramps (a chip re-program)."""
        device = self.device
        ramps = tuple(ramps)
        if len(ramps) != self.bank_map.n_banks:
            raise ValueError(f"expected {self.bank_map.n_banks} bank ramps, "
                             f"got {len(ramps)}")
        self.ramps = ramps
        self.thresholds_f64 = np.stack(
            [np.asarray(r.thresholds, np.float64) for r in ramps])
        for j, r in enumerate(ramps):
            check_threshold_degeneracy(
                self.thresholds_f64[j], f"{r.name}[bank {j}]", np.float32)
        thr = torch.from_numpy(self.thresholds_f64.astype(np.float32))
        self.thresholds = BankedThresholds(thr.to(device), self.bank_map)
        # per-bank step geometry for the train-noise draw: the noise
        # compounds along each bank's own prefix sum, as on its chip
        self._steps = torch.from_numpy(np.stack(
            [r.steps for r in ramps]).astype(np.float32)).to(device)
        self._v_init = torch.from_numpy(np.asarray(
            [r.v_init for r in ramps], np.float32)[:, None]).to(device)
        self._g_scale = torch.from_numpy(np.asarray(
            [r.g_scale for r in ramps], np.float32)[:, None]).to(device)

    def deployed(self) -> tuple:
        """What this bank serves now (its ramps and their tensors), for
        :meth:`serve` to put back."""
        return (self.ramps, self.thresholds_f64, self.thresholds,
                self._steps, self._v_init, self._g_scale)

    def serve(self, deployed: tuple) -> None:
        """Serve a state taken by :meth:`deployed` (no copy, no upload)."""
        (self.ramps, self.thresholds_f64, self.thresholds, self._steps,
         self._v_init, self._g_scale) = deployed

    def thresholds_for(self, z: Optional[torch.Tensor] = None,
                       sigma_us: float = 0.0) -> BankedThresholds:
        """The banked comparator levels of one call: the deployed ones, or
        each bank's ramp with ``sigma_us * z`` on its steps (``z``:
        ``(n_banks, P)`` standard normals)."""
        if z is None or sigma_us <= 0:
            return self.thresholds
        return BankedThresholds(
            _noisy_ramp(self._v_init, self._steps, self._g_scale, z,
                        sigma_us), self.bank_map)


class AnalogActivation:
    """An activation realized by an NL-ADC ramp (or exactly, per config).

    In ``infer`` mode the device model's build stage programs the ramp
    (and, per width, the col-tile banks) once, host-side; in ``train`` mode
    the ideal ramp's steps take fresh noise at every call
    (:meth:`thresholds_for`).
    """

    def __init__(self, name: str, cfg: AnalogConfig, device=None):
        self.name = name
        self.cfg = cfg
        self.device = device
        self._adc: Optional[NLADC] = None
        self._ideal_ramp: Optional[Ramp] = None
        self._banks: dict = {}              # width -> DeployedBank
        if cfg.enabled:
            ramp = build_ramp(name, cfg.adc_bits)
            self._ideal_ramp = ramp
            if cfg.mode == "infer":
                ramp = cfg.device.deploy_ramp(ramp)
            self._adc = NLADC(ramp, device)
            self._steps = torch.from_numpy(
                np.asarray(ramp.steps, np.float32)).to(device)

    @property
    def adc(self) -> Optional[NLADC]:
        return self._adc

    @property
    def ramp(self) -> Optional[Ramp]:
        return self._adc.ramp if self._adc is not None else None

    @property
    def ideal_ramp(self) -> Optional[Ramp]:
        """The as-designed ramp, before any build-stage programming."""
        return self._ideal_ramp

    def redeploy(self, ramp: Ramp) -> None:
        """Swap in newly realized comparator thresholds (a chip re-program
        or a deployment restore); the next call reads them."""
        if self._adc is None:
            raise ValueError(f"activation {self.name!r} has no NL-ADC")
        self._adc = NLADC(ramp, self.device)
        self._steps = torch.from_numpy(
            np.asarray(ramp.steps, np.float32)).to(self.device)

    def deployed(self) -> tuple:
        """What the activation serves now: its NL-ADC and every realized
        bank's state, for :meth:`serve` to put back (the serving engine
        keeps the chip each of its paths was programmed with)."""
        return (self._adc, self._steps,
                {w: b.deployed() for w, b in self._banks.items()})

    def serve(self, deployed: tuple) -> None:
        """Serve a state taken by :meth:`deployed`: no copy and no upload.
        A bank realized since keeps its own state."""
        self._adc, self._steps, banks = deployed
        for width, state in banks.items():
            self._banks[width].serve(state)

    def n_banks(self, width: int) -> int:
        """Col-tiles an application of this activation at ``width`` spans."""
        if self.cfg.bank_cols <= 0 or width <= 0:
            return 1
        return -(-width // self.cfg.bank_cols)

    def bank_for(self, width: int) -> Optional[DeployedBank]:
        """The deployed threshold bank for one application width.

        ``None`` when banking is off, the activation carries no ramp, or
        the width fits one col-tile (the ``(P,)`` layout).  The per-bank
        draws are keyed purely by the bank index, so realization order
        never changes a bank's chip.
        """
        if self._adc is None or self.n_banks(width) <= 1:
            return None
        bank = self._banks.get(width)
        if bank is None:
            n = self.n_banks(width)
            if self.cfg.mode == "infer":
                ramps = self.cfg.device.deploy_ramp_bank(self._ideal_ramp, n)
            else:
                ramps = (self._ideal_ramp,) * n
            bank = self._banks[width] = DeployedBank(
                self._ideal_ramp, ramps, width, self.cfg.bank_cols,
                self.device)
        return bank

    def banks(self) -> dict:
        """Realized banks, width -> :class:`DeployedBank` (a copy)."""
        return dict(self._banks)

    def redeploy_bank(self, width: int, ramps) -> None:
        """Re-program one width's bank (a deployment restore)."""
        bank = self.bank_for(width)
        if bank is None:
            raise ValueError(
                f"activation {self.name!r} has no bank at width {width} "
                f"(bank_cols={self.cfg.bank_cols})")
        bank.redeploy(ramps)

    def ramp_sigma_us(self) -> float:
        """The per-call ramp-step noise (µS): the device model's
        ``TrainNoise`` in train mode, else 0."""
        if self._adc is None:
            return 0.0
        return self.cfg.device.ramp_sigma_us(self.cfg.mode)

    def _ramp_shape(self, width: int) -> tuple:
        bank = self.bank_for(width) if width else None
        return tuple(bank.thresholds.thr.shape) if bank is not None \
            else tuple(self._adc.thresholds.shape)

    def ramp_noise(self, noise: Optional[NoiseSource],
                   width: int = 0) -> Optional[torch.Tensor]:
        """One call's standard-normal ramp draw at ``width``: ``(P,)``, or
        ``(n_banks, P)`` where the width spans several banks; ``None``
        when there is no source or no ramp noise in this mode."""
        if noise is None or self.ramp_sigma_us() <= 0:
            return None
        return noise.normal(self._ramp_shape(width),
                            self._adc.thresholds.device)

    def ramp_draws(self, noise: Optional[NoiseSource],
                   widths) -> Optional[Dict[int, torch.Tensor]]:
        """The ramp draws of applications at ``widths`` that share one
        key in the reference: ``{width: z}``, one draw per distinct
        threshold shape in the order of first use, so widths of one shape
        see the same thresholds (``normal(key, shape)`` twice).  The LM
        draws a layer's before its (checkpointed) body.  ``None`` when
        :meth:`ramp_noise` would draw nothing."""
        if noise is None or self.ramp_sigma_us() <= 0:
            return None
        by_shape: Dict[tuple, torch.Tensor] = {}
        draws = {}
        for width in widths:
            shape = self._ramp_shape(width)
            if shape not in by_shape:
                by_shape[shape] = noise.normal(shape,
                                               self._adc.thresholds.device)
            draws[width] = by_shape[shape]
        return draws

    def thresholds_for(self, width: int = 0,
                       noise: Optional[NoiseSource] = None, *,
                       z: Optional[torch.Tensor] = None):
        """Comparator thresholds for one call at ``width`` output columns:
        a :class:`BankedThresholds` when the width spans several banked
        col-tiles, else the ``(P,)`` tensor.

        In train mode the ramp steps take ``sigma_us * z`` (µS, times the
        ramp's volts per µS), re-accumulated and sorted: ``z`` is given,
        or drawn from ``noise`` (:meth:`ramp_noise`).  The LSTM cell draws
        one ``z`` a step and hands it to both the sigmoid and the tanh
        thresholds, as the reference derives both from one key."""
        sigma_us = self.ramp_sigma_us()
        if z is None and sigma_us > 0:
            z = self.ramp_noise(noise, width)
        bank = self.bank_for(width) if width else None
        if bank is not None:
            return bank.thresholds_for(z, sigma_us)
        if z is None or sigma_us <= 0:
            return self._adc.thresholds
        ramp = self._adc.ramp
        return _noisy_ramp(ramp.v_init, self._steps, ramp.g_scale, z,
                           sigma_us)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.cfg.enabled or self._adc is None:
            return activations.exact(self.name)(x)
        bk = BK.get_backend(self.cfg.backend)
        return bk.nladc(x, self._adc,
                        thresholds=self.thresholds_for(x.shape[-1]))


def _noisy_weights(w: torch.Tensor, cfg: AnalogConfig,
                   noise: Optional[NoiseSource]) -> torch.Tensor:
    """Clip to the programmable range, add the mode's weight noise, and
    apply the line stage's IR correction.

    One standard-normal draw of ``w``'s shape per call when ``noise`` is
    given and the device model has the mode's stage: ``TrainNoise`` in
    train mode (Alg. 1: ``W + sigma * z``, the draw a constant, so the
    gradient reaches the clean weight; one draw per weight even under
    paired noise, as in the reference), ``ReadNoise`` in infer mode, where
    ``paired_noise`` draws per device instead (two draws, positive device
    first: :func:`crossbar.read_noise_weights_paired`).  Then, in every
    mode but ``exact``, the ``LineResistance`` correction per crossbar
    tile (:func:`crossbar.ir_effective_weights_tiled`), differentiable, so
    training sees the wires.  The correction runs under
    ``torch.utils.checkpoint``: where a gradient is asked for, autograd
    keeps only its input and the backward recomputes it (the same bits;
    one copy of the weight a call, not the correction's ~30
    intermediates).  The noise is drawn before it, so the recompute draws
    nothing, and no RNG state is saved or restored.
    All of it precedes the backend seam: ``ref`` and ``cuda`` get the same
    operands.
    """
    w = crossbar.clip_weights(w)
    dev = cfg.device
    sigma_w = dev.weight_sigma_w(cfg.mode)
    if noise is not None and sigma_w > 0:
        if cfg.mode == "infer" and dev.paired_noise:
            w = crossbar.read_noise_weights_paired(noise, w, sigma_w)
        else:
            w = w + crossbar.read_noise_weights(noise, w.shape, w.device,
                                                sigma_w)
    if dev.line is not None and cfg.mode != "exact":
        ln = dev.line
        w = checkpoint(crossbar.ir_effective_weights_tiled, w, ln.r_wl_ohm,
                       ln.r_bl_ohm, ln.sourcing, ln.n_iter,
                       use_reentrant=False, preserve_rng_state=False)
    return w


def analog_matmul_act(x: torch.Tensor, w: torch.Tensor, cfg: AnalogConfig,
                      *, noise: Optional[NoiseSource] = None,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Crossbar MAC: PWM-quantized inputs (through the ``NonlinearIV``
    read transform where the device model has one, outside exact mode)
    times clipped, noisy, IR-corrected weights, float32 accumulation.
    ``noise`` supplies the per-step draws; ``None`` draws nothing (exact
    mode)."""
    if cfg.enabled:
        if cfg.input_bits is not None:
            x = pwm_quantize(x, cfg.input_bits, cfg.input_clip)
        iv = cfg.device.nonlinear_iv
        if iv is not None and cfg.mode != "exact":
            x = crossbar.nonlinear_iv_read(x, iv.alpha, cfg.input_clip)
        w = _noisy_weights(w, cfg, noise)
    y = torch.matmul(x, w)
    if bias is not None:
        y = y + bias
    return y


def dense_nladc(p, x: torch.Tensor, act: Optional[AnalogActivation], *,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense layer (params dict ``{w[, b]}``) with a fused NL-ADC epilogue.

    The LM-family path: the analog spec quantizes activations only (no
    crossbar weight or input noise, in every mode), so this is dense ->
    NL-ADC, one kernel on the ``cuda`` backend.  Matches
    ``act(layers.dense_apply(p, x))`` on the ``ref`` backend (matmul in
    x's compute dtype).  ``z``: the call's train-mode ramp draw
    (:meth:`AnalogActivation.ramp_draws`); infer mode reads the ramps
    programmed at build time.
    """
    w, b = p["w"], p.get("b")
    if act is None or not act.cfg.enabled or act.ramp is None:
        y = x @ w.to(x.dtype)
        if b is not None:
            y = y + b.to(y.dtype)
        return act(y) if act is not None else y
    bk = BK.get_backend(act.cfg.backend)
    return bk.matmul_nladc(x, w, act.adc, bias=b,
                           thresholds=act.thresholds_for(w.shape[-1], z=z))


def moe_gate_nladc(x_buf: torch.Tensor, w_gate: torch.Tensor,
                   act: Optional[AnalogActivation], *,
                   z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-expert MoE gate einsum with a fused NL-ADC epilogue.

    x_buf: (E, C, d) dispatched expert buffers, w_gate: (E, d, f) stacked
    expert weights.  Matches ``act(einsum("ecd,edf->ecf", x_buf,
    w_gate.to(x_buf.dtype)))`` on the ``ref`` backend; on ``cuda`` the
    einsum and the NL-ADC are one grouped kernel over the experts (the
    backend's ``moe_matmul_nladc``).  ``z`` as in :func:`dense_nladc`.
    """
    if act is None or not act.cfg.enabled or act.ramp is None:
        h = torch.einsum("ecd,edf->ecf", x_buf, w_gate.to(x_buf.dtype))
        return act(h) if act is not None else h
    bk = BK.get_backend(act.cfg.backend)
    return bk.moe_matmul_nladc(
        x_buf, w_gate, act.adc,
        thresholds=act.thresholds_for(w_gate.shape[-1], z=z))
