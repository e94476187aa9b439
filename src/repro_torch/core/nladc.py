"""NL-ADC: nonlinear-function-approximating ramp ADC (the paper's core).

Eqs. (1)-(3) and Supp. Notes S1/S12, as host-side numpy ramp tables plus a
torch forward:

* ``build_ramp``              — monotonic ramp: P = 2^b output levels
                                uniformly spaced in y; thresholds
                                ``V_k = g^{-1}(y_k)``.
* ``build_nonmonotonic_ramp`` — extremum-split ramp for gelu/swish (Supp.
                                S12): thresholds ascending in x across both
                                branches, decode ``y = y0 + LSB * |n - m|``.
* ``nladc_forward``           — thermometer-code count
                                ``n = #{V_k < x}`` -> table lookup.
* ``nladc_apply``             — the same with the straight-through backward
                                ``ct * g'(x)`` gated to the ramp's domain
                                (:func:`nladc_ste`), flat or banked.
* ``pwm_quantize``            — b_in-bit PWM input quantization (uniform),
                                with a clipped straight-through backward.

The ramp tables are float64 numpy (they model *programmed memristor
conductances*); the quantizer consumes them as float32 tensors.  Write noise
on the programmed ramp perturbs the *steps* (one memristor each, Fig. 2d)
and re-accumulates them, which is why one-point calibration
(:mod:`repro_torch.core.calibration`) exists.

**Threshold banks.**  One physical ramp generator serves the comparator bank
of ONE crossbar tile; a matrix wider than a tile spans several col-tiles,
each with its own programmed ramp.  The banked layout is
``(n_col_tiles, P)``: :class:`BankedThresholds` carries the stacked
per-bank levels plus a static column->bank map (:class:`BankMap`), and each
output column is quantized against its own bank's ramp.  With one bank the
layout collapses to the ``(P,)`` vector.

**Straight-through gradients (Alg. 1).**  The quantizers are
``torch.autograd.Function`` subclasses whose backward is the JAX package's
``custom_vjp``: the NL-ADC passes ``ct * g'(x)`` where
``x_lo <= x <= x_hi`` (inclusive) and 0 elsewhere, and gives the
thresholds and the table no gradient; the PWM quantizer passes ``ct``
where ``-x_max <= x <= x_max`` and 0 elsewhere.  Without them autograd
through ``torch.round`` and the table lookup gives 0 and no path to x.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import functions as F

G_MAX_US = 150.0  # maximum programmable conductance, uS (paper Methods)


class DegenerateThresholdWarning(UserWarning):
    """Adjacent comparator thresholds collapsed to one float32 value.

    The ramp tables are float64 ground truth, but the comparator operands
    are float32: two adjacent programmed thresholds can round to the *same*
    float32, and the strict comparator then never emits the code between
    them.  Detected when a ramp is deployed, not where the cast happens.
    """


def check_threshold_degeneracy(thresholds_f64, name: str,
                               dtype=np.float32) -> int:
    """Warn if distinct f64 thresholds become equal after the f32 cast.

    Returns the number of degenerate adjacent pairs.  Exactly-equal f64
    neighbours (a genuinely flat programmed step, e.g. a stuck-at-OFF ramp
    device) are the chip's own doing and not counted.
    """
    t64 = np.asarray(thresholds_f64, np.float64)
    t32 = t64.astype(dtype)
    merged = (np.diff(t32, axis=-1) == 0) & (np.diff(t64, axis=-1) != 0)
    n_bad = int(np.count_nonzero(merged))
    if n_bad:
        warnings.warn(
            f"ramp {name!r}: {n_bad} adjacent threshold pair(s) are "
            f"distinct in float64 but collapse to the same {np.dtype(dtype)} "
            f"value — the comparator will never emit the code(s) between "
            f"them (merged ADC codes). Seen under heavy IR drop or high-P "
            f"ramps; consider double-side sourcing, lower r_wire, or fewer "
            f"bits.", DegenerateThresholdWarning, stacklevel=3)
    return n_bad


@dataclasses.dataclass(frozen=True)
class Ramp:
    """A programmed NL-ADC ramp.

    Attributes:
      name:        activation name.
      bits:        ADC resolution b; P = 2^b steps, P+1 output codes.
      thresholds:  (P,) ascending comparator thresholds in x-space.
      y_table:     (P+1,) output value for thermometer count n = 0..P.
      steps:       (P,) ``dV_k = V_k - V_{k-1}``; each maps to ONE memristor.
      v_init:      ramp start ``V_0``.
      split_index: extremum code index m for non-monotonic decode; -1 if
                   monotonic.
      monotonic_split: selu's piecewise-uniform (but monotonic) y table.
    """

    name: str
    bits: int
    thresholds: np.ndarray
    y_table: np.ndarray
    steps: np.ndarray
    v_init: float
    split_index: int = -1
    monotonic_split: bool = False

    @property
    def n_levels(self) -> int:
        return int(self.y_table.shape[0])

    @property
    def lsb(self) -> float:
        """Output LSB (uniform in y by construction)."""
        return float(np.mean(np.abs(np.diff(self.y_table))))

    def conductances_us(self) -> np.ndarray:
        """Ramp steps as memristor conductances (max 150 uS, one per step)."""
        mags = np.abs(self.steps)
        return mags * (G_MAX_US / float(np.max(mags)))

    @property
    def g_scale(self) -> float:
        """Volts-per-uS scale used by :func:`ramp_from_conductances`."""
        return float(np.max(np.abs(self.steps))) / G_MAX_US

    def with_thresholds(self, thresholds: np.ndarray) -> "Ramp":
        return dataclasses.replace(self, thresholds=np.asarray(thresholds))


# ---------------------------------------------------------------------------
# Ramp construction (host-side, float64)
# ---------------------------------------------------------------------------

def build_ramp(name: str, bits: int,
               x_lo: Optional[float] = None,
               x_hi: Optional[float] = None) -> Ramp:
    """Monotonic NL ramp per Eq. (3) / Supp. Tab. S2."""
    spec = F.get(name)
    if not spec.monotonic:
        return build_nonmonotonic_ramp(name, bits, x_lo=x_lo, x_hi=x_hi)
    if bits < 1 or bits > 12:
        raise ValueError(f"bits must be in [1, 12], got {bits}")
    if name == "selu":
        # Tab. S2 lists IDENTICAL dV_k for elu and selu: the paper reuses
        # the elu sampling x-grid (y is then uniform per branch, factor-4
        # different LSBs across the x=0 split).
        elu = build_ramp("elu", bits, x_lo=x_lo, x_hi=x_hi)
        v = np.concatenate([[elu.v_init], elu.thresholds])
        y = np.asarray(spec.fwd(v), dtype=np.float64)
        m = int(np.argmin(np.abs(v)))
        return Ramp(name="selu", bits=bits, thresholds=v[1:].copy(),
                    y_table=y, steps=np.diff(v), v_init=float(v[0]),
                    split_index=m, monotonic_split=True)
    x_lo = spec.x_lo if x_lo is None else x_lo
    x_hi = spec.x_hi if x_hi is None else x_hi
    p = 1 << bits
    y_lo = float(spec.fwd(np.asarray(x_lo, np.float64)))
    y_hi = float(spec.fwd(np.asarray(x_hi, np.float64)))
    # P+1 output levels uniform in y (the crossing time encodes g(V_in)).
    y_levels = np.linspace(y_lo, y_hi, p + 1, dtype=np.float64)
    v = spec.inv(np.clip(y_levels, min(y_lo, y_hi) + 0.0, max(y_lo, y_hi)))
    v = np.asarray(v, dtype=np.float64)
    v[0], v[-1] = x_lo, x_hi       # guard against inf at the saturation edges
    if not np.all(np.diff(v) > 0):
        raise ValueError(f"ramp for {name} is not strictly increasing")
    return Ramp(name=name, bits=bits, thresholds=v[1:].copy(),
                y_table=y_levels.copy(), steps=np.diff(v),
                v_init=float(v[0]), split_index=-1)


def build_nonmonotonic_ramp(name: str, bits: int,
                            x_lo: Optional[float] = None,
                            x_hi: Optional[float] = None,
                            extra_negative_points: int = 0) -> Ramp:
    """Extremum-split ramp for non-monotonic activations (Supp. S12).

    The output range is cut into uniform-in-y steps shared by both
    branches; thresholds ascend in x across the (decreasing) left branch,
    the extremum, and the (increasing) right branch.
    ``extra_negative_points`` shifts that many codes from the right branch
    to the short left one (the Fig. S13f/g refinement).
    """
    spec = F.get(name)
    if spec.monotonic:
        raise ValueError(f"{name} is monotonic; use build_ramp")
    x_lo = spec.x_lo if x_lo is None else x_lo
    x_hi = spec.x_hi if x_hi is None else x_hi
    p = 1 << bits
    xm = float(spec.x_extremum)
    y0 = float(spec.fwd(np.asarray(xm, np.float64)))
    y_left = float(spec.fwd(np.asarray(x_lo, np.float64)))
    y_right = float(spec.fwd(np.asarray(x_hi, np.float64)))
    total_extent = (y_left - y0) + (y_right - y0)
    lsb = total_extent / p
    m = int(round((y_left - y0) / lsb)) + extra_negative_points
    m = max(1, min(p - 1, m))
    if extra_negative_points:
        lsb_left = (y_left - y0) / m
        lsb_right = (y_right - y0) / (p - m)
    else:
        lsb_left = lsb_right = lsb
    ks_left = np.arange(m, 0, -1, dtype=np.float64)
    x_left = spec.inv_left(y0 + ks_left * lsb_left)
    ks_right = np.arange(1, p - m + 1, dtype=np.float64)
    x_right = spec.inv_right(y0 + ks_right * lsb_right)
    v = np.concatenate(
        [np.asarray(x_left, np.float64), [xm], np.asarray(x_right, np.float64)]
    )  # length P+1: V_0..V_P
    v[0], v[-1] = min(v[0], x_lo), max(v[-1], x_hi)
    if not np.all(np.diff(v) > 0):
        raise ValueError(
            f"non-monotonic ramp for {name} is not ascending in x")
    ns = np.arange(p + 1, dtype=np.float64)
    y_table = np.where(
        ns <= m, y0 + (m - ns) * lsb_left, y0 + (ns - m) * lsb_right
    )
    return Ramp(name=name, bits=bits, thresholds=v[1:].copy(),
                y_table=y_table, steps=np.diff(v), v_init=float(v[0]),
                split_index=m)


def ramp_from_conductances(ramp: Ramp, g_us: np.ndarray,
                           v_init: Optional[float] = None) -> Ramp:
    """Rebuild threshold levels from (possibly noisy) conductances.

    ``V'_k = V_init + sum_{i<=k} dV'_i`` with ``dV'_i = g_scale * G'_i``:
    write noise on any single device shifts *all* later levels (Fig. S10c).
    """
    g_us = np.asarray(g_us, dtype=np.float64)
    if g_us.shape != ramp.steps.shape:
        raise ValueError(
            f"expected {ramp.steps.shape} conductances, got {g_us.shape}")
    dv = g_us * ramp.g_scale * np.sign(
        ramp.steps + np.where(ramp.steps == 0, 1e-30, 0.0))
    v0 = ramp.v_init if v_init is None else v_init
    return ramp.with_thresholds(v0 + np.cumsum(dv))


def inl_lsb(programmed: Ramp, ideal: Ramp) -> Tuple[float, float]:
    """(mean, max) integral nonlinearity in units of the local ideal step."""
    dev = (programmed.thresholds - ideal.thresholds) / np.maximum(
        np.abs(ideal.steps), 1e-12)
    return float(np.mean(np.abs(dev))), float(np.max(np.abs(dev)))


# ---------------------------------------------------------------------------
# The comparator bank (torch forward)
# ---------------------------------------------------------------------------

def nladc_codes(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Thermometer count ``n = #{V_k < x}``: the STRICT comparator of
    Eq. (3).  ``right=False`` returns the count of thresholds strictly
    below ``x``, so an input exactly on a threshold does not cross it."""
    return torch.searchsorted(thresholds, x.to(thresholds.dtype).contiguous(),
                              right=False)


def nladc_forward(x: torch.Tensor, thresholds: torch.Tensor,
                  y_table: torch.Tensor) -> torch.Tensor:
    """Quantize ``x`` against one ``(P,)`` ramp: count, then table decode."""
    return y_table[nladc_codes(x, thresholds)].to(x.dtype)


def nladc_ste(grad_name: str, x: torch.Tensor,
              ct: torch.Tensor) -> torch.Tensor:
    """The NL-ADC straight-through backward: ``ct * g'(x)``, gated to the
    ramp's domain ``[x_lo, x_hi]`` (inclusive; saturated inputs pass
    nothing): :func:`functions.ste_tensor` over the registered domain,
    which the LSTM tail's backward (``kernels/lstm_cell.py``) calls with
    the ramps' own."""
    spec = F.get(grad_name)
    return F.ste_tensor(spec.name, x, ct, (spec.x_lo, spec.x_hi))


class BankMap:
    """A static, hashable column->bank index map.

    ``idx[j]`` is the bank (col-tile) whose ramp digitizes output column
    ``j``.  The array is host-side and frozen: it is chip wiring.
    """

    __slots__ = ("idx", "_key")

    def __init__(self, idx):
        arr = np.ascontiguousarray(np.asarray(idx, np.int32))
        arr.setflags(write=False)
        self.idx = arr
        self._key = (arr.tobytes(), arr.shape)

    @property
    def n_cols(self) -> int:
        return int(self.idx.shape[0])

    @property
    def n_banks(self) -> int:
        return int(self.idx.max()) + 1 if self.idx.size else 1

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, BankMap) and self._key == other._key

    def __repr__(self):
        return f"BankMap(n_cols={self.n_cols}, n_banks={self.n_banks})"


def bank_map_for(width: int, tile_cols: int) -> BankMap:
    """Bank j = cols ``j*tile_cols`` up to the logical width (the last
    col-tile of a non-multiple matrix is partial)."""
    if tile_cols <= 0:
        raise ValueError(f"tile_cols must be positive, got {tile_cols}")
    return BankMap(np.arange(width, dtype=np.int64) // tile_cols)


@dataclasses.dataclass(eq=False)
class BankedThresholds:
    """The ``(n_col_tiles, P)`` comparator-level operand plus its map."""

    thr: torch.Tensor            # (n_banks, P)
    bank_map: BankMap

    @property
    def n_banks(self) -> int:
        return int(self.thr.shape[0])

    @functools.cached_property
    def per_column(self) -> torch.Tensor:
        """The dense ``(N, P)`` per-column operand: each column's bank row,
        gathered once (the operand is fixed for a deployment)."""
        idx = torch.from_numpy(self.bank_map.idx.astype(np.int64))
        return self.thr[idx.to(self.thr.device)].contiguous()


def nladc_banked_codes(x: torch.Tensor,
                       thresholds: BankedThresholds) -> torch.Tensor:
    """Per-column thermometer count against the column's own bank ramp
    (a bank-gathered ``searchsorted``, same strict comparator), laid out
    row-major like ``x``: a column-major result would carry its strides
    into every elementwise op after it, and a matmul that later takes such
    an operand runs another cuBLAS kernel, which sums in another order."""
    thr_cols = thresholds.per_column                         # (N, P)
    n_cols = thr_cols.shape[0]
    if x.shape[-1] != n_cols:
        raise ValueError(f"bank map covers {n_cols} columns but the operand "
                         f"has {x.shape[-1]}")
    xm = x.to(thr_cols.dtype).movedim(-1, 0)
    lead = xm.shape[1:]
    n = torch.searchsorted(thr_cols, xm.reshape(n_cols, -1).contiguous(),
                           right=False)
    return n.reshape((n_cols,) + lead).movedim(0, -1).contiguous()


def _nladc_any(x, thresholds, y_table):
    """Count and decode against a ``(P,)`` ramp or
    :class:`BankedThresholds`."""
    if isinstance(thresholds, BankedThresholds):
        return y_table[nladc_banked_codes(x, thresholds)].to(x.dtype)
    return nladc_forward(x, thresholds, y_table)


class _NLADCFunction(torch.autograd.Function):
    """Forward: the strict-comparator count and the table decode; backward:
    :func:`nladc_ste` on the saved input.  The thresholds and the table get
    no gradient."""

    @staticmethod
    def forward(ctx, x, thresholds, y_table, grad_name):
        ctx.grad_name = grad_name
        ctx.save_for_backward(x)
        return _nladc_any(x, thresholds, y_table)

    @staticmethod
    def backward(ctx, ct):
        (x,) = ctx.saved_tensors
        return nladc_ste(ctx.grad_name, x, ct), None, None, None


def nladc_apply(x: torch.Tensor, thresholds, y_table: torch.Tensor,
                grad_name: str) -> torch.Tensor:
    """The NL-ADC with its straight-through gradient: ``y_table[n]`` with
    ``n = #{V_k < x}`` forward, ``ct * g'(x)`` on ``[x_lo, x_hi]``
    backward.  ``thresholds``: a ``(P,)`` tensor or
    :class:`BankedThresholds`.  The path follows ``x.requires_grad``
    under grad mode: without it the forward runs alone, with no autograd
    function per call, which made the infer step slower (``PERF.md``
    §6)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _NLADCFunction.apply(x, thresholds, y_table, grad_name)
    return _nladc_any(x, thresholds, y_table)


class NLADC:
    """A programmed :class:`Ramp` as float32 tensors on one device.

    >>> adc = NLADC(build_ramp("sigmoid", 5))
    >>> y = adc(x)           # quantized sigmoid
    """

    def __init__(self, ramp: Ramp, device=None):
        self.ramp = ramp
        check_threshold_degeneracy(ramp.thresholds, ramp.name, np.float32)
        self.thresholds = torch.from_numpy(
            np.asarray(ramp.thresholds, np.float32)).to(device)
        self.y_table = torch.from_numpy(
            np.asarray(ramp.y_table, np.float32)).to(device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return nladc_apply(x, self.thresholds, self.y_table, self.ramp.name)

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        """Raw thermometer count n = #{V_k < x} (the chip's native output)."""
        return nladc_codes(x, self.thresholds)


def nladc_reference(x: np.ndarray, ramp: Ramp) -> np.ndarray:
    """Pure-numpy oracle."""
    x = np.asarray(x)
    n = np.sum(x[..., None] > ramp.thresholds, axis=-1)
    return ramp.y_table[n].astype(x.dtype)


# ---------------------------------------------------------------------------
# PWM input quantization (inputs are b_in-bit pulse widths on the chip)
# ---------------------------------------------------------------------------

def pwm_constants(bits: int, x_max: float):
    """``(step, 1/step)`` of the b-bit PWM grid, both float32: the step
    ``f32(2 x_max / max(2^b - 2, 1))`` and its reciprocal computed in
    float32 from it, as XLA folds the constant (``14.999999`` for 5 bits
    at ``x_max`` 1)."""
    step = np.float32(2.0 * x_max / max((1 << bits) - 2, 1))
    return step, np.float32(1.0) / step


class _PWMFunction(torch.autograd.Function):
    """Forward: :func:`pwm_forward`; backward: ``ct`` where
    ``-x_max <= x <= x_max``, else 0 (the reference's clipped
    straight-through pass)."""

    @staticmethod
    def forward(ctx, x, bits, x_max):
        ctx.x_max = x_max
        ctx.save_for_backward(x)
        return pwm_forward(x, bits, x_max)

    @staticmethod
    def backward(ctx, ct):
        (x,) = ctx.saved_tensors
        inside = (x >= -ctx.x_max) & (x <= ctx.x_max)
        return torch.where(inside, ct, torch.zeros_like(ct)), None, None


def pwm_quantize(x: torch.Tensor, bits: int, x_max: float) -> torch.Tensor:
    """:func:`pwm_forward` with the clipped straight-through gradient.  The
    path follows ``x.requires_grad`` under grad mode: without it the
    forward runs alone, as in :func:`nladc_apply`."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _PWMFunction.apply(x, bits, x_max)
    return pwm_forward(x, bits, x_max)


def pwm_forward(x: torch.Tensor, bits: int, x_max: float) -> torch.Tensor:
    """Uniform b-bit quantization of inputs in [-x_max, x_max].

    2^b - 1 symmetric levels including 0; the step puts +/-x_max on codes.
    Computes ``round(clamp(x, -x_max, x_max) * r) * step`` with ``r`` the
    float32 reciprocal of the float32 step (:func:`pwm_constants`): the
    reference divides by the step, and under ``jax.jit`` (how its LSTMs
    run) XLA compiles that division by a constant into this
    multiplication.  Eager JAX divides, and differs from the jitted
    reference by one step at some inputs next to a half-step.  ``r`` and
    ``step`` are tensors on x's device, so no kernel refolds them from a
    Python scalar.  ``torch.round`` rounds half to even, as the reference
    does.
    """
    step, recip = pwm_constants(bits, x_max)
    r = torch.tensor(recip, dtype=x.dtype, device=x.device)
    s = torch.tensor(step, dtype=x.dtype, device=x.device)
    return torch.round(torch.clamp(x, -x_max, x_max) * r) * s
