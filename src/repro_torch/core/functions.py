"""Activation function registry for NL-ADC ramp construction.

The paper (Supp. Tab. S1) builds a nonlinear ramp ADC whose ramp waveform follows
``g^{-1}`` — the inverse of the desired activation ``g``.  Every function here
therefore carries three callables:

  * ``fwd(x)``    — the activation itself, ``g``
  * ``inv(y)``    — its inverse, ``g^{-1}`` (the ramp shape, Eq. 2)
  * ``grad(x)``   — ``g'`` used by the straight-through estimator in training

Monotonic functions (sigmoid, tanh, softplus, softsign, elu, selu) invert
directly.  Non-monotonic ones (gelu, swish — Supp. Note S12) are handled by
the extremum-split machinery in :mod:`repro_torch.core.nladc` and expose the
extremum location instead of a global inverse.

All registry math is done with numpy in float64: ramps are *host-side
precomputed tables* (they correspond to physically programmed memristor
conductances, not device computation).  The torch quantizer consumes the
resulting level tables.  :func:`grad_tensor` re-expresses each ``g'`` on
tensors, in the tensor's dtype and on its device, for the straight-through
backward (:func:`repro_torch.core.nladc.nladc_ste`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

ArrayFn = Callable[[np.ndarray], np.ndarray]

_SELU_ALPHA = 2.0  # the paper's simplified selu: 0.5x (x>=0), 2(e^x - 1) (x<0)
_SELU_SLOPE = 0.5


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    """A nonlinear activation with the pieces the NL-ADC needs."""

    name: str
    fwd: ArrayFn
    grad: ArrayFn
    # Inverse of the activation on its monotonic domain. ``None`` for
    # non-monotonic functions (use branch inverses below).
    inv: Optional[ArrayFn]
    # Domain clip: inputs outside [x_lo, x_hi] saturate. These bound the ramp.
    x_lo: float
    x_hi: float
    monotonic: bool = True
    # --- non-monotonic support (Supp. S12) ---
    # Location / value of the single interior extremum (minimum for gelu/swish).
    x_extremum: Optional[float] = None
    # Branch inverses: y -> x on the left (decreasing) / right (increasing)
    # branches around the extremum.
    inv_left: Optional[ArrayFn] = None
    inv_right: Optional[ArrayFn] = None

    @property
    def y_lo(self) -> float:
        if self.monotonic:
            return float(self.fwd(np.asarray(self.x_lo, dtype=np.float64)))
        return float(self.fwd(np.asarray(self.x_extremum, dtype=np.float64)))

    @property
    def y_hi(self) -> float:
        return float(self.fwd(np.asarray(self.x_hi, dtype=np.float64)))


# ---------------------------------------------------------------------------
# Numerically careful primitives (float64 numpy).
# ---------------------------------------------------------------------------

def _sigmoid(x):
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def _sigmoid_grad(x):
    s = _sigmoid(x)
    return s * (1.0 - s)


def _logit(y):
    y = np.asarray(y, dtype=np.float64)
    return np.log(y) - np.log1p(-y)


def _tanh(x):
    return np.tanh(np.asarray(x, dtype=np.float64))


def _tanh_grad(x):
    t = np.tanh(np.asarray(x, dtype=np.float64))
    return 1.0 - t * t


def _atanh(y):
    return np.arctanh(np.asarray(y, dtype=np.float64))


def _softplus(x):
    x = np.asarray(x, dtype=np.float64)
    return np.logaddexp(0.0, x)


def _softplus_inv(y):
    # x = ln(e^y - 1); stable via y + log1p(-exp(-y))
    y = np.asarray(y, dtype=np.float64)
    return y + np.log(-np.expm1(-y))


def _softsign(x):
    x = np.asarray(x, dtype=np.float64)
    return x / (1.0 + np.abs(x))


def _softsign_grad(x):
    x = np.asarray(x, dtype=np.float64)
    return 1.0 / (1.0 + np.abs(x)) ** 2


def _softsign_inv(y):
    y = np.asarray(y, dtype=np.float64)
    return y / (1.0 - np.abs(y))


def _elu(x):
    x = np.asarray(x, dtype=np.float64)
    return np.where(x >= 0, x, np.expm1(x))


def _elu_grad(x):
    x = np.asarray(x, dtype=np.float64)
    return np.where(x >= 0, 1.0, np.exp(x))


def _elu_inv(y):
    y = np.asarray(y, dtype=np.float64)
    return np.where(y >= 0, y, np.log1p(y))


def _selu(x):
    # Paper's piecewise form (Tab. S1): 0.5x (x>=0), 2(e^x - 1) (x<0).
    x = np.asarray(x, dtype=np.float64)
    return np.where(x >= 0, _SELU_SLOPE * x, _SELU_ALPHA * np.expm1(x))


def _selu_grad(x):
    x = np.asarray(x, dtype=np.float64)
    return np.where(x >= 0, _SELU_SLOPE, _SELU_ALPHA * np.exp(x))


def _selu_inv(y):
    y = np.asarray(y, dtype=np.float64)
    return np.where(y >= 0, y / _SELU_SLOPE, np.log1p(y / _SELU_ALPHA))


_SQRT_2 = math.sqrt(2.0)
_SQRT_2_PI = math.sqrt(2.0 / math.pi)


def _norm_cdf(x):
    from scipy.special import erf  # pragma: no cover - scipy optional

    return 0.5 * (1.0 + erf(x / _SQRT_2))


def _phi(x):
    x = np.asarray(x, dtype=np.float64)
    return np.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def _gelu(x):
    # Exact (erf) form via vectorized math.erf fallback if scipy is absent.
    x = np.asarray(x, dtype=np.float64)
    try:
        cdf = _norm_cdf(x)
    except ImportError:
        erf_v = np.vectorize(math.erf)
        cdf = 0.5 * (1.0 + erf_v(x / _SQRT_2))
    return x * cdf


def _gelu_grad(x):
    x = np.asarray(x, dtype=np.float64)
    try:
        cdf = _norm_cdf(x)
    except ImportError:
        erf_v = np.vectorize(math.erf)
        cdf = 0.5 * (1.0 + erf_v(x / _SQRT_2))
    return cdf + x * _phi(x)


def _swish(x):
    x = np.asarray(x, dtype=np.float64)
    return x * _sigmoid(x)


def _swish_grad(x):
    x = np.asarray(x, dtype=np.float64)
    s = _sigmoid(x)
    return s + x * s * (1.0 - s)


def _bisect_inv(f: ArrayFn, lo: float, hi: float) -> ArrayFn:
    """Monotone branch inverse via bisection (host-side, float64)."""

    def inv(y):
        y = np.asarray(y, dtype=np.float64)
        a = np.full_like(y, lo)
        b = np.full_like(y, hi)
        increasing = f(np.asarray(hi)) >= f(np.asarray(lo))
        for _ in range(80):  # ~2^-80 interval: well beyond float64
            mid = 0.5 * (a + b)
            fm = f(mid)
            if increasing:
                take_left = fm >= y
            else:
                take_left = fm <= y
            b = np.where(take_left, mid, b)
            a = np.where(take_left, a, mid)
        return 0.5 * (a + b)

    return inv


def _find_minimum(f: ArrayFn, grad: ArrayFn, lo: float, hi: float) -> float:
    """Locate the interior minimum of f on [lo, hi] by bisection on grad."""
    a, b = lo, hi
    for _ in range(200):
        mid = 0.5 * (a + b)
        if float(grad(np.asarray(mid))) < 0:
            a = mid
        else:
            b = mid
    return 0.5 * (a + b)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_GELU_XMIN = _find_minimum(_gelu, _gelu_grad, -3.0, 0.0)
_SWISH_XMIN = _find_minimum(_swish, _swish_grad, -4.0, 0.0)

REGISTRY: Dict[str, ActivationSpec] = {}


def _register(spec: ActivationSpec) -> ActivationSpec:
    REGISTRY[spec.name] = spec
    return spec


SIGMOID = _register(
    ActivationSpec(
        # domain chosen so sum|dV_k| = 6.992 as in Supp. Tab. S2
        "sigmoid", _sigmoid, _sigmoid_grad, _logit, x_lo=-3.496, x_hi=3.496
    )
)
TANH = _register(
    ActivationSpec(
        # sum|dV_k| = 3.498 (Tab. S2)
        "tanh", _tanh, _tanh_grad, _atanh, x_lo=-1.749, x_hi=1.749
    )
)
SOFTPLUS = _register(
    ActivationSpec(
        # Tab. S2: first step 0.728, last 0.077, sum 4.813 (solved domain)
        "softplus", _softplus, _sigmoid, _softplus_inv,
        x_lo=-2.634, x_hi=2.179
    )
)
SOFTSIGN = _register(
    ActivationSpec(
        # sum|dV_k| = 8.0, first step 1.0 (Tab. S2)
        "softsign", _softsign, _softsign_grad, _softsign_inv, x_lo=-4.0, x_hi=4.0
    )
)
ELU = _register(
    ActivationSpec(
        # Tab. S2 exact: y0 = -15/16, LSB = 3/16 -> x_hi = -15/16 + 32*3/16
        # = 5.0625; the zero-crossing lands exactly on code 5, first step
        # ln(0.25/0.0625) = 1.3863, tail 0.1875.
        "elu", _elu, _elu_grad, _elu_inv,
        x_lo=float(__import__("math").log(1/16)), x_hi=5.0625
    )
)
SELU = _register(
    ActivationSpec(
        # paper reuses the elu sampling grid (Tab. S2 lists identical steps;
        # see the selu special-case in nladc.build_ramp)
        "selu", _selu, _selu_grad, _selu_inv,
        x_lo=float(__import__("math").log(1/16)), x_hi=5.0625
    )
)
GELU = _register(
    ActivationSpec(
        "gelu",
        _gelu,
        _gelu_grad,
        inv=None,
        x_lo=-4.0,
        x_hi=4.0,
        monotonic=False,
        x_extremum=_GELU_XMIN,
        inv_left=_bisect_inv(_gelu, -4.0, _GELU_XMIN),
        inv_right=_bisect_inv(_gelu, _GELU_XMIN, 4.0),
    )
)
SWISH = _register(
    ActivationSpec(
        "swish",
        _swish,
        _swish_grad,
        inv=None,
        x_lo=-6.0,
        x_hi=6.0,
        monotonic=False,
        x_extremum=_SWISH_XMIN,
        inv_left=_bisect_inv(_swish, -6.0, _SWISH_XMIN),
        inv_right=_bisect_inv(_swish, _SWISH_XMIN, 6.0),
    )
)
# silu is an alias for swish (the SwiGLU gate nonlinearity in the LM configs).
REGISTRY["silu"] = dataclasses.replace(SWISH, name="silu")


def get(name: str) -> ActivationSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown activation {name!r}; known: {sorted(REGISTRY)}"
        ) from None


MONOTONIC_NAMES = tuple(
    sorted(n for n, s in REGISTRY.items() if s.monotonic)
)
NON_MONOTONIC_NAMES = tuple(
    sorted(n for n, s in REGISTRY.items() if not s.monotonic)
)


def grad_tensor(name: str, x: torch.Tensor) -> torch.Tensor:
    """``g'(x)`` of the registered activation ``name`` on a tensor, in x's
    dtype: the formulas of the JAX package's ``nladc._jnp_grad`` (the
    numpy ``grad`` callables above are host-only float64)."""
    if name == "sigmoid":
        s = torch.sigmoid(x)
        return s * (1 - s)
    if name == "tanh":
        t = torch.tanh(x)
        return 1 - t * t
    if name == "softplus":
        return torch.sigmoid(x)
    if name == "softsign":
        return 1.0 / torch.square(1.0 + torch.abs(x))
    if name == "elu":
        return torch.where(x >= 0, torch.ones_like(x), torch.exp(x))
    if name == "selu":
        return torch.where(x >= 0, torch.full_like(x, _SELU_SLOPE),
                           _SELU_ALPHA * torch.exp(x))
    if name == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(x / _SQRT_2))
        pdf = torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
        return cdf + x * pdf
    if name in ("swish", "silu"):
        s = torch.sigmoid(x)
        return s + x * s * (1 - s)
    raise KeyError(f"unknown activation {name!r}; known: {sorted(REGISTRY)}")


def ste_tensor(name: str, x: torch.Tensor, ct: torch.Tensor,
               domain) -> torch.Tensor:
    """The straight-through backward of the ramp ``name``: ``ct * g'(x)``
    where ``lo <= x <= hi`` (``domain = (lo, hi)``, inclusive, compared in
    x's dtype), else 0, so saturated inputs pass nothing."""
    lo, hi = domain
    g = grad_tensor(name, x)
    in_domain = (x >= lo) & (x <= hi)
    return ct * torch.where(in_domain, g, torch.zeros_like(g)).to(ct.dtype)
