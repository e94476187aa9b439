"""Memristive crossbar model: conductance mapping, read noise, drift.

The paper's Methods: weights clip to [-2, 2] and map linearly to
conductance, ``g = gamma*w`` with ``gamma = g_max/|w|_max = 75 uS``
(Eqs. 6-7).  Noise is injected in *weight units* (sigma/gamma), since the
gamma scaling cancels in the differential read.

Per-step noise comes from a :class:`NoiseSource`: :class:`GeneratorNoise`
draws from a ``torch.Generator`` on the tensor's device;
:class:`ReplayNoise` hands back given draws in call order, so a test can
feed the port the reference's own random numbers.

The wire-resistance (IR drop) and nonlinear I-V models are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

G_MAX_US = 150.0
W_CLIP = 2.0
GAMMA_US = G_MAX_US / W_CLIP  # 75 uS per weight unit (Eq. 7)

READ_SIGMA_W = 3.5 / GAMMA_US     # read noise in weight units


def clip_weights(w: torch.Tensor) -> torch.Tensor:
    """Eq. (6): clip to [-2, 2] (max programmable conductance).

    Where a gradient is asked for, ``minimum(maximum(w, -2), 2)``, as
    ``jnp.clip`` computes it, so the gradient is the reference's: 1 inside,
    0 outside and 0.5 at exactly +-2.0 (a tie of ``maximum`` or ``minimum``
    splits the gradient; ``torch.clamp`` would pass 1 there).  The path
    follows ``w.requires_grad`` under grad mode: without it
    ``torch.clamp``, the same values in one kernel instead of two (the
    infer step's launches, ``PERF.md`` §6)."""
    if not (torch.is_grad_enabled() and w.requires_grad):
        return torch.clamp(w, -W_CLIP, W_CLIP)
    lo, hi = _clip_bounds(w.dtype, w.device)
    return torch.minimum(torch.maximum(w, lo), hi)


@functools.lru_cache(maxsize=None)
def _clip_bounds(dtype, device):
    return (torch.full((), -W_CLIP, dtype=dtype, device=device),
            torch.full((), W_CLIP, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Step-time noise draws
# ---------------------------------------------------------------------------

class NoiseSource:
    """Where the per-step standard-normal draws come from."""

    def normal(self, shape: Sequence[int], device) -> torch.Tensor:
        """A float32 tensor of N(0, 1) draws of ``shape`` on ``device``."""
        raise NotImplementedError


class GeneratorNoise(NoiseSource):
    """Draws from a ``torch.Generator`` that lives on the target device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape, device) -> torch.Tensor:
        if torch.device(device).type != self.generator.device.type:
            raise ValueError(
                f"generator on {self.generator.device} cannot draw for "
                f"{device}")
        return torch.randn(tuple(shape), generator=self.generator,
                           device=device, dtype=torch.float32)


class ReplayNoise(NoiseSource):
    """Hands back the given draws, one per call, in order."""

    def __init__(self, draws):
        self._draws = list(draws)
        self._next = 0

    @property
    def remaining(self) -> int:
        return len(self._draws) - self._next

    def normal(self, shape, device) -> torch.Tensor:
        if self._next >= len(self._draws):
            raise IndexError(f"replay exhausted after {self._next} draws")
        z = self._draws[self._next]
        if not isinstance(z, torch.Tensor):
            z = torch.from_numpy(np.array(z, dtype=np.float32))
        if tuple(z.shape) != tuple(shape):
            raise ValueError(f"replayed draw {self._next} has shape "
                             f"{tuple(z.shape)}, expected {tuple(shape)}")
        self._next += 1
        return z.to(device=device, dtype=torch.float32)


def read_noise_weights(noise: NoiseSource, shape, device,
                       sigma_w: float = READ_SIGMA_W) -> torch.Tensor:
    """Per-read conductance fluctuation in weight units (fresh each call)."""
    return sigma_w * noise.normal(shape, device)


# ---------------------------------------------------------------------------
# Long-term drift (Supp. S13)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DriftModel:
    """Reference-curve drift model (Supp. S13, Eq. S8).

    The measured curves are not published numerically; a log-time
    relaxation toward the mid-range reproduces the reported *shape* (low-G
    states drift up, high-G states sag, sigma grows ~log t).
    """

    n_refs: int = 16
    g_max_us: float = G_MAX_US
    alpha: float = 0.015        # fractional relaxation per decade
    sigma0_us: float = 0.5      # dispersion growth per decade
    t0_s: float = 60.0          # first measurement time

    def ref_levels(self) -> np.ndarray:
        return np.linspace(0.0, self.g_max_us, self.n_refs)

    def ref_curves(self, t_s: float) -> np.ndarray:
        """Mean conductance of each reference level at time t."""
        g0 = self.ref_levels()
        decades = max(0.0, math.log10(max(t_s, self.t0_s) / self.t0_s))
        g_mid = 0.5 * self.g_max_us
        return g0 + self.alpha * decades * (g_mid - g0)

    def drift(self, g_us: np.ndarray, t_s: float,
              rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Eq. (S8): weighted average of the two nearest drifted references."""
        g_us = np.asarray(g_us, dtype=np.float64)
        refs0 = self.ref_levels()
        refs_t = self.ref_curves(t_s)
        idx = np.clip(
            np.searchsorted(refs0, g_us, side="right") - 1, 0, self.n_refs - 2
        )
        lo0, hi0 = refs0[idx], refs0[idx + 1]
        b = (g_us - lo0) / np.maximum(hi0 - lo0, 1e-12)
        a = 1.0 - b
        drifted = a * refs_t[idx] + b * refs_t[idx + 1]
        # Top bin: at or above the highest reference level both nearest
        # curves are the top one, so the device follows it exactly.
        drifted = np.where(g_us >= refs0[-1], refs_t[-1], drifted)
        if rng is not None:
            decades = max(0.0, math.log10(max(t_s, self.t0_s) / self.t0_s))
            drifted = drifted + rng.normal(
                0.0, self.sigma0_us * decades, size=drifted.shape
            )
        return np.clip(drifted, 0.0, self.g_max_us)
