"""Memristive crossbar model: conductance mapping, noise, IR drop,
nonlinear I-V, drift and tiling.

The paper's Methods: weights clip to [-2, 2] and map linearly to
conductance, ``g = gamma*w`` with ``gamma = g_max/|w|_max = 75 uS``
(Eqs. 6-7), one differential pair of devices per weight (Fig. S9):
``G+ = gamma*max(w, 0)``, ``G- = gamma*max(-w, 0)``.  Noise is injected in
*weight units* (sigma/gamma), since the gamma scaling cancels in the
differential read; the paired form draws per device and clips each
device to [0, G_max].

Per-step noise comes from a :class:`NoiseSource`: :class:`GeneratorNoise`
draws from a ``torch.Generator`` on the tensor's device;
:class:`ReplayNoise` hands back given draws in call order, so a test can
feed the port the reference's own random numbers.

The circuit-level corrections are plain torch on the weights' device and
differentiable through autograd: :func:`ir_effective_weights_tiled` (the
wordline/bitline IR drop, per physical crossbar tile, every group of
equal-shape tiles as one batched tensor) and :func:`nonlinear_iv_read`
(the I-V distortion, a per-input transform).  Host-side build-stage
helpers (pair mappings, per-device write noise, the ramp columns' series
attenuation, drift) are numpy float64.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import fma_f32

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
# Differential pairs and per-device noise
# ---------------------------------------------------------------------------

def weights_to_conductance_pairs(w: np.ndarray) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Differential mapping (Fig. S9): one weight -> (G+, G-) in µS."""
    w = np.clip(np.asarray(w, dtype=np.float64), -W_CLIP, W_CLIP)
    g_pos = GAMMA_US * np.maximum(w, 0.0)
    g_neg = GAMMA_US * np.maximum(-w, 0.0)
    return g_pos, g_neg


def conductance_pairs_to_weights(g_pos: np.ndarray,
                                 g_neg: np.ndarray) -> np.ndarray:
    return (np.asarray(g_pos) - np.asarray(g_neg)) / GAMMA_US


def write_noise_pairs_np(rng: np.random.Generator, g_pos_us: np.ndarray,
                         g_neg_us: np.ndarray, sigma_us: float):
    """Host-side per-device write noise (the build stage's twin of
    :func:`noise_conductance_pairs`): the positive device's draws, then
    the negative's, each device clipped to [0, G_max]."""
    g_pos = g_pos_us + rng.normal(0.0, sigma_us, size=np.shape(g_pos_us))
    g_neg = g_neg_us + rng.normal(0.0, sigma_us, size=np.shape(g_neg_us))
    return (np.clip(g_pos, 0.0, G_MAX_US), np.clip(g_neg, 0.0, G_MAX_US))


def _weights_to_pairs(w: torch.Tensor):
    """``(G+, G-)`` in µS of the clipped weights; ``torch.maximum`` splits
    the gradient at w = 0 between the devices, as ``jnp.maximum`` does."""
    w = clip_weights(w)
    zero = w.new_zeros(())
    return GAMMA_US * torch.maximum(w, zero), GAMMA_US * torch.maximum(
        -w, zero)


def noise_conductance_pairs(noise: NoiseSource, g_pos_us: torch.Tensor,
                            g_neg_us: torch.Tensor, sigma_us: float):
    """Independent N(0, sigma_us) per device, each clipped to [0, G_max]:
    the positive device's draw first, then the negative's (the order of
    the reference's ``split`` of one key)."""
    z_p = noise.normal(g_pos_us.shape, g_pos_us.device)
    z_n = noise.normal(g_neg_us.shape, g_neg_us.device)
    g_pos = torch.clamp(g_pos_us + sigma_us * z_p, 0.0, G_MAX_US)
    g_neg = torch.clamp(g_neg_us + sigma_us * z_n, 0.0, G_MAX_US)
    return g_pos, g_neg


def read_noise_weights_paired(noise: NoiseSource, w: torch.Tensor,
                              sigma_w: float = READ_SIGMA_W) -> torch.Tensor:
    """Per-device read fluctuation: the *noisy weight*, not an additive
    delta (the per-device g >= 0 clip makes it depend on the programmed
    conductances)."""
    g_pos, g_neg = _weights_to_pairs(w)
    g_pos, g_neg = noise_conductance_pairs(noise, g_pos, g_neg,
                                           sigma_w * GAMMA_US)
    return ((g_pos - g_neg) / GAMMA_US).to(w.dtype)


# ---------------------------------------------------------------------------
# Line resistance (IR drop): closed-form first-order kernel + fixed point
# ---------------------------------------------------------------------------
#
# Wordline i (n_cols cells) is driven from the left (``"single"``) or from
# both ends (``"double"``), with ``r_wl_ohm`` per segment; bitline j
# (n_rows cells) is sensed by a virtual-ground TIA below the last row, with
# ``r_bl_ohm`` per segment.  To first order in r*G the relative current
# loss of cell (i, j) is a kernel sum over its row and its column:
#
#   d_wl[i,j] = r_wl * sum_j' g[i,j'] * K_wl(j, j')
#   d_bl[i,j] = r_bl * sum_i' g[i',j] * (n_rows - max(i, i'))
#
# with K_wl(j,j') = min(j,j')+1 (single) or (min+1)*(n_cols-max)/(n_cols+1)
# (double).  Both sums reduce to prefix sums.  ``line_attenuation`` turns
# the drop into s = 1/(1+d) and re-evaluates it on the attenuated
# conductances ``n_iter`` times.  The double-sourcing kernel depends on
# n_cols and the bitline kernel on n_rows, so a partial tile is its own
# shape: it is never padded into a full one.

def line_drop(g_us: torch.Tensor, r_wl_ohm: float, r_bl_ohm: float,
              sourcing: str = "single") -> torch.Tensor:
    """First-order relative IR drop ``d[i,j]`` for conductances ``g_us``
    (µS) of shape (..., n_rows, n_cols); dimensionless."""
    g = g_us * 1e-6  # µS -> S; r in ohm => d dimensionless
    n_rows, n_cols = g.shape[-2], g.shape[-1]
    jj = torch.arange(n_cols, dtype=g.dtype, device=g.device)
    ii = torch.arange(n_rows, dtype=g.dtype, device=g.device)
    if sourcing == "single":
        # K = min(j,j')+1:  A_j + (j+1)*(S - P_j), inclusive prefix sums
        p = torch.cumsum(g, dim=-1)
        a = torch.cumsum(g * (jj + 1.0), dim=-1)
        d_wl = r_wl_ohm * (a + (jj + 1.0) * (p[..., -1:] - p))
    elif sourcing == "double":
        # K = (min+1)*(m-max)/(m+1):  ((m-j)*A_j + (j+1)*(Bt - B_j))/(m+1)
        m = float(n_cols)
        a = torch.cumsum(g * (jj + 1.0), dim=-1)
        b = torch.cumsum(g * (m - jj), dim=-1)
        d_wl = r_wl_ohm * ((m - jj) * a + (jj + 1.0) * (b[..., -1:] - b)) \
            / (m + 1.0)
    else:
        raise ValueError(f"unknown sourcing {sourcing!r}")
    # K = n_rows - max(i,i'):  (n-i)*C_i + (T - D_i)
    k_r = (float(n_rows) - ii)[:, None]
    c = torch.cumsum(g, dim=-2)
    d = torch.cumsum(g * k_r, dim=-2)
    d_bl = r_bl_ohm * (k_r * c + (d[..., -1:, :] - d))
    return d_wl + d_bl


def line_attenuation(g_us: torch.Tensor, r_wl_ohm: float, r_bl_ohm: float,
                     sourcing: str = "single",
                     n_iter: int = 2) -> torch.Tensor:
    """Multiplicative attenuation ``s`` with ``g_eff = g*s``,
    ``s = 1/(1+d)``, then ``n_iter`` fixed-point sweeps on the attenuated
    conductances."""
    if r_wl_ohm == 0.0 and r_bl_ohm == 0.0:
        return torch.ones_like(g_us)
    s = 1.0 / (1.0 + line_drop(g_us, r_wl_ohm, r_bl_ohm, sourcing))
    for _ in range(max(0, n_iter)):
        s = 1.0 / (1.0 + line_drop(g_us * s, r_wl_ohm, r_bl_ohm, sourcing))
    return s


def ir_effective_weights(w: torch.Tensor, r_wl_ohm: float, r_bl_ohm: float,
                         sourcing: str = "single",
                         n_iter: int = 2) -> torch.Tensor:
    """IR-drop-corrected effective weights of one crossbar, or of a batch
    of equal-shape crossbars (leading dims).  Each polarity is its own
    physical array: both are stacked into one tensor, attenuated, and
    recombined in weight units.  Identity when r_wl = r_bl = 0."""
    if r_wl_ohm == 0.0 and r_bl_ohm == 0.0:
        return w
    g = torch.stack(_weights_to_pairs(w))
    g = g * line_attenuation(g, r_wl_ohm, r_bl_ohm, sourcing, n_iter)
    return ((g[0] - g[1]) / GAMMA_US).to(w.dtype)


def _bands(n: int, tile: int):
    """``(start, count, size)`` of the full tiles and of the partial one."""
    full, rest = divmod(n, tile)
    return [b for b in ((0, full, tile), (full * tile, 1, rest)) if b[1]
            and b[2]]


def ir_effective_weights_tiled(w: torch.Tensor, r_wl_ohm: float,
                               r_bl_ohm: float, sourcing: str = "single",
                               n_iter: int = 2,
                               plan: Optional["TilePlan"] = None
                               ) -> torch.Tensor:
    """:func:`ir_effective_weights` per *physical* crossbar tile of
    ``plan`` (default: the paper's 633x512 tiling of the last two dims;
    leading dims are independent matrices).

    The tiles of equal shape (at most four groups: full tiles, the partial
    column strip, the partial row strip, the corner) are gathered into one
    batched tensor each and corrected together, so the launches per call
    follow the number of tile shapes, not of tiles.  Bitwise the per-tile
    loop on the CPU.  ``plan`` must cover the matrix exactly."""
    if r_wl_ohm == 0.0 and r_bl_ohm == 0.0:
        return w
    n_in, n_out = w.shape[-2], w.shape[-1]
    p = plan if plan is not None else plan_tiles(n_in, n_out)
    if (p.n_in, p.n_out) != (n_in, n_out):
        raise ValueError(
            f"plan covers ({p.n_in}, {p.n_out}) but the matrix is "
            f"({n_in}, {n_out}); derive the plan from the weight's shape")
    if p.n_crossbars == 1:
        return ir_effective_weights(w, r_wl_ohm, r_bl_ohm, sourcing, n_iter)
    mats = w.reshape((-1, n_in, n_out))
    n_mat = mats.shape[0]
    rows = []
    for r0, nr, hr in _bands(n_in, p.tile_rows):
        band = []
        for c0, nc, wc in _bands(n_out, p.tile_cols):
            tiles = mats[:, r0:r0 + nr * hr, c0:c0 + nc * wc].reshape(
                n_mat, nr, hr, nc, wc).transpose(2, 3).reshape(-1, hr, wc)
            eff = ir_effective_weights(tiles, r_wl_ohm, r_bl_ohm, sourcing,
                                       n_iter)
            band.append(eff.reshape(n_mat, nr, nc, hr, wc).transpose(
                2, 3).reshape(n_mat, nr * hr, nc * wc))
        rows.append(torch.cat(band, dim=-1))
    return torch.cat(rows, dim=-2).reshape(w.shape)


def ramp_series_attenuation(g_us, r_wl_ohm: float, r_bl_ohm: float,
                            wl_segments: float = 0.0) -> np.ndarray:
    """Series-resistance attenuation of a ramp column read one device at a
    time (host-side numpy float64, for rebuilding programmed ramps).

    Device k sees only its series path: ``wl_segments`` segments of r_wl,
    the cell, ``P - k`` segments of r_bl down to the TIA; the divider
    ``g_eff = g / (1 + g*R_series)`` is exact for that single path."""
    g = np.asarray(g_us, dtype=np.float64) * 1e-6
    n = g.shape[-1]
    k = np.arange(n, dtype=np.float64)
    r_series = r_bl_ohm * (n - k) + r_wl_ohm * wl_segments
    return 1.0 / (1.0 + g * r_series)


# ---------------------------------------------------------------------------
# Nonlinear memristor I-V (Kim et al., arXiv 1703.10642)
# ---------------------------------------------------------------------------

def _iv_constants(alpha: float, input_clip: float):
    """``(1/clip, c3/clip, clip/(1+c3))`` folded in float32 as XLA folds
    them under ``jax.jit`` (``c3 = alpha^2/6``)."""
    f32 = np.float32
    r = f32(1.0) / f32(input_clip)
    k1 = f32(f32((alpha * alpha) / 6.0) * r)
    k2 = f32(f32(input_clip) * (f32(1.0) / f32(1.0 + (alpha * alpha) / 6.0)))
    return float(r), float(k1), float(k2)


def _iv_forward(x, r, k1, k2):
    v = x * r
    return (fma_f32((x * k1) * v, v, v) * k2).to(x.dtype)


class _NonlinearIV(torch.autograd.Function):
    """The I-V transform with the derivative of its polynomial,
    ``(1 + 3*c3*v^2) / (1 + c3)``."""

    @staticmethod
    def forward(ctx, x, r, k1, k2):
        ctx.save_for_backward(x)
        ctx.consts = (r, k1, k2)
        return _iv_forward(x, r, k1, k2)

    @staticmethod
    def backward(ctx, ct):
        (x,) = ctx.saved_tensors
        r, k1, k2 = ctx.consts
        slope = (1.0 + 3.0 * (x * k1) * (x * r)) * (k2 * r)
        return ct * slope, None, None, None


def nonlinear_iv_read(x: torch.Tensor, alpha: float,
                      input_clip: float = 1.0) -> torch.Tensor:
    """Polynomial I-V distortion of the MAC read, folded into the inputs.

    ``phi(x) = clip * (v + c3*v^3) / (1 + c3)``, ``v = x/clip``,
    ``c3 = alpha^2/6``: odd, monotone, ``phi(clip) = clip``; identity at
    alpha 0.  Computed as the reference computes it under ``jax.jit``:
    ``fma((x*(c3/clip))*v, v, v) * (clip/(1+c3))`` with ``v = x*(1/clip)``
    and the constants folded in float32 (bitwise on the CPU)."""
    if alpha == 0.0:
        return x
    return _NonlinearIV.apply(x, *_iv_constants(alpha, input_clip))


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

    def drift_weights(self, w: np.ndarray, t_s: float,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Drift in weight space via the differential pair."""
        g_pos, g_neg = weights_to_conductance_pairs(w)
        return conductance_pairs_to_weights(
            self.drift(g_pos, t_s, rng), self.drift(g_neg, t_s, rng)
        )


# ---------------------------------------------------------------------------
# Crossbar tiling (Supp. S10 + the paper's 633x512 partitioning)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How a logical (n_in, n_out) matmul maps onto physical crossbars."""

    n_in: int
    n_out: int
    tile_rows: int            # physical rows per crossbar
    tile_cols: int            # physical columns per crossbar
    max_active_rows: int      # IR-drop limit on simultaneously-enabled rows
    n_row_tiles: int
    n_col_tiles: int
    n_phases: int             # input-presentation phases per row-tile

    @property
    def n_crossbars(self) -> int:
        return self.n_row_tiles * self.n_col_tiles

    def blocks(self):
        """Yield ``((i, j), row_slice, col_slice)`` per physical crossbar,
        clipped to the logical extent (the last tiles may be partial).
        Build-stage draws key their streams off these (i, j)."""
        for i in range(self.n_row_tiles):
            rs = slice(i * self.tile_rows,
                       min((i + 1) * self.tile_rows, self.n_in))
            for j in range(self.n_col_tiles):
                cs = slice(j * self.tile_cols,
                           min((j + 1) * self.tile_cols, self.n_out))
                yield (i, j), rs, cs


def plan_tiles(n_in: int, n_out: int,
               tile_rows: int = 633, tile_cols: int = 512,
               max_active_rows: int = 256) -> TilePlan:
    """Partition a logical matmul onto crossbars (paper: 633x512 tiles,
    3-phase input presentation so that <= 256 rows are enabled at once)."""
    n_row_tiles = math.ceil(n_in / tile_rows)
    n_col_tiles = math.ceil(n_out / tile_cols)
    rows_in_tile = min(n_in, tile_rows)
    n_phases = math.ceil(rows_in_tile / max_active_rows)
    return TilePlan(
        n_in=n_in, n_out=n_out,
        tile_rows=tile_rows, tile_cols=tile_cols,
        max_active_rows=max_active_rows,
        n_row_tiles=n_row_tiles, n_col_tiles=n_col_tiles,
        n_phases=n_phases,
    )
