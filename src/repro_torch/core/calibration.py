"""Programming-error simulation, one-point calibration and redundancy.

Implements the paper's accuracy machinery around the NL-ADC:

* :func:`program_ramp`       — iterative-write-and-verify outcome model:
                               per-device Gaussian write noise (σ=2.67 µS
                               measured, Fig. S8c) + stuck-at-OFF faults.
* :func:`one_point_calibrate`— Supp. S9: shift ``V_init`` with N_cali bias
                               memristors so the programmed ramp crosses the
                               ideal ramp at the activation's zero point.
* :func:`program_with_redundancy` — Supp. S11: program R copies in unused
                               cells of the ramp column, keep the min-INL one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.nladc import (G_MAX_US, Ramp, inl_lsb,
                                   ramp_from_conductances)

WRITE_SIGMA_US = 2.67   # measured programming error (Fig. S8c)
READ_SIGMA_US = 3.5     # measured read noise (Fig. S14b)
TRAIN_SIGMA_US = 5.0    # (larger) noise injected during training (Methods)


@dataclasses.dataclass(frozen=True)
class ProgrammedRamp:
    """Result of programming a ramp column on the (simulated) chip."""

    ideal: Ramp
    programmed: Ramp
    conductances_us: np.ndarray      # per-step devices actually programmed
    calibrated: bool
    n_cali_devices: int              # bias/calibration memristors used

    def inl(self) -> Tuple[float, float]:
        return inl_lsb(self.programmed, self.ideal)


def write_noise(rng: np.random.Generator, g_us: np.ndarray,
                sigma_us: float = WRITE_SIGMA_US,
                stuck_off_prob: float = 0.0) -> np.ndarray:
    """Apply write noise + optional stuck-at-OFF faults; clip to [0, G_max]."""
    noisy = g_us + rng.normal(0.0, sigma_us, size=g_us.shape)
    if stuck_off_prob > 0.0:
        stuck = rng.random(g_us.shape) < stuck_off_prob
        noisy = np.where(stuck, 0.0, noisy)
    return np.clip(noisy, 0.0, G_MAX_US)


def program_ramp(ramp: Ramp, rng: np.random.Generator,
                 sigma_us: float = WRITE_SIGMA_US,
                 stuck_off_prob: float = 0.0,
                 calibrate: bool = True,
                 rebuild=None) -> ProgrammedRamp:
    """Program one NL-ADC column and (optionally) one-point calibrate it.

    ``rebuild``: optional ``(ideal, g_us) -> Ramp`` hook realizing the
    thresholds from the programmed conductances — the default is the plain
    :func:`ramp_from_conductances` cumsum; a device model with a
    LineResistance stage passes its IR-drop-aware rebuild here so the
    calibration shift (and any redundancy INL selection) judges the
    thresholds the *wires* deliver, not the ideal-network ones.
    """
    if rebuild is None:
        rebuild = ramp_from_conductances
    g_ideal = ramp.conductances_us()
    g_prog = write_noise(rng, g_ideal, sigma_us, stuck_off_prob)
    programmed = rebuild(ramp, g_prog)
    n_cali = 0
    if calibrate:
        programmed, n_cali = one_point_calibrate(
            programmed, ramp, rng, sigma_us=sigma_us
        )
    return ProgrammedRamp(
        ideal=ramp,
        programmed=programmed,
        conductances_us=g_prog,
        calibrated=calibrate,
        n_cali_devices=n_cali,
    )


def _zero_point_index(ideal: Ramp) -> int:
    """Index m s.t. V_m ≈ 0 — where g^{-1} crosses the x-axis zero.

    For activations whose domain does not include 0 in the ramp span, the
    mid-code is used (equivalent to centering the calibration point).
    """
    v = ideal.thresholds
    if v[0] <= 0.0 <= v[-1]:
        return int(np.argmin(np.abs(v)))
    return int(len(v) // 2)


def one_point_calibrate(programmed: Ramp, ideal: Ramp,
                        rng: Optional[np.random.Generator] = None,
                        sigma_us: float = WRITE_SIGMA_US) -> Tuple[Ramp, int]:
    """Supp. S9 one-point calibration.

    Shifts the programmed ramp (by re-programming the bias memristors that
    create ``V_init``) so it intersects the ideal ramp at the zero-crossing
    code m.  The shift itself is realized with ``N_cali`` devices —
    ``N_cali - 1`` at G_max plus a remainder device — each of which also
    suffers write noise if ``rng`` is given (faithful to hardware).
    """
    m = _zero_point_index(ideal)
    target_shift = ideal.thresholds[m] - programmed.thresholds[m]
    # Represent |shift| in conductance units of the bias column.
    g_equiv = abs(target_shift) / max(programmed.g_scale, 1e-30)
    n_full = int(g_equiv // G_MAX_US)
    rem = g_equiv - n_full * G_MAX_US
    devices = [G_MAX_US] * n_full + [rem]
    if rng is not None:
        devices = [
            float(write_noise(rng, np.asarray([d]), sigma_us)[0]) for d in devices
        ]
    realized = sum(devices) * programmed.g_scale * np.sign(target_shift)
    calibrated = programmed.with_thresholds(programmed.thresholds + realized)
    return calibrated, len(devices)


def one_point_calibrate_bank(programmed, ideal: Ramp,
                             rng: Optional[np.random.Generator] = None,
                             sigma_us: float = WRITE_SIGMA_US):
    """Supp. S9 calibration applied per col-tile bank.

    Every member of a ``(n_col_tiles, P)`` threshold bank is a physically
    separate ramp column with its own bias memristors, so each gets its own
    one-point ``V_init`` shift against the shared ideal ramp.  Returns
    ``(calibrated_ramps, total_cali_devices)``.
    """
    out, n_total = [], 0
    for prog in programmed:
        cal, n = one_point_calibrate(prog, ideal, rng, sigma_us=sigma_us)
        out.append(cal)
        n_total += n
    return tuple(out), n_total


def program_with_redundancy(ramp: Ramp, rng: np.random.Generator,
                            copies: int = 4,
                            sigma_us: float = WRITE_SIGMA_US,
                            stuck_off_prob: float = 0.0,
                            calibrate: bool = True,
                            rebuild=None) -> ProgrammedRamp:
    """Supp. S11: program ``copies`` redundant ramps, return the min-INL one.

    The physical column has 64+ rows while a 5-bit ramp needs 32 — unused
    devices hold redundant copies; a 6-bit base-address register selects the
    winner at zero steady-state cost.
    """
    if copies < 1:
        raise ValueError("copies must be >= 1")
    best: Optional[ProgrammedRamp] = None
    best_inl = np.inf
    for _ in range(copies):
        cand = program_ramp(
            ramp, rng, sigma_us=sigma_us, stuck_off_prob=stuck_off_prob,
            calibrate=calibrate, rebuild=rebuild,
        )
        mean_inl, _ = cand.inl()
        if mean_inl < best_inl:
            best, best_inl = cand, mean_inl
    assert best is not None
    return best
