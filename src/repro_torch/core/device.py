"""``repro_torch.core.device``: one composable device model for every
nonideality, as a serializable tree of stage dataclasses.

========================  =====================================================
stage                     physics
========================  =====================================================
:class:`WriteNoise`       per-device programming error, N(0, 2.67 µS) measured
                          (Fig. S8c); applied ONCE at build/deploy time
:class:`ReadNoise`        per-read conductance fluctuation, N(0, 3.5 µS)
                          (Fig. S14b); fresh every minibatch at step time
:class:`TrainNoise`       Alg. 1 hardware-aware-training noise, N(0, 5 µS)
:class:`Drift`            long-term retention drift over ``t_s`` seconds via
                          the reference-curve model (Supp. S13, Eq. S8)
:class:`StuckAt`          stuck-at-OFF device faults (Fig. 3a)
:class:`Redundancy`       Supp. S11 best-of-R ramp copies in unused column rows
:class:`Calibration`      Supp. S9 one-point ``V_init`` shift with bias devices
:class:`LineResistance`   wordline/bitline IR drop (not ported yet: deploying
                          or running under it raises)
:class:`NonlinearIV`      nonlinear memristor I-V (not ported yet)
========================  =====================================================

The **build stage** (write noise, faults, redundancy, calibration, drift)
realizes the programmed NL-ADC ramps once per deployment, host-side in
numpy: :meth:`DeviceModel.deploy_ramp` / :meth:`DeviceModel.deploy_ramp_bank`.
Its draws are ``numpy.random.Generator`` streams salted with ``zlib.crc32``
of the ramp identity, so the thresholds are the same on every backend and
every run.  The **step-time** sigmas (read / train noise) are read by
:mod:`repro_torch.core.analog_layer`.

Presets are registered by name (``ideal``, ``paper``, ``paper-infer``,
``aged-1day``, ``stressed``, ``paper-ir``, ``stressed-ir``);
:meth:`DeviceModel.to_dict` / :func:`device_from_dict` use plain JSON types
in the same schema as the JAX package's device models.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Any, Dict, Optional, Union

import numpy as np

from repro_torch.core import calibration as CAL
from repro_torch.core import crossbar as CB
from repro_torch.core.calibration import ProgrammedRamp
from repro_torch.core.nladc import Ramp, ramp_from_conductances

# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WriteNoise:
    """Programming error per device (iterative write-and-verify outcome)."""

    sigma_us: float = CAL.WRITE_SIGMA_US      # 2.67 µS measured (Fig. S8c)

    @property
    def sigma_w(self) -> float:
        """Sigma in weight units (the γ scaling cancels differentially)."""
        return self.sigma_us / CB.GAMMA_US


@dataclasses.dataclass(frozen=True)
class ReadNoise:
    """Per-read conductance fluctuation, fresh each minibatch."""

    sigma_us: float = CAL.READ_SIGMA_US       # 3.5 µS measured (Fig. S14b)

    @property
    def sigma_w(self) -> float:
        return self.sigma_us / CB.GAMMA_US


@dataclasses.dataclass(frozen=True)
class TrainNoise:
    """Alg. 1 noise injected during hardware-aware training (weights + ramp)."""

    sigma_us: float = CAL.TRAIN_SIGMA_US      # 5 µS (Methods)

    @property
    def sigma_w(self) -> float:
        return self.sigma_us / CB.GAMMA_US


@dataclasses.dataclass(frozen=True)
class Drift:
    """Retention drift for ``t_s`` seconds (reference-curve model, Eq. S8)."""

    t_s: float = 0.0
    n_refs: int = 16
    alpha: float = 0.015
    sigma0_us: float = 0.5
    t0_s: float = 60.0

    def model(self) -> CB.DriftModel:
        return CB.DriftModel(n_refs=self.n_refs, alpha=self.alpha,
                             sigma0_us=self.sigma0_us, t0_s=self.t0_s)


@dataclasses.dataclass(frozen=True)
class StuckAt:
    """Stuck-at-OFF faults: the affected conductance reads 0 (Fig. 3a)."""

    prob: float = 0.0


@dataclasses.dataclass(frozen=True)
class Redundancy:
    """Supp. S11: program ``n_copies`` ramp replicas, keep the min-INL one."""

    n_copies: int = 1


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Supp. S9: one-point V_init shift realized with bias memristors."""

    one_point: bool = True


@dataclasses.dataclass(frozen=True)
class LineResistance:
    """Wordline/bitline parasitic resistance (IR drop).

    A position-dependent effective-conductance correction of the weight
    crossbars at step time, and the series-resistance attenuation of the
    sequentially-read ramp columns at build time.  Kept here so device
    models serialize in full; neither correction is ported yet.

    ``sourcing``: ``"single"`` drives each wordline from the left only;
    ``"double"`` from both ends (halves the worst-case wordline drop).
    ``n_iter``: fixed-point refinement sweeps of the closed-form correction.
    """

    r_wl_ohm: float = 1.0
    r_bl_ohm: float = 1.0
    sourcing: str = "single"
    n_iter: int = 2


@dataclasses.dataclass(frozen=True)
class NonlinearIV:
    """Nonlinear memristor I-V (Kim et al., arXiv 1703.10642).

    ``alpha = b*V_clip`` of the sinh read characteristic; the gain-
    normalized cubic distortion factors through the MAC as a per-input
    transform (not ported yet).
    """

    alpha: float = 0.5


_STAGE_TYPES = {
    "write": WriteNoise,
    "read": ReadNoise,
    "train": TrainNoise,
    "drift": Drift,
    "stuck": StuckAt,
    "redundancy": Redundancy,
    "calibration": Calibration,
    "line": LineResistance,
    "nonlinear_iv": NonlinearIV,
}


# ---------------------------------------------------------------------------
# The composed model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """A full device model: optional stages composed into one tree.

    ``None`` disables a stage.  The tree is hashable (usable as a frozen
    dataclass field of :class:`repro_torch.core.analog_layer.AnalogConfig`) and
    JSON-serializable via :meth:`to_dict`.
    """

    name: str = "custom"
    write: Optional[WriteNoise] = None
    read: Optional[ReadNoise] = None
    train: Optional[TrainNoise] = None
    drift: Optional[Drift] = None
    stuck: Optional[StuckAt] = None
    redundancy: Redundancy = Redundancy()
    calibration: Calibration = Calibration(one_point=False)
    line: Optional[LineResistance] = None
    nonlinear_iv: Optional[NonlinearIV] = None
    # Draw write/read noise per *device* of the differential pair (two
    # independent draws, per-device [0, G_max] clipping) instead of the
    # legacy one-draw-per-weight model.  Off by default so the pinned
    # S13/preset parities stay bitwise.
    paired_noise: bool = False
    # Per-deployment seed for the build-stage draws (ramp programming)
    # when no explicit rng is supplied.
    seed: int = 0

    def replace(self, **kw) -> "DeviceModel":
        return dataclasses.replace(self, **kw)

    def with_drift(self, t_s: float) -> "DeviceModel":
        """Convenience: same model aged to ``t_s`` seconds."""
        base = self.drift or Drift()
        return self.replace(drift=dataclasses.replace(base, t_s=t_s))

    # -- step-time accessors (consumed by core.analog_layer) -------------

    def weight_sigma_w(self, mode: str) -> float:
        """Weight-units sigma of the per-step weight noise for ``mode``."""
        if mode == "train" and self.train is not None:
            return self.train.sigma_w
        if mode == "infer" and self.read is not None:
            return self.read.sigma_w
        return 0.0

    def ramp_sigma_us(self, mode: str) -> float:
        """Conductance-units sigma of the per-step ramp-step noise."""
        if mode == "train" and self.train is not None:
            return self.train.sigma_us
        return 0.0

    # -- build stage (host-side numpy) ------------------------------------

    @property
    def has_build_stage(self) -> bool:
        """True if deployment realizes any once-per-chip nonideality."""
        return (self.write is not None
                or self.stuck is not None
                or (self.drift is not None and self.drift.t_s > 0)
                or self.line is not None)

    def line_rebuild(self):
        """Threshold-realization hook for the line stage.

        ``None`` (plain ``ramp_from_conductances``) without a line stage.
        The IR-drop-aware ramp rebuild (with its per-bank wordline position
        and bank-aware redundancy placement) is not ported yet, so a model
        with a line stage raises here instead of deploying ideal-wire
        ramps.
        """
        if self.line is None:
            return None
        raise NotImplementedError(
            f"device {self.name!r}: the LineResistance stage (IR drop) is "
            f"not ported to repro_torch yet; ROADMAP.md queue A item 2 "
            f"(the device stages) brings it")

    def _build_rng(self, *salt: int) -> np.random.Generator:
        return np.random.default_rng([self.seed & 0xFFFFFFFF, *salt])

    def program(self, ramp: Ramp,
                rng: Optional[np.random.Generator] = None,
                *, instance: str = "") -> ProgrammedRamp:
        """Program one NL-ADC ramp column under this model.

        Wraps the Supp. S9/S11 pipeline (``program_ramp`` /
        ``program_with_redundancy``) with write noise + stuck faults +
        redundancy + one-point calibration, then applies retention drift to
        the programmed conductances (re-calibrating afterwards, i.e.
        calibrate-at-deployment).  The rng stream matches calling the
        calibration functions directly with the same arguments.

        ``instance`` decorrelates physically distinct copies of the same
        ramp (e.g. the ADC periphery of different crossbar tiles): the
        default empty string reproduces the legacy one-chip-per-(name, bits)
        stream bit-for-bit.
        """
        if rng is None:
            salt = [zlib.crc32(ramp.name.encode()), ramp.bits]
            if instance:
                salt.append(zlib.crc32(instance.encode()))
            rng = self._build_rng(*salt)
        sigma = self.write.sigma_us if self.write is not None else 0.0
        stuck = self.stuck.prob if self.stuck is not None else 0.0
        cal = self.calibration.one_point
        rebuild = self.line_rebuild()
        if self.redundancy.n_copies > 1:
            prog = CAL.program_with_redundancy(
                ramp, rng, copies=self.redundancy.n_copies, sigma_us=sigma,
                stuck_off_prob=stuck, calibrate=cal, rebuild=rebuild)
        else:
            prog = CAL.program_ramp(ramp, rng, sigma_us=sigma,
                                    stuck_off_prob=stuck, calibrate=cal,
                                    rebuild=rebuild)
        if self.drift is not None and self.drift.t_s > 0:
            g = self.drift.model().drift(prog.conductances_us,
                                         self.drift.t_s, rng)
            drifted = (rebuild or ramp_from_conductances)(ramp, g)
            n_cali = prog.n_cali_devices
            if cal:
                drifted, n_cali = CAL.one_point_calibrate(
                    drifted, ramp, rng, sigma_us=sigma)
            prog = ProgrammedRamp(ideal=ramp, programmed=drifted,
                                  conductances_us=g, calibrated=cal,
                                  n_cali_devices=n_cali)
        return prog

    def deploy_ramp(self, ramp: Ramp, *, instance: str = "") -> Ramp:
        """The comparator thresholds a deployed chip actually realizes.

        Identity when the model has no build-stage nonideality; otherwise
        the programmed (noisy/faulty/redundant/calibrated/drifted) ramp,
        drawn deterministically from ``seed`` + the ramp identity (plus the
        optional ``instance`` tile key) so every backend — and every
        re-build of the activation — sees the same chip.
        """
        if not self.has_build_stage:
            return ramp
        return self.program(ramp, instance=instance).programmed

    def deploy_ramp_bank(self, ramp: Ramp, n_banks: int, *,
                         instance: str = ""):
        """One programmed ramp instance per crossbar col-tile.

        The paper's ramp generator is physically per-tile: a matrix wider
        than one crossbar sees ``n_banks`` (its col-tile count)
        independently programmed (and independently drifting) ramps.  Each
        bank's draw is keyed purely by its col-tile index — independent of
        ``n_banks``, of realization order, and of which other banks exist
        (the bank-permutation-independence property).
        """
        prefix = f"{instance}@" if instance else ""
        return tuple(self.deploy_ramp(ramp, instance=f"{prefix}col{j}")
                     for j in range(n_banks))

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON representation (round-trips via device_from_dict)."""
        out: Dict[str, Any] = {"name": self.name, "seed": self.seed,
                               "paired_noise": self.paired_noise}
        for field in _STAGE_TYPES:
            stage = getattr(self, field)
            out[field] = None if stage is None else dataclasses.asdict(stage)
        return out


def device_from_dict(d: Dict[str, Any]) -> DeviceModel:
    """Inverse of :meth:`DeviceModel.to_dict`.

    Tolerates dicts from older schema versions (missing line/nonlinear_iv/
    paired_noise keys default to the legacy behaviour), so pre-existing
    deployment checkpoints keep restoring bitwise.
    """
    kw: Dict[str, Any] = {"name": d.get("name", "custom"),
                          "seed": int(d.get("seed", 0)),
                          "paired_noise": bool(d.get("paired_noise", False))}
    for field, typ in _STAGE_TYPES.items():
        v = d.get(field)
        if v is None:
            # redundancy/calibration are non-optional stages
            if field == "redundancy":
                kw[field] = Redundancy()
            elif field == "calibration":
                kw[field] = Calibration(one_point=False)
            else:
                kw[field] = None
        else:
            kw[field] = typ(**v)
    return DeviceModel(**kw)


# ---------------------------------------------------------------------------
# Preset registry
# ---------------------------------------------------------------------------

DEFAULT_DEVICE = "paper"

_REGISTRY: Dict[str, DeviceModel] = {}


def register_device(model: DeviceModel, name: Optional[str] = None) -> None:
    """Register a named preset (overrides silently, like backends)."""
    _REGISTRY[name or model.name] = model


def get_device(name: str) -> DeviceModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown device model {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def device_names():
    return tuple(sorted(_REGISTRY))


def resolve_device(spec: Union[str, DeviceModel, None] = "") -> DeviceModel:
    """Explicit model or preset name, else ``REPRO_DEVICE`` env, else paper."""
    if isinstance(spec, DeviceModel):
        return spec
    name = spec or os.environ.get("REPRO_DEVICE", "") or DEFAULT_DEVICE
    return get_device(name)


# The software baseline: no nonideality anywhere (quantization — the NL-ADC
# transfer function itself — is AnalogConfig's job, not the device's).
IDEAL = DeviceModel(name="ideal")

# The paper's *step-time* model — exactly the legacy AnalogConfig defaults:
# Alg. 1 training noise (5 µS on weights and ramp steps) and per-minibatch
# read noise (3.5 µS); no build-stage physics simulated in the step.
PAPER = DeviceModel(name="paper", train=TrainNoise(), read=ReadNoise())

# Full deployment simulation: freshly programmed chip (write noise + one-
# point calibration on the NL-ADC ramps / weight crossbars) + read noise.
PAPER_INFER = PAPER.replace(name="paper-infer", write=WriteNoise(),
                            calibration=Calibration(one_point=True))

# The same chip after one day on the shelf (Supp. S13 drift).
AGED_1DAY = PAPER_INFER.with_drift(86_400.0).replace(name="aged-1day")

# Pessimistic corner: double write noise, 2% stuck-at-OFF faults, 2x read
# noise, larger (8 µS) training noise; survives via best-of-4 redundancy +
# calibration (the paper's own mitigation stack, Figs. 3a/S12).
STRESSED = DeviceModel(
    name="stressed",
    write=WriteNoise(sigma_us=2 * CAL.WRITE_SIGMA_US),
    read=ReadNoise(sigma_us=2 * CAL.READ_SIGMA_US),
    train=TrainNoise(sigma_us=8.0),
    stuck=StuckAt(prob=0.02),
    redundancy=Redundancy(n_copies=4),
    calibration=Calibration(one_point=True),
)

# Circuit-level fidelity: the full deployment simulation plus wordline/
# bitline parasitics (1 ohm/segment, single-side sourcing — inside the
# closed-form correction's 1%-validity region at the paper's 633-row tiles'
# active-row cap) and the Kim et al. I-V distortion at a mild alpha.
PAPER_IR = PAPER_INFER.replace(
    name="paper-ir",
    line=LineResistance(r_wl_ohm=1.0, r_bl_ohm=1.0, sourcing="single"),
    nonlinear_iv=NonlinearIV(alpha=0.5),
)

# Pessimistic circuit corner on top of the stressed statistics: 2.5 ohm
# wires rescued by double-side sourcing, strong I-V nonlinearity, and the
# faithful per-device (paired) noise path.  Registered as its own preset —
# `stressed` itself stays untouched so the BENCH_device/bank/fleet pinned
# baselines remain valid.
STRESSED_IR = STRESSED.replace(
    name="stressed-ir",
    line=LineResistance(r_wl_ohm=2.5, r_bl_ohm=2.5, sourcing="double"),
    nonlinear_iv=NonlinearIV(alpha=1.0),
    paired_noise=True,
)

for _m in (IDEAL, PAPER, PAPER_INFER, AGED_1DAY, STRESSED, PAPER_IR,
           STRESSED_IR):
    register_device(_m)
