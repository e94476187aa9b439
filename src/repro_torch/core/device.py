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
:class:`LineResistance`   wordline/bitline IR drop: the weight crossbars'
                          effective-conductance correction at step time,
                          the ramp columns' series attenuation at build time
:class:`NonlinearIV`      nonlinear memristor I-V (a per-input transform)
========================  =====================================================

The **build stage** (write noise, faults, redundancy, calibration, drift,
and the line stage's ramp rebuild) realizes the programmed chip once per
deployment, host-side in numpy float64: the NL-ADC ramps
(:meth:`DeviceModel.deploy_ramp` / :meth:`DeviceModel.deploy_ramp_bank`)
and the weight crossbars (:meth:`DeviceModel.age_weights`,
:meth:`DeviceModel.age_weights_tiled`, :meth:`DeviceModel.age_params`).
Its draws are ``numpy.random.Generator`` streams salted with ``zlib.crc32``
of the ramp identity or of the weight's tree path and tile, so the chip
is the same on every backend and every run, and bitwise the JAX
package's.  The **step-time** stages (read / train noise, paired noise,
the IR correction, the I-V transform) are applied by
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
import torch

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

    The position-dependent effective-conductance correction of
    :func:`repro_torch.core.crossbar.ir_effective_weights_tiled` on the
    weight crossbars (per physical tile, at step time, differentiable) and
    the exact series-resistance attenuation of the sequentially-read ramp
    columns at build time (so calibration and the INL probes see the
    IR-induced curvature).

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
    transform (:func:`repro_torch.core.crossbar.nonlinear_iv_read`).
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
    # Per-deployment seed for the build-stage draws (ramp programming /
    # weight aging) when no explicit rng is supplied.
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

    # -- line-resistance hooks ---------------------------------------------

    def line_rebuild(self, frac: float = 1.0):
        """Threshold-realization hook threading the line stage into ramps.

        ``None`` (plain ``ramp_from_conductances``) without a line stage;
        otherwise ``(ideal, g_us) -> Ramp`` applying the sequential-read
        series attenuation before the prefix-sum rebuild, so calibration,
        redundancy INL selection and drift rebuilds judge the thresholds
        the wires deliver.  ``frac`` is the normalized wordline run from
        the voltage source to the ramp column's bank (1.0 = far end).
        """
        if self.line is None:
            return None
        ln = self.line

        def rebuild(ideal: Ramp, g_us: np.ndarray) -> Ramp:
            g = np.asarray(g_us, dtype=np.float64)
            s = CB.ramp_series_attenuation(
                g, ln.r_wl_ohm, ln.r_bl_ohm,
                wl_segments=frac * g.shape[-1])
            return ramp_from_conductances(ideal, g * s)

        return rebuild

    def bank_line_frac(self, j: int, n_banks: int) -> float:
        """Normalized wordline run to bank ``j``'s ramp column: monotone
        in the distance from the source for single-side sourcing, the
        distance to the nearer source for double-side (worst in the
        middle)."""
        if self.line is None or n_banks <= 1:
            return 1.0
        if self.line.sourcing == "double":
            return 2.0 * min(j + 1, n_banks - j) / (n_banks + 1)
        return (j + 1) / n_banks

    def worst_bank(self, n_banks: int) -> int:
        """The col-tile whose ramp sees the largest IR drop."""
        return max(range(n_banks),
                   key=lambda j: (self.bank_line_frac(j, n_banks), j))

    def bank_device(self, j: int, n_banks: int) -> "DeviceModel":
        """Bank-aware Supp. S11 redundancy placement: under a line stage
        the redundant ramp copies go to the worst col-tile and the other
        banks are programmed single-copy.  Identity without a line stage
        or redundancy, so every other banked deployment stays bitwise."""
        if (self.line is None or n_banks <= 1
                or self.redundancy.n_copies <= 1):
            return self
        if j == self.worst_bank(n_banks):
            return self
        return self.replace(redundancy=Redundancy(n_copies=1))

    def _build_rng(self, *salt: int) -> np.random.Generator:
        return np.random.default_rng([self.seed & 0xFFFFFFFF, *salt])

    def tile_rng(self, key: str, *salt: int) -> np.random.Generator:
        """RNG for one crossbar tile's build-stage draws, seeded by
        ``(seed, crc32(key), *salt)`` (the leaf's tree path and the tile
        coordinates), so a tile's devices do not depend on visit order."""
        return self._build_rng(zlib.crc32(key.encode()), *salt)

    def program(self, ramp: Ramp,
                rng: Optional[np.random.Generator] = None,
                *, instance: str = "",
                line_frac: float = 1.0) -> ProgrammedRamp:
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
        stream bit-for-bit.  ``line_frac`` positions the column along the
        wordline for the line stage's rebuild.
        """
        if rng is None:
            salt = [zlib.crc32(ramp.name.encode()), ramp.bits]
            if instance:
                salt.append(zlib.crc32(instance.encode()))
            rng = self._build_rng(*salt)
        sigma = self.write.sigma_us if self.write is not None else 0.0
        stuck = self.stuck.prob if self.stuck is not None else 0.0
        cal = self.calibration.one_point
        rebuild = self.line_rebuild(line_frac)
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

    def deploy_ramp(self, ramp: Ramp, *, instance: str = "",
                    line_frac: float = 1.0) -> Ramp:
        """The comparator thresholds a deployed chip actually realizes.

        Identity when the model has no build-stage nonideality; otherwise
        the programmed (noisy/faulty/redundant/calibrated/drifted) ramp,
        drawn deterministically from ``seed`` + the ramp identity (plus the
        optional ``instance`` tile key) so every backend — and every
        re-build of the activation — sees the same chip.  ``line_frac``
        positions the column for the IR-drop rebuild (ignored without a
        line stage).
        """
        if not self.has_build_stage:
            return ramp
        return self.program(ramp, instance=instance,
                            line_frac=line_frac).programmed

    def deploy_ramp_bank(self, ramp: Ramp, n_banks: int, *,
                         instance: str = ""):
        """One programmed ramp instance per crossbar col-tile.

        The paper's ramp generator is physically per-tile: a matrix wider
        than one crossbar sees ``n_banks`` (its col-tile count)
        independently programmed (and independently drifting) ramps.  Each
        bank's draw is keyed purely by its col-tile index — independent of
        ``n_banks``, of realization order, and of which other banks exist
        (the bank-permutation-independence property).  Under a line stage
        each bank also gets its wordline position (:meth:`bank_line_frac`)
        and the bank-aware redundancy placement (:meth:`bank_device`).
        """
        prefix = f"{instance}@" if instance else ""
        return tuple(
            self.bank_device(j, n_banks).deploy_ramp(
                ramp, instance=f"{prefix}col{j}",
                line_frac=self.bank_line_frac(j, n_banks))
            for j in range(n_banks))

    # -- weight aging (host-side numpy float64) ------------------------------

    def age_weights(self, w: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        """Build-stage weight nonidealities: write noise (per weight, or per
        device of the pair under ``paired_noise``), stuck-at-OFF faults,
        retention drift, in that order, from ``rng`` (the caller owns the
        stream: device errors are independent across crossbars)."""
        w = np.asarray(w, dtype=np.float64)
        if self.write is not None:
            if self.paired_noise:
                g_pos, g_neg = CB.weights_to_conductance_pairs(w)
                g_pos, g_neg = CB.write_noise_pairs_np(
                    rng, g_pos, g_neg, self.write.sigma_us)
                w = CB.conductance_pairs_to_weights(g_pos, g_neg)
            else:
                w = np.clip(w + rng.normal(0.0, self.write.sigma_w, w.shape),
                            -CB.W_CLIP, CB.W_CLIP)
        if self.stuck is not None and self.stuck.prob > 0:
            w = np.where(rng.random(w.shape) < self.stuck.prob, 0.0, w)
        if self.drift is not None and self.drift.t_s > 0:
            w = self.drift.model().drift_weights(w, self.drift.t_s, rng)
        return w

    def age_weights_tiled(self, w: np.ndarray, key: str,
                          plan: Optional[CB.TilePlan] = None,
                          generation: int = 0,
                          col_overrides: Optional[Dict[int, tuple]] = None
                          ) -> np.ndarray:
        """:meth:`age_weights`, drawn independently per physical crossbar.

        The last two dims are partitioned by ``plan`` (default: the paper's
        633x512 tiling); tile (i, j) of leading matrix ``mi`` draws from
        :meth:`tile_rng` keyed on ``(key, mi, i, j)``, so tiles carry
        independent device populations and the result does not depend on
        visit order.  A nonzero ``generation`` salts every tile (a field
        re-program: fresh write noise); generation 0 is the pre-refresh
        stream.  ``col_overrides`` maps a col-tile ``j`` to ``(generation,
        t_eff_s)``: those crossbars were re-programmed on their own, with
        their own salt and drift clock.
        """
        w = np.asarray(w, dtype=np.float64)
        mats = w.reshape((-1,) + w.shape[-2:])
        p = plan if plan is not None else CB.plan_tiles(
            mats.shape[1], mats.shape[2])
        if (p.n_in, p.n_out) != mats.shape[1:]:
            raise ValueError(
                f"plan covers ({p.n_in}, {p.n_out}) but the matrix is "
                f"{mats.shape[1:]}; derive the plan from the leaf shape")
        gen_salt = (generation,) if generation else ()
        out = np.empty_like(mats)
        for mi in range(mats.shape[0]):
            for (ti, tj), rs, cs in p.blocks():
                ov = col_overrides.get(tj) if col_overrides else None
                if ov is None:
                    out[mi, rs, cs] = self.age_weights(
                        mats[mi, rs, cs],
                        self.tile_rng(key, mi, ti, tj, *gen_salt))
                else:
                    gen_j, t_j = int(ov[0]), float(ov[1])
                    dev_j = self.with_drift(t_j)
                    salt_j = (gen_j,) if gen_j else ()
                    out[mi, rs, cs] = dev_j.age_weights(
                        mats[mi, rs, cs],
                        dev_j.tile_rng(key, mi, ti, tj, *salt_j))
        return out.reshape(w.shape)

    def age_params(self, params, rng: Optional[np.random.Generator] = None):
        """Build-stage aging of every matrix leaf of a params tree (nested
        dicts, lists and tuples of tensors).

        Leaves with fewer than 2 dims pass through untouched (they live in
        digital registers, not crossbar cells); the others come back aged,
        in their own dtype on their own device.  With ``rng=None`` (the
        deployment path) each leaf is aged per crossbar tile
        (:meth:`age_weights_tiled`, the default tile plan, generation 0)
        keyed by its tree path in ``jax.tree_util.keystr``'s spelling
        (``"['lstm']['w_gates']"``), so the chip is the JAX package's for
        the same tree.  An explicit ``rng`` is threaded through the leaves
        in the JAX flattening order (dict keys sorted).
        """
        if not self.has_build_stage:
            return params

        def one(path, w):
            if getattr(w, "ndim", 0) < 2:
                return w
            w64 = w.detach().to("cpu", torch.float64).numpy()
            aged = (self.age_weights_tiled(w64, path) if rng is None
                    else self.age_weights(w64, rng))
            return torch.from_numpy(aged).to(device=w.device, dtype=w.dtype)

        return _map_with_path(params, one)

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON representation (round-trips via device_from_dict)."""
        out: Dict[str, Any] = {"name": self.name, "seed": self.seed,
                               "paired_noise": self.paired_noise}
        for field in _STAGE_TYPES:
            stage = getattr(self, field)
            out[field] = None if stage is None else dataclasses.asdict(stage)
        return out


def _map_with_path(tree, fn, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, visiting
    dict keys in sorted order (JAX's flattening order) and spelling each
    path as ``jax.tree_util.keystr`` does: ``['key']`` for a dict entry,
    ``[i]`` for a sequence item."""
    if isinstance(tree, dict):
        return {k: _map_with_path(tree[k], fn, f"{path}[{k!r}]")
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(v, fn, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


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
