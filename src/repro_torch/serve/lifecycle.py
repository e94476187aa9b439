"""Device lifecycle for the serving engine: aging, INL probes, re-calibration.

The JAX package's ``repro/serve/lifecycle.py``, host numpy over
:meth:`DeviceModel.tile_rng`, so it gives the reference's INL values,
re-calibrated ramp keys, ``cal_shift`` values, deployed thresholds and
events to the bit.

A deployed chip is not static: the programmed NL-ADC ramp conductances (and
the weight crossbars) drift over shelf/serving time (Supp. S13), and the
paper's answer is periodic **one-point re-calibration** — the same Supp. S9
``V_init`` shift realized with bias memristors, re-applied in the field.
This module owns that loop:

* :class:`RampState` — the *persistent physical identity* of one programmed
  ramp column: the conductances as written at the fab (write noise + faults
  + redundancy winner), plus the accumulated calibration shift.  Thresholds
  at any device age are a pure function of ``(state, device model, age)``,
  which is what makes an engine restart bit-reproducible.
* :class:`RecalScheduler` — advances device age across serve steps, probes
  per-ramp INL (cheap: host-side threshold arrays vs the ideal ramp),
  triggers one-point re-calibration of **exactly the ramps whose own INL
  crossed** ``RecalPolicy.inl_threshold_lsb`` (a recal event reprograms
  only the out-of-spec ramp columns — per-bank for banked activations),
  and records an age → recalibrate → recovered-accuracy trace.  On every
  probe it re-deploys the aged thresholds into the model's
  :class:`~repro_torch.core.analog_layer.AnalogActivation` objects — the caller
  (``ServingEngine``) re-programs the chip when told so.

**Threshold banks.**  A banked activation (``AnalogConfig.bank_cols``)
carries one :class:`RampState` per col-tile bank, keyed
``"{name}@{width}:{j}"``; banks realized lazily (first use at a width) are adopted
on the next probe.  Each bank ages, probes, and re-calibrates
independently — two banks of one activation are different physical ramp
columns.

**Weight refresh.**  One-point recal can only shift ``V_init``; when the
drifted ramp *shape* (or the weight crossbars behind it) has degraded so
far that recal no longer brings INL back under the threshold for
``RecalPolicy.weight_refresh_after_stalls`` consecutive recal events, the
scheduler raises ``weight_refresh_pending`` — the engine consumes it and
re-programs the drifted weight crossbars (a fresh tile-keyed write, see
``DeviceModel.age_weights_tiled(generation=...)``).

All randomness (drift dispersion, the write noise on the re-calibration
bias devices) is keyed via :meth:`DeviceModel.tile_rng` off stable string
identities + integer salts, never off call order — so the scheduler state
serializes (:meth:`RecalScheduler.to_dict`) and resumes to the identical
device realization.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core import calibration as CAL
from repro_torch.core.analog_layer import AnalogActivation
from repro_torch.core.device import DeviceModel, Drift, device_from_dict
from repro_torch.core.nladc import Ramp, inl_lsb, ramp_from_conductances


def analog_activations(model) -> Dict[str, AnalogActivation]:
    """Discover a model's NL-ADC activations, keyed by attribute name.

    Every model family keeps its :class:`AnalogActivation` objects as
    instance attributes (``act``, ``sigmoid_act``, ...); the sort makes the
    key order — and therefore the checkpoint tree — deterministic.  Only
    activations that actually carry a programmed ramp participate in the
    lifecycle.
    """
    out: Dict[str, AnalogActivation] = {}
    for attr in sorted(vars(model)):
        v = getattr(model, attr)
        if isinstance(v, AnalogActivation) and v.ramp is not None \
                and v.ideal_ramp is not None:
            out[attr] = v
    return out


@dataclasses.dataclass(frozen=True)
class RecalPolicy:
    """Knobs for the serving-time re-calibration loop.

    ``age_per_step_s``     device seconds added per engine step (a serving
                           simulation runs much faster than wall-clock shelf
                           life; 0 freezes age — probes still run).
    ``check_every``        engine steps between INL probes (<= 0 disables).
    ``inl_threshold_lsb``  per-ramp deployed INL (LSBs) above which that
                           ramp (and only that ramp) gets a one-point
                           re-calibration.
    ``weight_refresh_after_stalls``
                           consecutive recal events that fail to bring the
                           recal'd ramps back under the INL threshold
                           before the scheduler requests a weight-crossbar
                           re-program (0 disables the refresh hook).
    """

    age_per_step_s: float = 0.0
    check_every: int = 64
    inl_threshold_lsb: float = 1.0
    weight_refresh_after_stalls: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class RampState:
    """One ramp column's programmed devices + accumulated calibration.

    ``line_frac`` fixes the column's physical position along the wordline
    (the normalized wire run from the driver — per col-tile bank under a
    LineResistance stage, 1.0 otherwise); every threshold rebuild of this
    state goes through the device's IR-aware rebuild at that position, so
    INL probes see the IR-drop-induced curvature the deployed comparators
    actually suffer.
    """

    def __init__(self, name: str, ideal: Ramp, g0_us: np.ndarray,
                 cal_shift: float, n_cali: int, line_frac: float = 1.0):
        self.name = name                      # tile/instance key
        self.ideal = ideal
        self.g0_us = np.asarray(g0_us, np.float64)
        self.cal_shift = float(cal_shift)
        self.n_cali = int(n_cali)
        self.line_frac = float(line_frac)

    @classmethod
    def program(cls, device: DeviceModel, ideal: Ramp, name: str,
                line_frac: float = 1.0) -> "RampState":
        """Fab-time programming of a *fresh* (age-0) column.

        Uses the device model's write/stuck/redundancy/calibration stages
        but NOT its drift stage — under the scheduler, age is dynamic state,
        not a preset constant.  The one-point calibration performed here is
        the factory calibration; later shifts come from
        :meth:`recalibrate`.
        """
        fresh = device.replace(drift=None)
        prog = fresh.program(ideal, instance=name, line_frac=line_frac)
        # The calibration realized at programming time is a constant V_init
        # shift; recover it against the uncalibrated rebuild so thresholds
        # at any age decompose as rebuild(drift(g0)) + cal_shift.
        rebuild = device.line_rebuild(line_frac) or ramp_from_conductances
        base = rebuild(ideal, prog.conductances_us)
        shift = float(prog.programmed.thresholds[0] - base.thresholds[0])
        return cls(name, ideal, prog.conductances_us, shift,
                   prog.n_cali_devices, line_frac)

    # -- pure functions of (state, device, age) --------------------------

    def conductances_at(self, device: DeviceModel,
                        age_s: float) -> np.ndarray:
        """Programmed conductances after ``age_s`` seconds of retention."""
        if age_s <= 0:
            return self.g0_us
        drift = (device.drift or Drift()).model()
        # Dispersion keyed by (seed, instance, age) — the same age always
        # realizes the same chip, on any engine, after any restart.
        rng = device.tile_rng(f"ramp-drift:{self.name}",
                              int(round(age_s * 1000.0)))
        return drift.drift(self.g0_us, age_s, rng)

    def ramp_at(self, device: DeviceModel, age_s: float) -> Ramp:
        rebuild = device.line_rebuild(self.line_frac) or \
            ramp_from_conductances
        base = rebuild(self.ideal, self.conductances_at(device, age_s))
        return base.with_thresholds(base.thresholds + self.cal_shift)

    def inl_at(self, device: DeviceModel, age_s: float) -> float:
        return inl_lsb(self.ramp_at(device, age_s), self.ideal)[0]

    # -- the field operation ---------------------------------------------

    def recalibrate(self, device: DeviceModel, age_s: float,
                    n_recal: int) -> float:
        """Supp. S9 one-point shift against the *current* aged ramp.

        The shift devices suffer write noise like any programming op; their
        rng is keyed by the recal ordinal so replaying the schedule (or
        resuming from a checkpoint) realizes identical bias devices.
        Returns the applied shift (volts).
        """
        cur = self.ramp_at(device, age_s)
        sigma = device.write.sigma_us if device.write is not None else 0.0
        rng = device.tile_rng(f"recal:{self.name}", n_recal)
        cal, n = CAL.one_point_calibrate(cur, self.ideal, rng,
                                         sigma_us=sigma)
        delta = float(cal.thresholds[0] - cur.thresholds[0])
        self.cal_shift += delta
        self.n_cali += n
        return delta

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return {"name": self.name, "ramp_name": self.ideal.name,
                "bits": self.ideal.bits, "g0_us": self.g0_us.tolist(),
                "cal_shift": self.cal_shift, "n_cali": self.n_cali,
                "line_frac": self.line_frac}

    @classmethod
    def from_dict(cls, d: dict, ideal: Ramp) -> "RampState":
        if (ideal.name, ideal.bits) != (d["ramp_name"], d["bits"]):
            raise ValueError(
                f"ramp state {d['name']!r} was programmed for "
                f"({d['ramp_name']}, {d['bits']}b), got "
                f"({ideal.name}, {ideal.bits}b)")
        return cls(d["name"], ideal, np.asarray(d["g0_us"], np.float64),
                   d["cal_shift"], d["n_cali"],
                   float(d.get("line_frac", 1.0)))


class RecalScheduler:
    """Ages a deployment across serve steps and re-calibrates on demand.

    ``accuracy_probe``: optional zero-arg callable returning a float —
    evaluated after each re-calibration (and on the probe before it) so the
    event trace records recovered accuracy, not just recovered INL.
    """

    def __init__(self, device: DeviceModel,
                 activations: Dict[str, AnalogActivation],
                 policy: RecalPolicy = RecalPolicy(), *,
                 accuracy_probe: Optional[Callable[[], float]] = None,
                 _program: bool = True):
        self.device = device
        self.policy = policy
        self.acts = dict(activations)
        self.accuracy_probe = accuracy_probe
        # Optional repro_torch.obs.Obs bundle (the owning engine wires it): every
        # probe event is also published on the shared event bus (src
        # "sched", tagged with the recal'd ramp keys — and the chip id when
        # the bundle is a fleet child) and mirrored into lifecycle gauges.
        self.obs = None
        # A preset with a Drift stage describes a chip already t_s old at
        # deployment (aged-1day) — the lifecycle clock starts there.
        self.age_s = float(device.drift.t_s) if device.drift is not None \
            else 0.0
        self.step_count = 0
        self.n_recals = 0
        self.stall_count = 0
        self.weight_refresh_pending = False
        # Ramp-state keys whose recal stalled when the pending refresh was
        # raised — the engine re-programs only the crossbar col-tiles
        # feeding these ramps (falling back to a full re-program when a
        # stalled ramp can't be mapped to param leaves).
        self.weight_refresh_ramps: List[str] = []
        self.events: List[dict] = []
        self.ramps: Dict[str, RampState] = {}
        if _program:
            for name, act in self.acts.items():
                self.ramps[name] = RampState.program(
                    device, act.ideal_ramp, name)
            self._sync_banks()
            self.redeploy()

    # -- threshold banks ---------------------------------------------------

    @staticmethod
    def bank_key(name: str, width: int, j: int) -> str:
        """Ramp-state key of one col-tile bank member (also its rng salt)."""
        return f"{name}@{width}:{j}"

    def _bank_groups(self):
        """Yield ``(name, act, width, bank)`` for every realized bank."""
        for name, act in self.acts.items():
            for width, bank in sorted(act.banks().items()):
                yield name, act, width, bank

    def _sync_banks(self) -> None:
        """Adopt banks the model realized since the last probe.

        Banks deploy lazily (per application width, at its first use), so
        the scheduler programs their
        :class:`RampState` on the next probe.  The draws are keyed purely
        by the bank-state key, so adoption order never changes a bank's
        chip.
        """
        for name, act, width, bank in self._bank_groups():
            for j in range(bank.n_banks):
                key = self.bank_key(name, width, j)
                if key not in self.ramps:
                    # Bank-aware programming: position-true IR rebuild
                    # (bank_line_frac) + Supp. S11 redundancy spent on the
                    # worst col-tile (bank_device) — both identity without
                    # a LineResistance stage.
                    self.ramps[key] = RampState.program(
                        self.device.bank_device(j, bank.n_banks),
                        act.ideal_ramp, key,
                        self.device.bank_line_frac(j, bank.n_banks))

    # -- probes ------------------------------------------------------------

    def probe_inl(self) -> float:
        """Mean deployed INL across all ramps at the current age (LSBs)."""
        if not self.ramps:
            return 0.0
        return float(np.mean([s.inl_at(self.device, self.age_s)
                              for s in self.ramps.values()]))

    def probe_inl_per_ramp(self) -> Dict[str, float]:
        """Per-ramp (and per-bank) deployed INL at the current age."""
        return {k: s.inl_at(self.device, self.age_s)
                for k, s in self.ramps.items()}

    def redeploy(self) -> bool:
        """Push current-age thresholds into the activations.

        Returns True when any threshold actually moved (the caller must
        then re-program the chip: see ``ServingEngine``).
        """
        changed = False
        for name, act in self.acts.items():
            state = self.ramps.get(name)
            if state is None:
                continue
            new = state.ramp_at(self.device, self.age_s)
            old = act.ramp.thresholds
            if old.shape != new.thresholds.shape \
                    or np.max(np.abs(old - new.thresholds)) > 0:
                act.redeploy(new)
                changed = True
        for name, act, width, bank in self._bank_groups():
            states = [self.ramps.get(self.bank_key(name, width, j))
                      for j in range(bank.n_banks)]
            if any(s is None for s in states):
                continue                       # not yet adopted
            ramps = [s.ramp_at(self.device, self.age_s) for s in states]
            new_thr = np.stack([r.thresholds for r in ramps])
            if bank.thresholds_f64.shape != new_thr.shape \
                    or np.max(np.abs(bank.thresholds_f64 - new_thr)) > 0:
                act.redeploy_bank(width, ramps)
                changed = True
        return changed

    # -- the serving loop hook --------------------------------------------

    def tick(self, n_steps: int = 1, *,
             age_per_step_s: Optional[float] = None) -> bool:
        """Advance ``n_steps`` engine steps; probe/recalibrate on cadence.

        A probe fires whenever the step counter *crosses* a multiple of
        ``check_every`` (once per tick, even if a large ``n_steps`` crosses
        several), so batched callers can't silently skip a due probe.
        Returns True when deployed thresholds changed (the engine re-deploys).

        ``age_per_step_s`` overrides the policy's per-step age rate for
        THIS tick only — fleet shelf aging uses it to age a chip that is
        powered but serving no traffic (drift doesn't care about load).
        """
        prev = self.step_count
        self.step_count += n_steps
        rate = self.policy.age_per_step_s if age_per_step_s is None \
            else float(age_per_step_s)
        self.age_s += rate * n_steps
        if self.policy.check_every <= 0 \
                or self.step_count // self.policy.check_every \
                == prev // self.policy.check_every:
            return False
        return self.check()

    def check(self) -> bool:
        """One INL probe; re-calibrate exactly the out-of-spec ramps.

        Each ramp (each col-tile bank of a banked activation counts as its
        own ramp — it is its own physical column) triggers on its OWN INL,
        so a recal event reprograms only the degraded ramp columns.
        """
        self._sync_banks()
        # Deploy the current-age thresholds FIRST so every probe in this
        # event (INL and accuracy alike) sees the same chip at the same age.
        changed = self.redeploy()
        inls = self.probe_inl_per_ramp()
        inl = float(np.mean(list(inls.values()))) if inls else 0.0
        # Same step/type field names as every other bus event (the unified
        # repro_torch.obs schema); the legacy self.events list keeps carrying the
        # full dicts so existing readers/checkpoints are unchanged.
        event = {"step": self.step_count, "type": "probe",
                 "age_s": self.age_s,
                 "inl_lsb": round(inl, 4), "recalibrated": False}
        if self.accuracy_probe is not None:
            event["accuracy"] = float(self.accuracy_probe())
        over = sorted(k for k, v in inls.items()
                      if v > self.policy.inl_threshold_lsb)
        if over:
            for key in over:
                self.ramps[key].recalibrate(self.device, self.age_s,
                                            self.n_recals)
            self.n_recals += 1
            event["recalibrated"] = True
            event["recal_ramps"] = over
            after = self.probe_inl_per_ramp()
            event["inl_after_lsb"] = round(
                float(np.mean(list(after.values()))), 4)
            changed = self.redeploy() or changed
            if self.accuracy_probe is not None:
                event["accuracy_recovered"] = float(self.accuracy_probe())
            # Recovery-stall tracking: recal only shifts V_init — if the
            # recal'd ramps are STILL out of spec, the chip (ramp shape
            # and, on the same clock, the weight crossbars) has drifted
            # beyond what calibration fixes.
            stalled = any(after[k] > self.policy.inl_threshold_lsb
                          for k in over)
            self.stall_count = self.stall_count + 1 if stalled else 0
            n_stalls = self.policy.weight_refresh_after_stalls
            if n_stalls > 0 and self.stall_count >= n_stalls:
                self.weight_refresh_pending = True
                self.weight_refresh_ramps = sorted(
                    k for k in over
                    if after[k] > self.policy.inl_threshold_lsb)
                self.stall_count = 0
                event["weight_refresh"] = True
                event["weight_refresh_ramps"] = \
                    list(self.weight_refresh_ramps)
                changed = True        # the engine must rebuild either way
        self.events.append(event)
        if self.obs is not None:
            tags = {k: v for k, v in event.items()
                    if k not in ("step", "type")}
            self.obs.emit("probe", step=self.step_count, src="sched",
                          **tags)
            self.obs.gauge("lifecycle.age_s").set(self.age_s)
            self.obs.gauge("lifecycle.inl_lsb").set(
                event.get("inl_after_lsb", event["inl_lsb"]))
            self.obs.gauge("lifecycle.recals_total").set(self.n_recals)
            if event["recalibrated"]:
                self.obs.counter("lifecycle.recal_events").inc()
            if event.get("weight_refresh"):
                self.obs.counter("lifecycle.weight_refresh_events").inc()
        return changed

    def consume_weight_refresh(self) -> bool:
        """True once per pending weight-crossbar re-program request.

        The stalled ramp keys driving the request stay readable in
        ``weight_refresh_ramps`` until the next probe raises a new one —
        callers snapshot them *before* consuming.
        """
        pending, self.weight_refresh_pending = \
            self.weight_refresh_pending, False
        return pending

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        """Plain-JSON state (device + policy + clock + ramp states)."""
        return {
            "device": self.device.to_dict(),
            "policy": self.policy.to_dict(),
            "age_s": self.age_s,
            "step_count": self.step_count,
            "n_recals": self.n_recals,
            "stall_count": self.stall_count,
            "weight_refresh_pending": self.weight_refresh_pending,
            "weight_refresh_ramps": list(self.weight_refresh_ramps),
            "events": list(self.events),
            "ramps": {k: v.to_dict() for k, v in self.ramps.items()},
        }

    @classmethod
    def from_dict(cls, d: dict,
                  activations: Dict[str, AnalogActivation], *,
                  accuracy_probe: Optional[Callable[[], float]] = None
                  ) -> "RecalScheduler":
        """Rebuild from :meth:`to_dict` against live activation objects.

        Does NOT redeploy: the checkpointed threshold arrays are restored
        separately (``ServingEngine.restore``) so the resumed deployment is
        bitwise the saved one even when the save landed between probes.
        """
        sched = cls(device_from_dict(d["device"]),
                    activations, RecalPolicy(**d["policy"]),
                    accuracy_probe=accuracy_probe, _program=False)
        sched.age_s = float(d["age_s"])
        sched.step_count = int(d["step_count"])
        sched.n_recals = int(d["n_recals"])
        sched.stall_count = int(d.get("stall_count", 0))
        sched.weight_refresh_pending = bool(
            d.get("weight_refresh_pending", False))
        sched.weight_refresh_ramps = list(d.get("weight_refresh_ramps", []))
        sched.events = list(d["events"])
        for key, rd in d["ramps"].items():
            # bank-state keys are "{act}@{width}:{j}"; plain keys are acts
            name = key.split("@", 1)[0]
            if name not in sched.acts:
                raise ValueError(f"checkpointed ramp {key!r} has no "
                                 f"matching activation; have "
                                 f"{sorted(sched.acts)}")
            sched.ramps[key] = RampState.from_dict(
                rd, sched.acts[name].ideal_ramp)
        return sched
