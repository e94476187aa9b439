"""Fleet serving: N independently aging chips behind one request router.

The JAX package's ``repro/serve/fleet.py``.  The chips share one pristine
params tree (each engine keeps its own aged copy on the card and the
pristine one on the host); the models live on the card unless
``torch_device`` names the CPU.

One 65 nm NL-CIM macro tops out far below production traffic, so the
north-star deployment is a *fleet*: N :class:`ServingEngine` chips, each a
physically distinct device — its own tile-keyed write-noise population
(per-chip seed salt), its own drift clock, its own
:class:`~repro_torch.serve.lifecycle.RecalScheduler`.  A fleet is NOT N copies of
one chip; heterogeneous aging is the whole point, and it is what makes
uncoordinated maintenance dangerous: left alone, every chip's INL crosses
threshold on roughly the same schedule and the whole fleet drains at once.

This module adds the coordination layer:

* **Router** (:attr:`FleetPolicy.router`) — ``round-robin`` /
  ``least-loaded`` / ``health-weighted`` admission across chips, always
  skipping chips whose drain window is open.  All three are deterministic
  (ties break by chip id), so a fleet checkpoint replays identical routing.
* **Maintenance planner** (:class:`MaintenancePlanner`) — chips raise
  ``maintenance_pending`` (fleet mode defers the re-program, see
  ``ServingEngine.external_maintenance``); the planner grants drain windows
  FIFO but never lets more than ``ceil(N * (1 - capacity_floor))`` chips
  drain at once.  A granted chip hands its queued requests to siblings
  (:func:`repro_torch.ft.elastic.plan_request_rebalance`) before closing
  admission.
* **Canaries** — chips pinned to aggressive presets (``stressed``,
  ``aged-1day``) age ahead of the fleet; a canary's first recalibration
  event is the early warning that tightens every sibling's probe cadence
  (``check_every // canary_tighten``) before *their* INL drifts out.
* **Fleet checkpoints** — one root manifest (router + planner + event
  trace) plus per-chip schema-2 deployment checkpoints under
  ``<root>/chips/<chip_id>``; :meth:`FleetEngine.restore` resumes the whole
  fleet bitwise in a fresh process on either backend.
"""

from __future__ import annotations

import dataclasses
import math
import os
import zlib
from typing import Dict, List, Optional

import torch

from repro_torch.ckpt.checkpoint import read_metadata, save_checkpoint
from repro_torch.core.device import (device_from_dict, register_device,
                                     resolve_device)
from repro_torch.ft.elastic import plan_request_rebalance
from repro_torch.nn.model import build as build_model
from repro_torch.obs import Obs
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.lifecycle import RecalPolicy

FLEET_SCHEMA = 1

ROUTERS = ("round-robin", "least-loaded", "health-weighted")


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """Fleet-level knobs (the per-chip lifecycle keeps its RecalPolicy).

    ``capacity_floor``   fraction of chips that must keep accepting traffic;
                         at most ``ceil(N * (1 - floor))`` drain at once.
    ``router``           admission policy, one of :data:`ROUTERS`.
    ``canary_tighten``   divisor applied to sibling ``check_every`` when a
                         canary fires its early warning (1 disables).
    ``shelf_age_per_step_s``  wall-clock aging applied to chips serving NO
                         traffic on a fleet step (0 disables).  Drift does
                         not care about load: a powered idle chip — in
                         particular an unrouted canary — keeps aging and
                         keeps probing, so its early warning still fires.
    """

    capacity_floor: float = 0.75
    router: str = "least-loaded"
    canary_tighten: int = 2
    shelf_age_per_step_s: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.capacity_floor <= 1.0:
            raise ValueError(
                f"capacity_floor must be in [0, 1], got {self.capacity_floor}")
        if self.router not in ROUTERS:
            raise ValueError(f"unknown router {self.router!r}; "
                             f"one of {ROUTERS}")
        if self.shelf_age_per_step_s < 0:
            raise ValueError(f"shelf_age_per_step_s must be >= 0, got "
                             f"{self.shelf_age_per_step_s}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One chip's identity: id, device preset, canary role.

    ``device`` "" inherits the fleet config's preset.  The *realized* chip
    model is the preset re-seeded with ``crc32(chip_id)`` — same physics,
    independent device population — registered as ``"{preset}@{chip_id}"``.
    """

    chip_id: str
    device: str = ""
    canary: bool = False


def chip_device(base, chip_id: str):
    """Derive chip ``chip_id``'s device model from a preset.

    Pure function of (preset, chip_id): the per-deployment seed is salted
    with the chip id, so every chip's tile-keyed build-stage draws (write
    noise, faults, per-col-tile ramp programming) are independent — N
    physically distinct dies of one process corner.
    """
    return base.replace(seed=base.seed ^ zlib.crc32(chip_id.encode()),
                        name=f"{base.name}@{chip_id}")


class MaintenancePlanner:
    """Serializes drain windows so capacity never drops below the floor.

    Requests queue FIFO; at most ``max_drain`` chips hold an open window.
    Pure host-side bookkeeping — deterministic and JSON-serializable, so a
    fleet checkpoint restores the exact grant order.
    """

    def __init__(self, n_chips: int, capacity_floor: float):
        self.n_chips = int(n_chips)
        self.capacity_floor = float(capacity_floor)
        self.max_drain = math.ceil(n_chips * (1.0 - capacity_floor))
        self.pending: List[str] = []
        self.draining: List[str] = []

    def request(self, chip_id: str) -> bool:
        """Queue a maintenance request (idempotent while outstanding)."""
        if chip_id in self.pending or chip_id in self.draining:
            return False
        self.pending.append(chip_id)
        return True

    def grant_next(self) -> Optional[str]:
        """Open the next drain window if the floor allows one more."""
        if not self.pending or len(self.draining) >= self.max_drain:
            return None
        cid = self.pending.pop(0)
        self.draining.append(cid)
        return cid

    def complete(self, chip_id: str) -> None:
        self.draining.remove(chip_id)

    def to_dict(self) -> dict:
        return {"n_chips": self.n_chips,
                "capacity_floor": self.capacity_floor,
                "pending": list(self.pending),
                "draining": list(self.draining)}

    @classmethod
    def from_dict(cls, d: dict) -> "MaintenancePlanner":
        p = cls(d["n_chips"], d["capacity_floor"])
        p.pending = list(d["pending"])
        p.draining = list(d["draining"])
        return p


class Chip:
    """One fleet member: spec + realized device + model + engine."""

    def __init__(self, spec: ChipSpec, device, model,
                 engine: ServingEngine):
        self.spec = spec
        self.device = device
        self.model = model
        self.engine = engine

    @property
    def chip_id(self) -> str:
        return self.spec.chip_id


def _not_encdec(cfg) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            "a fleet of the encoder-decoder is not ported yet; ROADMAP.md "
            "queue A item 5 brings it")


class FleetEngine:
    """N chips, one router, one maintenance planner, one event trace.

    Build with :meth:`build` (fresh fleet) or :meth:`restore` (from a fleet
    checkpoint).  :meth:`submit` routes one request; :meth:`step` advances
    every chip one engine step and runs the maintenance loop.
    """

    def __init__(self, chips: Dict[str, Chip], policy: FleetPolicy, *,
                 recal=None, obs=None, _restored: Optional[dict] = None):
        if not chips:
            raise ValueError("a fleet needs at least one chip")
        self.chips = {cid: chips[cid] for cid in sorted(chips)}
        self.policy = policy
        self.recal = recal
        # The fleet's obs bundle; :meth:`build`/:meth:`restore` hand every
        # chip engine a per-chip child of it, so router decisions, drain
        # windows, canary warnings, chip re-programs, and scheduler probes
        # all land on ONE shared event bus (and one metrics registry),
        # chip-tagged.  The legacy ``self.events`` list survives as a
        # compat property over the bus (src == "fleet" entries only).
        self.obs = obs if obs is not None else Obs()
        self.bus = self.obs.bus
        self._m_admission = self.obs.histogram("fleet.admission_steps")
        self._m_routed: Dict[str, object] = {
            cid: self.obs.metrics.counter("fleet.requests_routed",
                                          chip=cid)
            for cid in self.chips}
        self.planner = MaintenancePlanner(len(chips), policy.capacity_floor)
        self.step_count = 0
        # routing / admission-latency bookkeeping (all deterministic)
        self._rr = 0
        self._submit_step: Dict[int, int] = {}
        self._first_tok_step: Dict[int, int] = {}
        # per-canary scheduler-event cursors + one-shot warning latches
        self._canary_cursor: Dict[str, int] = {
            cid: 0 for cid, c in self.chips.items() if c.spec.canary}
        self._canary_warned: List[str] = []
        if _restored is not None:
            self.planner = MaintenancePlanner.from_dict(
                _restored["planner"])
            self.step_count = int(_restored["step_count"])
            # old (pre-obs) manifests saved only the fleet-level events,
            # without the bus "src" tag — adopt them as src="fleet"
            self.bus.events = [
                e if "src" in e else {**e, "src": "fleet"}
                for e in _restored["events"]]
            self.obs.restore(_restored.get("obs"))
            self._rr = int(_restored["router"]["rr"])
            self._submit_step = {int(k): int(v) for k, v in
                                 _restored["submit_step"].items()}
            self._first_tok_step = {int(k): int(v) for k, v in
                                    _restored["first_tok_step"].items()}
            self._canary_cursor = {k: int(v) for k, v in
                                   _restored["canary_cursor"].items()}
            self._canary_warned = list(_restored["canary_warned"])

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, cfg, n_chips: int, *, policy: FleetPolicy = FleetPolicy(),
              recal=None, max_batch: int = 2, max_len: int = 64,
              canary_presets=(), params=None, noise_seed: int = 0,
              prefill: str = "scan", prefill_buckets=None,
              pack_prefill: bool = False, detok_thread: bool = False,
              obs=None, torch_device=None) -> "FleetEngine":
        """Instantiate a fresh fleet of ``n_chips`` for one model config.

        The last ``len(canary_presets)`` chips become canaries pinned to
        those device presets; the rest inherit ``cfg.analog.device``.
        ``params`` (pristine, pre-aging) is shared — chips differ by their
        device draws, not their trained weights; default is
        ``model.init(PRNGKey(0))`` built once.  The throughput knobs
        (``prefill`` / ``prefill_buckets`` / ``pack_prefill`` /
        ``detok_thread``) pass through to every chip's engine.
        ``torch_device``: where the models and params live (default
        ``cuda``).
        """
        _not_encdec(cfg)
        if n_chips < 1:
            raise ValueError(f"n_chips must be >= 1, got {n_chips}")
        if len(canary_presets) >= n_chips:
            raise ValueError(
                f"{len(canary_presets)} canaries need at least "
                f"{len(canary_presets) + 1} chips, got {n_chips}")
        specs = []
        n_serve = n_chips - len(canary_presets)
        for i in range(n_chips):
            canary = i >= n_serve
            specs.append(ChipSpec(
                chip_id=f"chip{i:02d}",
                device=canary_presets[i - n_serve] if canary else "",
                canary=canary))
        obs = obs if obs is not None else Obs()
        chips = {}
        for spec in specs:
            chip, params = cls._build_chip(
                cfg, spec, recal=recal, max_batch=max_batch,
                max_len=max_len, params=params, noise_seed=noise_seed,
                prefill=prefill, prefill_buckets=prefill_buckets,
                pack_prefill=pack_prefill, detok_thread=detok_thread,
                obs=obs.child(spec.chip_id), torch_device=torch_device)
            chips[spec.chip_id] = chip
        return cls(chips, policy, recal=recal, obs=obs)

    @staticmethod
    def _build_chip(cfg, spec: ChipSpec, *, recal, max_batch, max_len,
                    params, noise_seed, device_dict=None,
                    prefill: str = "scan", prefill_buckets=None,
                    pack_prefill: bool = False, detok_thread: bool = False,
                    obs=None, torch_device=None):
        """Realize one chip (device, model, engine); returns (chip, params)
        with params initialized on first use so the fleet shares one tree.

        ``device_dict``: restore path — the exact serialized device (seed
        and all) instead of deriving it from the preset.
        """
        dev = None
        chip_cfg = cfg
        if cfg.analog.mode == "infer":
            if device_dict is not None:
                dev = device_from_dict(device_dict)
            else:
                base = resolve_device(spec.device or cfg.analog.device)
                dev = chip_device(base, spec.chip_id)
            register_device(dev)
            chip_cfg = cfg.replace(analog=dataclasses.replace(
                cfg.analog, device=dev.name))
        elif recal is not None:
            raise ValueError(
                "a recal policy needs analog mode 'infer' (the lifecycle "
                f"acts on deployed device models); got {cfg.analog.mode!r}")
        model = build_model(chip_cfg, torch_device)
        if params is None:
            params = _init_params(model)
        engine = ServingEngine(
            model, params, max_batch=max_batch, max_len=max_len,
            device=dev, recal=recal,
            noise_seed=noise_seed ^ zlib.crc32(spec.chip_id.encode()),
            external_maintenance=True,
            prefill=prefill, prefill_buckets=prefill_buckets,
            pack_prefill=pack_prefill, detok_thread=detok_thread,
            obs=obs)
        return Chip(spec, dev, model, engine), params

    # -- routing -----------------------------------------------------------

    def accepting(self) -> List[str]:
        """Chips whose admission is open (no drain window), sorted by id."""
        return [cid for cid, c in self.chips.items()
                if not c.engine.draining]

    def capacity(self) -> float:
        return len(self.accepting()) / len(self.chips)

    def _route(self) -> str:
        """Pick the admission chip for one request (deterministic)."""
        open_ids = self.accepting()
        if not open_ids:
            raise RuntimeError(
                "no chip is accepting traffic — the planner should make "
                "this unreachable (capacity floor violated)")
        if self.policy.router == "round-robin":
            cid = open_ids[self._rr % len(open_ids)]
            self._rr += 1
            return cid

        def load(cid):
            h = self.chips[cid].engine.health()
            return h["active"] + h["queued"]

        if self.policy.router == "least-loaded":
            return min(open_ids, key=lambda c: (load(c), c))
        # health-weighted: prefer lightly-loaded AND in-spec chips — a chip
        # probing near the INL threshold costs more per queued request.
        # The INL term is freshness-discounted: a probe older than the
        # cadence (check_every) decays linearly to zero over one more
        # cadence, so a stale reading cannot keep steering traffic away
        # from (or toward) a chip whose drift has since moved on.
        def score(cid):
            h = self.chips[cid].engine.health()
            age, ce = h["inl_age_steps"], h["check_every"]
            if age < 0 or ce <= 0:
                w = 0.0                       # never probed: no INL signal
            elif age <= ce:
                w = 1.0
            else:
                w = max(0.0, 1.0 - (age - ce) / ce)
            return (h["active"] + h["queued"] + 1) * (1.0 + w * h["inl_lsb"])

        return min(open_ids, key=lambda c: (score(c), c))

    def submit(self, req: Request) -> str:
        """Route one request; returns the chip id it was admitted to."""
        cid = self._route()
        self.chips[cid].engine.submit(req)
        self._submit_step[req.uid] = self.step_count
        self._m_routed[cid].inc()
        return cid

    # -- the serving loop --------------------------------------------------

    def step(self) -> Dict[int, int]:
        """Advance every chip one engine step, then run maintenance.

        Returns the merged ``{uid: token}`` of the whole fleet.
        """
        self.step_count += 1
        out: Dict[int, int] = {}
        shelf: List[str] = []
        for cid, chip in self.chips.items():
            # an idle chip never reaches its engine's scheduler tick (the
            # step returns before decoding) — shelf-age it instead, so an
            # unrouted canary still drifts, probes, and warns
            idle = not chip.engine.queue and all(chip.engine.slot_free)
            toks = chip.engine.step()
            for uid in toks:
                if uid not in self._first_tok_step:
                    self._first_tok_step[uid] = self.step_count
                    if uid in self._submit_step:
                        self._m_admission.record(
                            self.step_count - self._submit_step[uid])
            out.update(toks)
            if idle and not toks:
                shelf.append(cid)
        self._update_maintenance()
        # shelf-age AFTER the maintenance loop: a chip that re-programmed
        # at the top of this step must close its planner window before a
        # fresh shelf tick may raise the next one (else the window never
        # completes and the capacity floor wedges the whole fleet)
        if self.policy.shelf_age_per_step_s > 0:
            for cid in shelf:
                self.chips[cid].engine.shelf_tick(
                    self.policy.shelf_age_per_step_s)
        return out

    def warmup(self) -> Dict[str, dict]:
        """Pre-compile every chip's bucket executables + decode step."""
        return {cid: c.engine.warmup() for cid, c in self.chips.items()}

    def run_to_completion(self, max_iters: int = 10_000) -> int:
        n = 0
        for _ in range(max_iters):
            if all(not c.engine.queue and all(c.engine.slot_free)
                   for c in self.chips.values()):
                break
            n += len(self.step())
        return n

    def _update_maintenance(self) -> None:
        self._watch_canaries()
        # completions first: a window that closed this step frees capacity
        # for the next grant in the same step
        for cid in list(self.planner.draining):
            if not self.chips[cid].engine.maintenance_pending:
                self.planner.complete(cid)
                # bucket-aware re-jit observability: which AOT prefill
                # executables the re-program kept vs re-compiled
                inval = self.chips[cid].engine.last_invalidation or {}
                self._event(
                    "reprogram_done", chip=cid,
                    buckets_kept=list(inval.get("kept_buckets", [])),
                    buckets_dropped=list(inval.get("dropped_buckets", [])))
        for cid, chip in self.chips.items():
            if chip.engine.maintenance_pending and not chip.engine.draining:
                if self.planner.request(cid):
                    self._event("maintenance_requested", chip=cid)
        while True:
            cid = self.planner.grant_next()
            if cid is None:
                break
            self._open_drain_window(cid)

    def _open_drain_window(self, cid: str) -> None:
        """Grant ``cid``'s window: hand queued traffic to siblings, close
        admission, let the chip's drain point apply the re-program."""
        eng = self.chips[cid].engine
        displaced = eng.take_queue()
        moved = {}
        if displaced:
            sibs = [s for s in self.accepting() if s != cid]
            loads = {s: (lambda h: h["active"] + h["queued"])(
                self.chips[s].engine.health()) for s in sibs}
            for sib, reqs in sorted(
                    plan_request_rebalance(displaced, loads).items()):
                for r in reqs:
                    self.chips[sib].engine.queue.append(r)
                if reqs:
                    moved[sib] = [r.uid for r in reqs]
        eng.begin_drain()
        self._event("drain_start", chip=cid, handoff=moved)

    def _watch_canaries(self) -> None:
        """A canary's first recalibration is the fleet's early warning:
        its aggressive preset ages ahead, so siblings tighten their probe
        cadence before their own INL drifts out of spec."""
        for cid, cursor in list(self._canary_cursor.items()):
            sched = self.chips[cid].engine.scheduler
            if sched is None:
                continue
            fresh = sched.events[cursor:]
            self._canary_cursor[cid] = len(sched.events)
            if cid in self._canary_warned:
                continue
            if not any(ev.get("recalibrated") for ev in fresh):
                continue
            self._canary_warned.append(cid)
            tightened = {}
            if self.policy.canary_tighten > 1:
                for sid, sib in self.chips.items():
                    ssched = sib.engine.scheduler
                    if sid == cid or sib.spec.canary or ssched is None:
                        continue
                    old = ssched.policy.check_every
                    new = max(1, old // self.policy.canary_tighten)
                    if new != old:
                        ssched.policy = dataclasses.replace(
                            ssched.policy, check_every=new)
                        tightened[sid] = {"from": old, "to": new}
            self._event("canary_warning", chip=cid, tightened=tightened)

    def force_maintenance(self, chip_id: str) -> None:
        """Operator-forced re-program request (CI smoke / manual ops)."""
        if self.planner.request(chip_id):
            self._event("maintenance_requested", chip=chip_id, forced=True)

    def _event(self, kind: str, **kw) -> None:
        self.obs.emit(kind, step=self.step_count, src="fleet", **kw)

    @property
    def events(self) -> List[dict]:
        """Compat view: the fleet-level events exactly as the pre-bus list
        carried them (bus entries with src == "fleet", tag stripped).  The
        full cross-layer stream — including per-chip scheduler probes —
        lives on :attr:`bus`."""
        return [{k: v for k, v in e.items() if k != "src"}
                for e in self.bus.view(src="fleet")]

    # -- observability -----------------------------------------------------

    def energy_report(self) -> Dict[str, dict]:
        """Per-chip costed efficiency (tokens/J, TOPS/W) from each chip's
        :class:`~repro_torch.obs.energy.EnergyMeter`."""
        return {cid: c.engine.energy.report()
                for cid, c in self.chips.items()}

    def admission_latency_steps(self) -> List[int]:
        """First-token latency (fleet steps) of every finished admission."""
        return [self._first_tok_step[uid] - s0
                for uid, s0 in sorted(self._submit_step.items())
                if uid in self._first_tok_step]

    def health(self) -> Dict[str, dict]:
        return {cid: c.engine.health() for cid, c in self.chips.items()}

    # -- checkpoint / restore ----------------------------------------------

    def save(self, root: str, step: int) -> str:
        """One fleet manifest + per-chip deployment checkpoints.

        Layout: ``<root>/step_<step>/`` holds the manifest (router, planner,
        events, chip inventory); ``<root>/chips/<chip_id>/step_<step>/`` is
        each chip's full schema-2 :meth:`ServingEngine.save`.
        """
        for cid, chip in self.chips.items():
            chip.engine.save(os.path.join(root, "chips", cid), step)
        meta = {"fleet": {
            "schema": FLEET_SCHEMA,
            "policy": self.policy.to_dict(),
            "recal": None if self.recal is None else self.recal.to_dict(),
            "engine": {
                "max_batch": next(iter(self.chips.values())).engine
                .max_batch,
                "max_len": next(iter(self.chips.values())).engine.max_len},
            "chips": [{
                "id": cid,
                "preset": chip.spec.device,
                "canary": chip.spec.canary,
                "device": None if chip.device is None
                else chip.device.to_dict(),
            } for cid, chip in self.chips.items()],
            "router": {"name": self.policy.router, "rr": self._rr},
            "planner": self.planner.to_dict(),
            # the full shared bus (src-tagged: fleet + engine + sched
            # entries), not just the fleet-level view — restore rebuilds
            # the bus verbatim and the compat property filters
            "events": list(self.bus.events),
            "obs": self.obs.snapshot(),
            "step_count": self.step_count,
            "submit_step": dict(self._submit_step),
            "first_tok_step": dict(self._first_tok_step),
            "canary_cursor": dict(self._canary_cursor),
            "canary_warned": list(self._canary_warned),
        }}
        return save_checkpoint(root, step, {}, metadata=meta)

    @classmethod
    def restore(cls, cfg, root: str, *, step: Optional[int] = None,
                obs=None, torch_device=None) -> "FleetEngine":
        """Resume a fleet bitwise: every chip's deployment, the router
        counter, the planner queue, the event trace.  Each chip's params
        load in place into a ``model.init`` tree of its own (the
        reference's ``params_like``, one tree shared by every chip, would
        be overwritten chip by chip here)."""
        _not_encdec(cfg)
        step, meta = read_metadata(root, step=step)
        if "fleet" not in meta:
            hint = ("this is a single-chip deployment — restore via "
                    "ServingEngine.restore"
                    if isinstance(meta, dict) and "engine" in meta else
                    "train checkpoints restore via repro_torch.ckpt "
                    "directly")
            raise ValueError(
                f"checkpoint at {root!r} (step {step}) is not a fleet "
                f"manifest (no 'fleet' metadata); {hint}")
        fm = meta["fleet"]
        if int(fm.get("schema", 1)) > FLEET_SCHEMA:
            raise ValueError(
                f"fleet manifest schema {fm['schema']} is newer than this "
                f"build understands (<= {FLEET_SCHEMA}); upgrade "
                "repro_torch")
        policy = FleetPolicy(**fm["policy"])
        recal = None if fm["recal"] is None else RecalPolicy(**fm["recal"])
        obs = obs if obs is not None else Obs()
        chips = {}
        for entry in fm["chips"]:
            cid = entry["id"]
            spec = ChipSpec(chip_id=cid, device=entry["preset"],
                            canary=entry["canary"])
            chip_cfg = cfg
            dev = None
            if entry["device"] is not None:
                dev = device_from_dict(entry["device"])
                register_device(dev)
                chip_cfg = cfg.replace(analog=dataclasses.replace(
                    cfg.analog, device=dev.name))
            model = build_model(chip_cfg, torch_device)
            engine = ServingEngine.restore(
                model, os.path.join(root, "chips", cid), step=step,
                params_like=_init_params(model), external_maintenance=True,
                obs=obs.child(cid))
            chips[cid] = Chip(spec, dev, model, engine)
        return cls(chips, policy, recal=recal, obs=obs, _restored=fm)


def _init_params(model):
    """``model.init`` from seed 0 on the model's device."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    return model.init(gen)
