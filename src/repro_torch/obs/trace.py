"""Span tracer + shared event bus (deterministic step-clock primary).

The primary clock is the **step clock**: whoever owns the tracer calls
:meth:`Tracer.set_step` once per engine/fleet step, and every span/event
records ``(step, seq)`` where ``seq`` is a monotonically increasing
per-tracer ordinal.  Both are pure functions of the (seeded) serving
schedule, so two seeded runs — or an uninterrupted run vs a
checkpoint-restored one — emit **bitwise-identical JSONL traces**.
Wall-clock timing is opt-in (``wall_clock=True``) and lands only in
``wall_*``-prefixed fields, which readers (and the determinism tests)
strip.

Entries are plain dicts with a stable field order:

* spans:  ``{"kind": "span", "seq", "name", "step", "end_step", attrs...}``
* events: ``{"kind": "event", "seq", "type", "step", attrs...}``

The :class:`EventBus` is the **shared event seam** the fleet, the serving
engines, and the recal schedulers all publish on: entries carry the same
``step``/``type`` field names everywhere and are tagged with ``chip`` /
``ramp`` ids where applicable, replacing the ad-hoc per-object event
lists (compat accessors on ``FleetEngine.events`` /
``RecalScheduler.events`` keep the old views working).  A bus can forward
onto a tracer so bus events land in the exported JSONL timeline.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional


class Tracer:
    """Append-only span/event recorder on a deterministic step clock."""

    def __init__(self, *, enabled: bool = True, wall_clock: bool = False):
        self.enabled = enabled
        self.wall_clock = wall_clock
        self.entries: List[dict] = []
        self.step = 0
        self.seq = 0

    def set_step(self, step: int) -> None:
        self.step = int(step)

    def _next_seq(self) -> int:
        self.seq += 1
        return self.seq

    def event(self, type: str, **attrs) -> None:
        """One point on the timeline at the current step."""
        if not self.enabled:
            return
        entry = {"kind": "event", "seq": self._next_seq(), "type": type,
                 "step": self.step}
        if self.wall_clock:
            entry["wall_s"] = time.time()
        entry.update(attrs)
        self.entries.append(entry)

    def span(self, name: str, **attrs) -> "_Span":
        """Context manager recording a ``[start step, end step]`` span.

        The entry is appended at *exit* (so a trace is a valid timeline
        even mid-span) with any attrs added via :meth:`_Span.set`.
        """
        return _Span(self, name, attrs)

    # -- state / export ------------------------------------------------

    def counters(self) -> dict:
        """The replayable clock state (rides in checkpoints so a restored
        deployment's trace continues with the exact seq/step ordinals)."""
        return {"step": self.step, "seq": self.seq}

    def restore_counters(self, d: dict) -> None:
        self.step = int(d.get("step", 0))
        self.seq = int(d.get("seq", 0))

    def to_jsonl(self) -> str:
        return "".join(json.dumps(e, sort_keys=False) + "\n"
                       for e in self.entries)

    def write_jsonl(self, path: str, *, append: bool = False) -> None:
        with open(path, "a" if append else "w") as f:
            f.write(self.to_jsonl())

    def drain(self) -> List[dict]:
        """Pop all recorded entries (long-running exporters flush with
        this so the in-memory trace stays bounded)."""
        out, self.entries = self.entries, []
        return out


class _Span:
    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self._t = tracer
        self._name = name
        self._attrs = dict(attrs)
        self._start_step = 0
        self._start_wall = 0.0

    def set(self, **attrs) -> None:
        self._attrs.update(attrs)

    def __enter__(self) -> "_Span":
        self._start_step = self._t.step
        if self._t.wall_clock:
            self._start_wall = time.time()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t = self._t
        if not t.enabled:
            return
        entry = {"kind": "span", "seq": t._next_seq(), "name": self._name,
                 "step": self._start_step, "end_step": t.step}
        if t.wall_clock:
            now = time.time()
            entry["wall_s"] = self._start_wall
            entry["wall_dur_s"] = now - self._start_wall
        entry.update(self._attrs)
        t.entries.append(entry)


class EventBus:
    """The shared, serializable event stream of a deployment.

    ``emit`` appends ``{"step", "type", **tags}`` (``src`` names the
    publishing layer: "fleet", "engine", "sched") and mirrors the entry
    onto the attached tracer so exported traces carry the full
    cross-layer timeline.  The list is plain JSON — fleet checkpoints
    save and restore it verbatim.
    """

    def __init__(self, tracer: Optional[Tracer] = None):
        self.events: List[dict] = []
        self.tracer = tracer

    def emit(self, type: str, *, step: int, src: str = "fleet",
             **tags) -> dict:
        entry = {"step": int(step), "type": type, "src": src, **tags}
        self.events.append(entry)
        if self.tracer is not None:
            self.tracer.event(type, src=src,
                              **{k: v for k, v in tags.items()})
        return entry

    def view(self, *, src: Optional[str] = None,
             chip: Optional[str] = None) -> List[dict]:
        """Filtered read (compat accessors build their old-shape lists
        from this)."""
        out = self.events
        if src is not None:
            out = [e for e in out if e.get("src") == src]
        if chip is not None:
            out = [e for e in out if e.get("chip") == chip]
        return list(out)


WALL_FIELDS = ("wall_s", "wall_dur_s")


def strip_wall(entries) -> List[dict]:
    """Entries minus the wall-clock fields — the determinism-comparable
    projection of a trace (used by tests and ``repro_torch.obs.replay``)."""
    return [{k: v for k, v in e.items() if k not in WALL_FIELDS}
            for e in entries]


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
