"""``repro_torch.obs`` — unified tracing, metrics, and energy accounting.

One observability seam for the whole serving/fleet/lifecycle/train stack:

* :class:`~repro_torch.obs.trace.Tracer` — span/event recorder on a
  deterministic step clock (JSONL export; wall clock opt-in so traces
  stay bitwise-reproducible);
* :class:`~repro_torch.obs.trace.EventBus` — the shared event stream (fleet
  router/planner decisions, chip re-programs, scheduler probes) with a
  unified ``step``/``type`` schema and chip/ramp tags;
* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters, gauges, and
  mergeable log-scale histograms, with Prometheus-text export and
  checkpointable snapshots;
* :class:`~repro_torch.obs.energy.EnergyMeter` — per-chip token-priced energy
  counters (``core.hwcost``: NL-ADC periphery vs a NEON-style digital
  LUT baseline) reporting tokens-per-joule and TOPS/W.

The :class:`Obs` bundle ties them together.  Layers share one bundle: a
fleet creates it and hands each chip a :meth:`Obs.child` view that tags
everything that chip publishes with its ``chip`` id.  ``repro_torch.obs.replay``
renders a saved JSONL trace back into a per-chip timeline.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.obs.energy import ChipEnergyModel, EnergyMeter
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import EventBus, Tracer, read_jsonl, strip_wall

__all__ = [
    "ChipEnergyModel", "Counter", "EnergyMeter", "EventBus", "Gauge",
    "Histogram", "MetricsRegistry", "Obs", "Tracer", "read_jsonl",
    "strip_wall",
]


class Obs:
    """One deployment's observability bundle (tracer + metrics + bus).

    ``trace``       record spans/events (default True — entries are cheap
                    host-side dict appends; pass False for a no-op tracer).
    ``wall_clock``  add ``wall_*`` timing fields to trace entries (off by
                    default: the step clock is the primary, and without
                    wall fields traces are bitwise-reproducible).
    ``chip``        tag for a per-chip child view (see :meth:`child`).

    A child shares the parent's tracer, registry, and bus — only the
    ``chip`` tag differs — so fleet-wide exports see one interleaved
    timeline and one registry, with per-chip label/tag attribution.
    """

    def __init__(self, *, trace: bool = True, wall_clock: bool = False,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 bus: Optional[EventBus] = None,
                 chip: Optional[str] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else \
            Tracer(enabled=trace, wall_clock=wall_clock)
        self.bus = bus if bus is not None else EventBus(tracer=self.tracer)
        self.chip = chip

    def child(self, chip: str) -> "Obs":
        """A per-chip view sharing this bundle's tracer/registry/bus."""
        return Obs(metrics=self.metrics, tracer=self.tracer, bus=self.bus,
                   chip=chip)

    # -- tagged shortcuts ----------------------------------------------

    def _labels(self, labels: Dict) -> Dict:
        if self.chip is not None and "chip" not in labels:
            labels = dict(labels, chip=self.chip)
        return labels

    def counter(self, name: str, **labels) -> Counter:
        return self.metrics.counter(name, **self._labels(labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self.metrics.gauge(name, **self._labels(labels))

    def histogram(self, name: str, **labels) -> Histogram:
        return self.metrics.histogram(name, **self._labels(labels))

    def set_step(self, step: int) -> None:
        self.tracer.set_step(step)

    def emit(self, type: str, *, step: int, src: str, **tags) -> dict:
        """Publish on the shared bus, auto-tagging the chip id."""
        if self.chip is not None and "chip" not in tags:
            tags = dict(tags, chip=self.chip)
        return self.bus.emit(type, step=step, src=src, **tags)

    def span(self, name: str, **attrs):
        if self.chip is not None and "chip" not in attrs:
            attrs = dict(attrs, chip=self.chip)
        return self.tracer.span(name, **attrs)

    def trace_event(self, type: str, **attrs) -> None:
        if not self.tracer.enabled:
            return
        if self.chip is not None and "chip" not in attrs:
            attrs = dict(attrs, chip=self.chip)
        self.tracer.event(type, **attrs)

    # -- checkpoint ----------------------------------------------------

    def snapshot(self) -> dict:
        """Metrics + tracer clock (NOT the recorded entries — exporters
        own those); rides in engine/fleet checkpoint metadata so resumed
        deployments keep their counters and their trace ordinals."""
        return {"metrics": self.metrics.snapshot(),
                "tracer": self.tracer.counters()}

    def restore(self, snap: Optional[dict]) -> None:
        if not snap:
            return
        self.metrics.restore(snap.get("metrics", {}))
        self.tracer.restore_counters(snap.get("tracer", {}))
