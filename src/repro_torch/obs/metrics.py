"""Metrics primitives: counters, gauges, mergeable log-scale histograms.

One registry per deployment (``repro_torch.obs.Obs`` owns it).  Everything here
is host-side, deterministic, and JSON-serializable:

* :class:`Counter` / :class:`Gauge` — the obvious scalars.
* :class:`Histogram` — a **log-scale bucket histogram** whose merge is
  plain bucket-count addition, hence associative and commutative (tested
  by hypothesis property in ``tests/test_obs.py``): two shards of a fleet
  can histogram independently and the fleet-level distribution is the
  merge, in any order or grouping.  Buckets are geometric with
  ``SUBBUCKETS`` subdivisions per octave (relative width ~2^(1/8) ≈ 9%),
  so p50/p95/p99 estimates carry bounded relative error.
* :class:`MetricsRegistry` — get-or-create by ``(name, labels)``, a
  deterministic :meth:`snapshot`/:meth:`restore` pair (metrics ride in
  engine/fleet checkpoints so a resumed deployment keeps its counters),
  and a Prometheus-text :meth:`to_prometheus` exporter.

Naming convention (see README "Observability"): dotted lowercase
``<layer>.<what>[_<unit>]`` — e.g. ``serve.ttft_steps``,
``lifecycle.inl_lsb``, ``energy.nladc_pj``.  Prometheus export rewrites
dots to underscores.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional, Tuple

SUBBUCKETS = 8           # buckets per octave (factor 2^(1/8) per bucket)


def _labels_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter (floats allowed: energy is a counter in pJ)."""

    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        self.value += n

    def to_dict(self) -> dict:
        return {"value": self.value}

    def restore(self, d: dict) -> None:
        self.value = float(d["value"])


class Gauge:
    """Last-write-wins scalar (INL, device age, queue depth)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_dict(self) -> dict:
        return {"value": self.value}

    def restore(self, d: dict) -> None:
        self.value = float(d["value"])


class Histogram:
    """Mergeable log-scale histogram.

    Bucket ``i`` covers ``[2^(i/SUBBUCKETS), 2^((i+1)/SUBBUCKETS))``; the
    index is any integer (values < 1 land in negative buckets), zeros and
    negatives land in a dedicated underflow bucket.  State is a sparse
    ``{bucket_index: count}`` dict plus exact ``count``/``sum``/``min``/
    ``max``, so merge = pointwise addition — associative, commutative,
    with the empty histogram as identity.
    """

    kind = "histogram"

    def __init__(self, name: str = "", labels: Optional[Dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self.buckets: Dict[int, int] = {}
        self.zero_count = 0              # values <= 0
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    @staticmethod
    def _index(v: float) -> int:
        return math.floor(math.log2(v) * SUBBUCKETS)

    @staticmethod
    def _bucket_value(i: int) -> float:
        # geometric midpoint of the bucket — the representative value
        # percentile() reports
        return 2.0 ** ((i + 0.5) / SUBBUCKETS)

    def record(self, v: float, n: int = 1) -> None:
        v = float(v)
        if n <= 0:
            return
        self.count += n
        self.sum += v * n
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v <= 0.0:
            self.zero_count += n
        else:
            i = self._index(v)
            self.buckets[i] = self.buckets.get(i, 0) + n

    def merge(self, other: "Histogram") -> "Histogram":
        """Pointwise-sum merge (pure: returns a new histogram)."""
        out = Histogram(self.name, self.labels)
        out.buckets = dict(self.buckets)
        for i, n in other.buckets.items():
            out.buckets[i] = out.buckets.get(i, 0) + n
        out.zero_count = self.zero_count + other.zero_count
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        mins = [m for m in (self.min, other.min) if m is not None]
        maxs = [m for m in (self.max, other.max) if m is not None]
        out.min = min(mins) if mins else None
        out.max = max(maxs) if maxs else None
        return out

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]); 0.0 when empty.

        Exact to within one bucket (~9% relative) — the return value is
        the covering bucket's geometric midpoint, clamped to the exact
        observed min/max so degenerate distributions stay exact.
        """
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = self.zero_count
        if rank <= seen:
            return min(0.0, self.min if self.min is not None else 0.0)
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if rank <= seen:
                v = self._bucket_value(i)
                return max(min(v, self.max), self.min)
        return self.max if self.max is not None else 0.0

    def summary(self) -> dict:
        """p50/p95/p99 + exact count/mean/min/max, JSON-ready."""
        mean = self.sum / self.count if self.count else 0.0
        return {"count": self.count,
                "mean": round(mean, 6),
                "min": 0.0 if self.min is None else round(self.min, 6),
                "max": 0.0 if self.max is None else round(self.max, 6),
                "p50": round(self.percentile(50), 6),
                "p95": round(self.percentile(95), 6),
                "p99": round(self.percentile(99), 6)}

    def to_dict(self) -> dict:
        return {"buckets": {str(i): n for i, n in sorted(self.buckets.items())},
                "zero_count": self.zero_count, "count": self.count,
                "sum": self.sum, "min": self.min, "max": self.max}

    def restore(self, d: dict) -> None:
        self.buckets = {int(i): int(n) for i, n in d["buckets"].items()}
        self.zero_count = int(d["zero_count"])
        self.count = int(d["count"])
        self.sum = float(d["sum"])
        self.min = None if d["min"] is None else float(d["min"])
        self.max = None if d["max"] is None else float(d["max"])

    def __eq__(self, other) -> bool:
        # bucket counts / count / min / max are exact; ``sum`` is a float
        # accumulator, so it is compared to rounding tolerance — merge
        # stays associative even though float addition is not.
        if not isinstance(other, Histogram):
            return NotImplemented
        return (self.buckets == other.buckets
                and self.zero_count == other.zero_count
                and self.count == other.count
                and math.isclose(self.sum, other.sum,
                                 rel_tol=1e-9, abs_tol=1e-9)
                and self.min == other.min and self.max == other.max)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create metric objects keyed by ``(name, sorted labels)``."""

    def __init__(self):
        self._metrics: Dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: Dict[str, str]):
        key = (name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, dict(labels))
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def find(self, name: str, **labels):
        """The metric if it exists (no create), else None."""
        return self._metrics.get((name, _labels_key(labels)))

    def merged_histogram(self, name: str) -> Histogram:
        """Merge every histogram registered under ``name`` across labels
        (e.g. the fleet-wide TTFT distribution over per-chip shards)."""
        out = Histogram(name)
        for (n, _), m in sorted(self._metrics.items()):
            if n == name and isinstance(m, Histogram):
                out = out.merge(m)
        return out

    # -- export / checkpoint -------------------------------------------

    def snapshot(self) -> dict:
        """Deterministic JSON state (rides in deployment checkpoints)."""
        return {"metrics": [
            {"name": name, "labels": dict(key), "kind": m.kind,
             "state": m.to_dict()}
            for (name, key), m in sorted(self._metrics.items())]}

    def restore(self, snap: dict) -> None:
        for entry in snap.get("metrics", []):
            cls = _KINDS[entry["kind"]]
            m = self._get(cls, entry["name"], dict(entry["labels"]))
            m.restore(entry["state"])

    def to_prometheus(self) -> str:
        """Prometheus text exposition (sorted, reproducible)."""
        lines = []
        seen_types = set()
        for (name, key), m in sorted(self._metrics.items()):
            pname = name.replace(".", "_").replace("-", "_")
            if pname not in seen_types:
                seen_types.add(pname)
                ptype = "summary" if m.kind == "histogram" else m.kind
                lines.append(f"# TYPE {pname} {ptype}")
            lbl = ",".join(f'{k}="{v}"' for k, v in key)
            suffix = "{" + lbl + "}" if lbl else ""
            if m.kind == "histogram":
                s = m.summary()
                for q in ("p50", "p95", "p99"):
                    qlbl = (lbl + "," if lbl else "") \
                        + f'quantile="{q[1:]}"'
                    lines.append(
                        f"{pname}{{{qlbl}}} {s[q]}")
                lines.append(f"{pname}_sum{suffix} {m.sum}")
                lines.append(f"{pname}_count{suffix} {m.count}")
            else:
                lines.append(f"{pname}{suffix} {m.value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def dump_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)
